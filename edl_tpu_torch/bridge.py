"""Weights bridge between the flax models' variable trees and the port's
``state_dict``s: the transformer LM and the ResNet family.

``flax_to_torch`` takes the flax ``params`` as nested dicts of numpy
arrays (partitioned boxes already unboxed) and returns a ``state_dict``
of CPU fp32 tensors for ``edl_tpu_torch.models.transformer.Transformer``;
``torch_to_flax`` is its inverse. Both only transpose and reshape, so a
round trip is bitwise.

Layout mapping (flax kernel -> torch weight):
- ``query``/``key``/``value`` (d, H, Dh) -> Linear (H*Dh, d)
- ``out`` (H, Dh, d) -> Linear (d, H*Dh)
- ``mlp_in``/``mlp_out``/``lm_head`` (in, out) -> Linear (out, in)
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``
- ``tok_embed/embedding`` and ``pos_embed`` copy as they are.

ResNet (``flax_variables_to_torch`` / ``torch_to_flax_variables``): the
flax ``{"params", "batch_stats"}`` tree <-> a ``state_dict`` with the
BatchNorm buffers, module names as flax's:
- Conv ``kernel`` HWIO <-> ``weight`` OIHW;
- Dense ``kernel`` (in, out) <-> ``weight`` (out, in), ``bias`` as is;
- BatchNorm ``scale``/``bias`` <-> ``weight``/``bias``, and the
  ``batch_stats`` ``mean``/``var`` <-> ``running_mean``/``running_var``.

``flax_named_parameters`` lists a model's parameters in the flax
flatten order (sorted keys at every level: ``BottleneckBlock_10`` comes
before ``BottleneckBlock_2``), the leaf order of the JAX package's
bucket planner, which the fused optimizer's buckets (and so every
quantization scale) follow. ``grads_to_flax`` and ``buckets_to_flax``
carry gradients and flat optimizer buckets across for the tests.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK = re.compile(r"block\d+\Z")
_LAYERNORMS = ("ln_attn", "ln_mlp")
_QKV = ("query", "key", "value")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))   # a copy, writable


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


_STATS = {"running_mean": "mean", "running_var": "var"}


def _is_norm(module: str) -> bool:
    """A normalization layer's name: the transformer's ``ln_*``, the
    ResNet's ``stem_norm*``, ``BatchNorm_*`` and ``norm_shortcut``."""
    return module.startswith("ln_") or "norm" in module.lower()


def flax_path(name: str) -> tuple[str, ...]:
    """The flax variable path of a state-dict name
    (``block0.attn.query.weight`` -> ("block0", "attn", "query",
    "kernel"); ``BottleneckBlock_0.BatchNorm_1.running_var`` ->
    ("BottleneckBlock_0", "BatchNorm_1", "var"), a ``batch_stats``
    leaf)."""
    parts = name.split(".")
    if parts == ["pos_embed"]:
        return ("pos_embed",)
    if parts == ["tok_embed", "weight"]:
        return ("tok_embed", "embedding")
    *mod, leaf = parts
    if leaf in _STATS:
        return (*mod, _STATS[leaf])
    if leaf == "weight":
        return (*mod, "scale" if _is_norm(mod[-1]) else "kernel")
    return (*mod, leaf)


def flax_named_parameters(model: torch.nn.Module
                          ) -> list[tuple[str, torch.nn.Parameter]]:
    """(name, parameter) pairs in the flax flatten order."""
    return sorted(model.named_parameters(), key=lambda kv: flax_path(kv[0]))


def flax_leaf(name: str, t: torch.Tensor,
              n_heads: int | None = None) -> np.ndarray:
    """One state-dict tensor in its flax layout (numpy). ``n_heads``
    splits the transformer's attention projections."""
    w = _n(t)
    path = flax_path(name)
    if path[-1] != "kernel":
        return w
    if path[-2] in _QKV:                               # (H*Dh, d)
        return w.T.reshape(w.shape[1], n_heads, -1).copy()
    if path[-2] == "out":                              # (d, H*Dh)
        return w.T.reshape(n_heads, -1, w.shape[0]).copy()
    if w.ndim == 4:                                    # OIHW -> HWIO
        return w.transpose(2, 3, 1, 0).copy()
    return w.T.copy()                                  # (out, in) -> (in, out)


def grads_to_flax(model: torch.nn.Module, n_heads: int) -> dict:
    """The model's ``.grad``s as a flax-shaped tree (None grads as
    zeros)."""
    return torch_to_flax(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()}, n_heads)


def buckets_to_flax(buffers, plan, names: list[str],
                    n_heads: int | None = None) -> list[np.ndarray]:
    """Flat bucket buffers of the port (each leaf in its torch layout)
    -> the JAX package's buffers for the same plan (each leaf in its
    flax layout), padding kept. ``names`` are the plan's leaves' names in
    its order."""
    out = []
    for buf, b in zip(buffers, plan.buckets):
        flat = _n(buf).copy()
        for s in b.slots:
            piece = torch.from_numpy(flat[s.offset:s.offset + s.size]
                                     .reshape(s.shape).copy())
            flat[s.offset:s.offset + s.size] = flax_leaf(
                names[s.leaf], piece, n_heads).reshape(-1)
        out.append(flat)
    return out


def flax_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """flax transformer params (nested dict of numpy) -> state_dict."""
    sd = {"tok_embed.weight": _t(params["tok_embed"]["embedding"]),
          "pos_embed": _t(params["pos_embed"])}
    for name, blk in params.items():
        if not _BLOCK.match(name):
            continue
        for ln in _LAYERNORMS:
            sd[f"{name}.{ln}.weight"] = _t(blk[ln]["scale"])
            sd[f"{name}.{ln}.bias"] = _t(blk[ln]["bias"])
        attn = blk["attn"]
        for proj in _QKV:
            kern = np.asarray(attn[proj]["kernel"])
            sd[f"{name}.attn.{proj}.weight"] = _t(
                kern.reshape(kern.shape[0], -1).T)
        out = np.asarray(attn["out"]["kernel"])
        sd[f"{name}.attn.out.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        for mlp in ("mlp_in", "mlp_out"):
            sd[f"{name}.{mlp}.weight"] = _t(np.asarray(blk[mlp]["kernel"]).T)
    sd["ln_final.weight"] = _t(params["ln_final"]["scale"])
    sd["ln_final.bias"] = _t(params["ln_final"]["bias"])
    sd["lm_head.weight"] = _t(np.asarray(params["lm_head"]["kernel"]).T)
    return sd


def torch_to_flax(state_dict: dict[str, torch.Tensor], n_heads: int
                  ) -> dict:
    """Inverse of `flax_to_torch`; ``n_heads`` splits the attention
    projections back into (heads, head_dim)."""
    params: dict = {}
    for name, t in state_dict.items():
        *path, leaf = flax_path(name)
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = flax_leaf(name, t, n_heads)
    return params


def _flat(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_flat(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), np.asarray(v)))
    return out


def flax_variables_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """flax ResNet ``{"params", "batch_stats"}`` (nested dicts of numpy)
    -> state_dict with the BatchNorm buffers."""
    torch_leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flat(variables.get(collection, {})):
            *mod, leaf = path
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            sd[".".join((*mod, torch_leaf[leaf]))] = _t(arr)
    return sd


def torch_to_flax_variables(state_dict: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flax_variables_to_torch`: ``{"params": ...,
    "batch_stats": ...}`` as nested dicts of numpy."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        *path, leaf = flax_path(name)
        collection = ("batch_stats" if name.rsplit(".", 1)[-1] in _STATS
                      else "params")
        node = out[collection]
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = flax_leaf(name, t)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
