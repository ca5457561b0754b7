"""Weights bridge between the flax transformer's parameter tree and the
port's ``state_dict``.

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
    params: dict = {
        "tok_embed": {"embedding": _n(state_dict["tok_embed.weight"])},
        "pos_embed": _n(state_dict["pos_embed"]),
        "ln_final": {"scale": _n(state_dict["ln_final.weight"]),
                     "bias": _n(state_dict["ln_final.bias"])},
        "lm_head": {"kernel": _n(state_dict["lm_head.weight"]).T.copy()},
    }
    blocks = sorted({k.split(".", 1)[0] for k in state_dict
                     if _BLOCK.match(k.split(".", 1)[0])})
    for name in blocks:
        blk: dict = {}
        for ln in _LAYERNORMS:
            blk[ln] = {"scale": _n(state_dict[f"{name}.{ln}.weight"]),
                       "bias": _n(state_dict[f"{name}.{ln}.bias"])}
        attn: dict = {}
        for proj in _QKV:
            w = _n(state_dict[f"{name}.attn.{proj}.weight"])   # (H*Dh, d)
            attn[proj] = {"kernel": w.T.reshape(w.shape[1], n_heads, -1)
                          .copy()}
        w = _n(state_dict[f"{name}.attn.out.weight"])          # (d, H*Dh)
        attn["out"] = {"kernel": w.T.reshape(n_heads, -1, w.shape[0]).copy()}
        blk["attn"] = attn
        for mlp in ("mlp_in", "mlp_out"):
            blk[mlp] = {"kernel": _n(state_dict[f"{name}.{mlp}.weight"])
                        .T.copy()}
        params[name] = blk
    return params
