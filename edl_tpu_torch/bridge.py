"""Weights bridge between the flax models' variable trees and the port's
``state_dict``s: the transformer LM, the ResNet and VGG families, the
MLP, the text classifiers and DeepFM.

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
- ``tok_embed/embedding`` and ``pos_embed`` copy as they are, and so do
  a MoE block's ``moe_mlp`` ``router`` (d, E), ``w_in`` (E, d, d_ff) and
  ``w_out`` (E, d_ff, d).

ResNet, VGG, MLP, the text classifiers and DeepFM
(``flax_variables_to_torch`` / ``torch_to_flax_variables``): the flax
``{"params", "batch_stats"}`` tree <-> a ``state_dict`` with the
BatchNorm buffers, module names as flax's:
- Conv ``kernel`` HWIO <-> ``weight`` OIHW, and a 1-D Conv's WIO <->
  ``nn.Conv1d``'s OIW;
- ``nn.Embed`` tables as they are: ``embed/embedding`` <->
  ``embed.weight``, DeepFM's ``sparse_embed`` and ``sparse_linear``;
- VGG's ``fc0`` as any Dense kernel: the port flattens the last map in
  flax's H·W·C order (``models/vgg.py``), so its rows need no permute;
- Dense ``kernel`` (in, out) <-> ``weight`` (out, in), ``bias`` as is;
- BatchNorm ``scale``/``bias`` <-> ``weight``/``bias``, and the
  ``batch_stats`` ``mean``/``var`` <-> ``running_mean``/``running_var``.

``flax_named_parameters`` lists a model's parameters in the flax
flatten order (sorted keys at every level: ``BottleneckBlock_10`` comes
before ``BottleneckBlock_2``), the leaf order of the JAX package's
bucket planner, which the fused optimizer's buckets (and so every
quantization scale) follow. ``grads_to_flax`` and ``buckets_to_flax``
carry gradients and flat optimizer buckets across for the tests.

Checkpoints: ``state_snapshot``/``state_to_flax`` give the JAX
TrainState's whole tree for a port TrainState (step, params, the fused
optimizer's count and per-bucket moments or QPlanes, or torch.optim's
SGD/AdamW state as optax's chains, BatchNorm statistics), and
``flax_to_state`` writes such a tree back into the live tensors.
"""

from __future__ import annotations

import collections
import re
from typing import Callable

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
# nn.Embed modules (the text classifiers' and DeepFM's tables)
_EMBEDS = ("embed", "sparse_embed", "sparse_linear")


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
    if leaf == "weight" and mod[-1] in _EMBEDS:        # nn.Embed
        return (*mod, "embedding")
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
    return to_flax_layout(name, _n(t), n_heads)


def to_flax_layout(name: str, w: np.ndarray,
                   n_heads: int | None = None) -> np.ndarray:
    """A numpy array in a state-dict tensor's layout -> its flax layout
    (a copy when the layouts differ)."""
    path = flax_path(name)
    if path[-1] != "kernel":
        return w
    if path[-2] in _QKV:                               # (H*Dh, d)
        return w.T.reshape(w.shape[1], n_heads, -1).copy()
    if path[-2] == "out":                              # (d, H*Dh)
        return w.T.reshape(n_heads, -1, w.shape[0]).copy()
    if w.ndim == 4:                                    # OIHW -> HWIO
        return w.transpose(2, 3, 1, 0).copy()
    if w.ndim == 3:                                    # OIW -> WIO
        return w.transpose(2, 1, 0).copy()
    return w.T.copy()                                  # (out, in) -> (in, out)


def from_flax_layout(name: str, w: np.ndarray,
                     shape: tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`to_flax_layout` for a tensor of torch ``shape``."""
    w = np.asarray(w)
    if flax_path(name)[-1] != "kernel":
        return w.reshape(shape)
    if len(shape) == 4:                                # HWIO -> OIHW
        return w.transpose(3, 2, 0, 1).reshape(shape)
    if len(shape) == 3:                                # WIO -> OIW
        return w.transpose(2, 1, 0).reshape(shape)
    if flax_path(name)[-2] == "out":                   # (H, Dh, d)
        return w.reshape(-1, shape[0]).T.reshape(shape)
    return w.reshape(shape[1], -1).T.reshape(shape)    # (in, ...) -> (out, in)


def torch_dim(name: str, flax_dim: int, ndim: int = 2) -> int:
    """The dim of a state-dict tensor's layout that holds ``flax_dim`` of
    its flax layout (``ndim``: the flax leaf's rank; for the attention
    projections the merged heads x head_dim dim holds both of theirs)."""
    path = flax_path(name)
    if path[-1] != "kernel":
        return flax_dim
    if path[-2] in _QKV:                               # (d, H, Dh)
        return 1 if flax_dim == 0 else 0
    if path[-2] == "out":                              # (H, Dh, d)
        return 0 if flax_dim == 2 else 1
    if ndim == 4:                                      # HWIO -> OIHW
        return (2, 3, 1, 0)[flax_dim]
    if ndim == 3:                                      # WIO -> OIW
        return (2, 1, 0)[flax_dim]
    return 1 - flax_dim                                # (in, out)


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
    return [bucket_layout(_n(buf), b, names, n_heads)
            for buf, b in zip(buffers, plan.buckets)]


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
        if "moe_mlp" in blk:              # the MoE tables, as they are
            for leaf in ("router", "w_in", "w_out"):
                sd[f"{name}.moe_mlp.{leaf}"] = _t(blk["moe_mlp"][leaf])
            continue
        for mlp in ("mlp_in", "mlp_out"):
            sd[f"{name}.{mlp}.weight"] = _t(np.asarray(blk[mlp]["kernel"]).T)
    sd["ln_final.weight"] = _t(params["ln_final"]["scale"])
    sd["ln_final.bias"] = _t(params["ln_final"]["bias"])
    sd["lm_head.weight"] = _t(np.asarray(params["lm_head"]["kernel"]).T)
    return sd


def flax_to_torch_sharded(params: dict, mesh, coords: dict | None = None
                          ) -> dict[str, torch.Tensor]:
    """The shards rank ``coords`` (default: this process's) of ``mesh``
    holds of flax transformer ``params`` (numpy), as a state dict of its
    torch-layout slices: what ``parallel/sharding.shard_module`` leaves
    in the module, over fsdp, tp or both (a tp rank's heads, MLP
    columns, vocab rows and token-table columns). The layout moves are
    shape-generic, so a flax shard converts like a whole leaf
    (``flax_to_torch`` of the shard tree); a JAX sharded state's
    addressable shards, put into a tree, convert the same way."""
    from edl_tpu_torch.parallel import sharding

    return flax_to_torch(sharding.shard_tree(params, mesh, coords,
                                             sharding.PARAM_RULES))


def torch_to_flax_sharded(state_dicts, mesh, n_heads: int) -> dict:
    """Inverse of :func:`flax_to_torch_sharded`: the ranks' shard state
    dicts (in rank order) -> the whole flax param tree."""
    from edl_tpu_torch.parallel import sharding

    heads = n_heads // mesh.axis_size("tp")      # a tp rank's heads
    return sharding.gather_tree(
        [torch_to_flax(sd, heads) for sd in state_dicts], mesh,
        sharding.PARAM_RULES)


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
                  "embedding": "weight", "mean": "running_mean",
                  "var": "running_var"}
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flat(variables.get(collection, {})):
            *mod, leaf = path
            if leaf == "kernel":
                # HWIO -> OIHW; WIO -> OIW and (in, out) -> (out, in)
                # reverse every axis
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


# -- the whole TrainState (checkpoints) --------------------------------------
#
# The JAX package checkpoints its TrainState pytree: flax writes it as
# {"step", "params", "opt_state", "batch_stats"}, with every dict's keys
# sorted (a jitted step's outputs, and jax.device_get, rebuild dicts in
# key order), NamedTuples as maps of their fields and tuples as maps
# {"0": ..., "1": ...}. The node types below reproduce that tree from the
# port's state, so serialization.to_bytes writes flax's bytes for it and
# sharded_checkpoint names its leaves as jax.tree_util.keystr does.

TrainStateTree = collections.namedtuple(
    "TrainState", ("step", "params", "opt_state", "batch_stats"))
FusedOptTree = collections.namedtuple("FusedOptState", ("count", "m", "v"))
QPlaneTree = collections.namedtuple("QPlane", ("q", "scale", "rq", "rscale"))
EmptyState = collections.namedtuple("EmptyState", ())
TraceState = collections.namedtuple("TraceState", ("trace",))
ScheduleState = collections.namedtuple("ScaleByScheduleState", ("count",))
AdamState = collections.namedtuple("ScaleByAdamState", ("count", "mu", "nu"))

_BN_STATS = ("running_mean", "running_var")
_QFIELDS = ("q", "scale", "rq", "rscale")


def _n_heads(model: torch.nn.Module) -> int | None:
    return getattr(getattr(model, "cfg", None), "n_heads", None)


def _bn_buffers(model: torch.nn.Module) -> list[tuple[str, torch.Tensor]]:
    return [(n, b) for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1] in _BN_STATS]


def _insert(tree: dict, path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _lookup(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _key_sorted(tree):
    """Every dict's keys in sorted order (jax's flatten order)."""
    if isinstance(tree, dict):
        return {k: _key_sorted(tree[k]) for k in sorted(tree)}
    return tree


def _param_tree(names, arrays, n_heads) -> dict:
    tree: dict = {}
    for name, a in zip(names, arrays):
        _insert(tree, flax_path(name), to_flax_layout(name, a, n_heads))
    return _key_sorted(tree)


def bucket_layout(flat: np.ndarray, bucket, names: list[str],
                  n_heads: int | None = None, *,
                  to_flax: bool = True) -> np.ndarray:
    """One flat bucket of a plan (fp32 moment or int8 plane) with every
    slot moved between its leaf's torch and flax layouts (a copy, the
    padding kept); ``names`` are the plan's leaves'."""
    out = np.array(flat, copy=True)
    for s in bucket.slots:
        piece = flat[s.offset:s.offset + s.size]
        name, shape = names[s.leaf], tuple(s.shape)
        if to_flax:
            piece = to_flax_layout(name, piece.reshape(shape), n_heads)
        else:
            fshape = to_flax_layout(name, np.empty(shape, np.int8),
                                    n_heads).shape
            piece = from_flax_layout(name, piece.reshape(fshape), shape)
        out[s.offset:s.offset + s.size] = piece.reshape(-1)
    return out


def _is_fused(tx) -> bool:
    return hasattr(tx, "fused_apply")


def state_snapshot(state) -> tuple[list[torch.Tensor], Callable]:
    """The live tensors a checkpoint of ``state`` reads, and
    ``build(host_arrays)``, which turns host copies of them (numpy, in
    the same order) into the JAX TrainState's tree (TrainStateTree).

    Under the fused optimizer the tensors are its parameter buckets (the
    parameters live in them), its moment buffers or QPlanes' tensors, and
    the BatchNorm statistics; unfused, the parameters, the torch.optim
    moments and the statistics. The step count is read now (host ints),
    so the copies can be taken on the device's stream and converted
    later, on another thread."""
    model, tx, st = state.model, state.tx, state.opt_state
    n_heads = _n_heads(model)
    names = [n for n, _ in state.params]
    buffers = _bn_buffers(model)
    step = int(state.step)
    if _is_fused(tx):
        plan = tx.plan(state.params)

        def moments(seq):
            out = []
            for m in seq:
                out.extend(m if isinstance(m, tuple) else (m,))
            return out

        quant = bool(st.m) and isinstance(st.m[0], tuple)
        live = [*st.p, *moments(st.m), *moments(st.v)]
        count = int(st.count)
    else:
        live = [p for _, p in state.params]
        kind = _torch_kind(tx)
        opt = st
        slots = _SLOTS[kind]
        for _, p in state.params:
            for slot in slots:
                live.append(opt.state.get(p, {}).get(slot,
                                                     torch.zeros_like(p)))
    live += [b for _, b in buffers]

    def build(host: list[np.ndarray]) -> TrainStateTree:
        it = iter(host)
        if _is_fused(tx):
            p_host = [next(it) for _ in st.p]
            leaves = [None] * len(names)
            for buf, b in zip(p_host, plan.buckets):
                for s in b.slots:
                    leaves[s.leaf] = buf[s.offset:s.offset + s.size].reshape(
                        s.shape)

            def flax(flat, b):
                return bucket_layout(flat, b, names, n_heads)

            def take(seq):
                out = []
                for b in plan.buckets[:len(seq)]:
                    if quant:
                        q, scale, rq, rscale = (next(it) for _ in _QFIELDS)
                        out.append(QPlaneTree(flax(q, b), scale, flax(rq, b),
                                              rscale))
                    else:
                        out.append(flax(next(it), b))
                return tuple(out)

            m = take(st.m)
            v = take(st.v)
            opt_tree = FusedOptTree(np.asarray(count, np.int32), m, v)
        else:
            leaves = [next(it) for _ in names]
            per = [[next(it) for _ in slots] for _ in names]
            trees = [_param_tree(names, [x[i] for x in per], n_heads)
                     for i in range(len(slots))]
            c = np.asarray(step, np.int32)
            if kind == "sgd_plain":
                opt_tree = (EmptyState(), EmptyState())
            elif kind == "sgd":
                opt_tree = (EmptyState(), (TraceState(trees[0]),
                                           ScheduleState(c)))
            else:
                opt_tree = (AdamState(c, trees[0], trees[1]), EmptyState(),
                            ScheduleState(c))
        stats: dict = {}
        for name, _ in buffers:
            _insert(stats, flax_path(name), next(it))
        return TrainStateTree(
            step=np.asarray(step, np.int32),
            params=_param_tree(names, leaves, n_heads),
            opt_state=opt_tree,
            batch_stats=_key_sorted(stats) if buffers else None)

    return live, build


# torch.optim's state slots a checkpoint carries, by optimizer kind
_SLOTS = {"sgd_plain": (), "sgd": ("momentum_buffer",),
          "adamw": ("exp_avg", "exp_avg_sq")}


def _torch_kind(tx) -> str:
    """``sgd_plain``: SGD without momentum or weight decay, optax.sgd(lr)
    (two empty states); ``sgd``: optax.chain(add_decayed_weights(wd),
    sgd(lr, momentum)); ``adamw``."""
    cls = getattr(tx, "cls", None)
    if cls is torch.optim.SGD:
        plain = not (tx.kwargs.get("momentum") or
                     tx.kwargs.get("weight_decay"))
        return "sgd_plain" if plain else "sgd"
    if cls is torch.optim.AdamW:
        return "adamw"
    raise ValueError(f"no checkpoint tree for the optimizer {tx!r}")


def state_to_flax(state) -> TrainStateTree:
    """The JAX TrainState's tree of ``state`` (numpy leaves, a copy)."""
    live, build = state_snapshot(state)
    return build([t.detach().cpu().numpy().copy() for t in live])


def _put(dst: torch.Tensor, src, what: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: checkpoint shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    t = torch.from_numpy(np.array(src, copy=True))
    if t.dtype != dst.dtype:
        raise ValueError(f"{what}: checkpoint dtype {t.dtype} != "
                         f"{dst.dtype}")
    dst.copy_(t)


@torch.no_grad()
def flax_to_state(tree: dict, state):
    """Write a JAX TrainState's state dict (``serialization.to_state_dict``
    of it, or what ``msgpack_restore`` gives) into ``state`` in place:
    parameters into their tensors (under the fused optimizer, into the
    buckets they live in, so the kernels keep updating what the module
    reads), BatchNorm statistics, moments (fp32 buffers or each QPlane's
    tensors; torch.optim's momentum or Adam state), counts and the step.
    Raises ValueError on a structure, shape or dtype that does not
    match."""
    try:
        return _write_state(tree, state)
    except KeyError as exc:
        raise ValueError(f"checkpoint tree does not match the state: no "
                         f"key {exc}") from exc


def _write_state(tree: dict, state):
    model, tx, st = state.model, state.tx, state.opt_state
    n_heads = _n_heads(model)
    names = [n for n, _ in state.params]
    params = tree["params"]
    for name, p in state.params:
        _put(p, from_flax_layout(name, _lookup(params, flax_path(name)),
                                 tuple(p.shape)), name)
    for name, b in _bn_buffers(model):
        _put(b, _lookup(tree["batch_stats"], flax_path(name)), name)
    # plain SGD keeps no moments: its opt_state has no leaves, and a tree
    # rebuilt from chunks (a peer restore) carries no key without leaves
    plain = not _is_fused(tx) and _torch_kind(tx) == "sgd_plain"
    opt = tree.get("opt_state", {}) if plain else tree["opt_state"]
    if _is_fused(tx):
        if "count" not in opt or "m" not in opt:
            raise ValueError("checkpoint holds no fused optimizer state")
        buckets = tx.plan(state.params).buckets
        for key, seq in (("m", st.m), ("v", st.v)):
            # an empty tuple has no leaves in the sharded format
            saved_seq = opt.get(key, {})
            if len(saved_seq) != len(seq):
                raise ValueError(f"checkpoint has {len(saved_seq)} {key} "
                                 f"buckets, the optimizer {len(seq)}")
            for i, (moment, b) in enumerate(zip(seq, buckets)):
                saved = saved_seq[str(i)]
                if isinstance(moment, tuple) != isinstance(saved, dict):
                    raise ValueError(f"{key}[{i}]: the checkpoint's moment "
                                     "format is not the optimizer's "
                                     "(fp32 buffer against QPlane)")
                for f, dst in (zip(_QFIELDS, moment)
                               if isinstance(moment, tuple)
                               else ((None, moment),)):
                    src = np.asarray(saved if f is None else saved[f])
                    if src.ndim:
                        if src.shape != (b.padded,):
                            raise ValueError(
                                f"opt_state.{key}[{i}]: checkpoint bucket "
                                f"{src.shape} != ({b.padded},)")
                        src = bucket_layout(src, b, names, n_heads,
                                            to_flax=False)
                    _put(dst, src, f"opt_state.{key}[{i}]")
        state.opt_state = st._replace(count=int(opt["count"]))
    else:
        kind = _torch_kind(tx)
        if kind == "sgd_plain":
            slots = ()
        elif kind == "sgd":
            slots = (("momentum_buffer", opt["1"]["0"]["trace"]),)
            count = int(opt["1"]["1"]["count"])
        else:
            slots = (("exp_avg", opt["0"]["mu"]), ("exp_avg_sq",
                                                   opt["0"]["nu"]))
            count = int(opt["0"]["count"])
        for name, p in state.params:
            entry = st.state[p]
            for slot, saved in slots:
                buf = torch.empty_like(p)
                _put(buf, from_flax_layout(
                    name, _lookup(saved, flax_path(name)), tuple(p.shape)),
                    f"{slot}.{name}")
                entry[slot] = buf
            if kind == "adamw":
                entry["step"] = torch.tensor(float(count),
                                             dtype=torch.float32)
    state.step = int(np.asarray(tree["step"]))
    return state


# -- sharded states (parallel/sharding.shard_module: fsdp, tp) --------------
#
# A rank of a sharded world holds a slice of each leaf the rules shard:
# over fsdp, tp or both (a tp slice, then the fsdp slice of it, on other
# dims). Its checkpoint tree is the JAX TrainState's, with such leaves as
# ``Shard``s: this rank's slice in the flax layout, where it lies in the
# whole leaf, the whole leaf's shape (what the JAX package's
# snapshot_shards writes for an addressable shard), and whether this rank
# writes it (the JAX package's replica_id == 0: a slice replicated over
# dp, or a tp slice over fsdp, is written once). The fused optimizer's
# moments live in buckets over the slices, while the JAX tree holds
# buckets over whole leaves: each sharded leaf's moment is gathered and
# the whole-leaf buckets written once, by rank 0. Quantized moments (one
# scale a bucket) go through fp32: the slices' planes dequantized,
# gathered, and quantized once a whole-leaf bucket with the codec the
# JAX package's would use on those values; a restore dequantizes the
# whole-leaf buckets and requantizes each rank's slices at their own
# buckets' scales (each moment within one quantization step).


class Shard(collections.namedtuple("Shard", ("array", "offset", "shape",
                                             "owner"),
                                   defaults=(True,))):
    """One rank's slice of a leaf: ``array`` (flax layout) at ``offset``
    inside a whole leaf of ``shape``; ``owner``: this rank writes it to a
    sharded checkpoint."""


def _cuts(p):
    from edl_tpu_torch.parallel.sharding import cuts
    return cuts(p)


def _local_heads(p, n_heads):
    """The heads of ``p``'s slice: a tp slice of an attention projection
    holds n_heads / tp of them."""
    from edl_tpu_torch.parallel.sharding import tp_spec
    spec = tp_spec(p)
    return n_heads if spec is None or n_heads is None else (
        n_heads // spec.world)


def _shard_leaf(name: str, t: torch.Tensor, p, n_heads) -> Shard:
    from edl_tpu_torch.parallel.sharding import owns_chunk

    a = to_flax_layout(name, _n(t), _local_heads(p, n_heads))
    offset = [0] * a.ndim
    shape = list(a.shape)
    for spec in _cuts(p):
        offset[spec.flax_dim] = spec.index * a.shape[spec.flax_dim]
        shape[spec.flax_dim] *= spec.world
    return Shard(np.array(a, copy=True), tuple(offset), tuple(shape),
                 owns_chunk(p))


def _full_plan(tx, state):
    """The fused optimizer's bucket plan over the WHOLE leaves of a
    sharded state (the JAX package's plan), from their shapes alone."""
    from edl_tpu_torch.parallel.sharding import whole_shape

    metas = [torch.empty(whole_shape(p), dtype=p.dtype, device="meta")
             for _, p in state.params]
    return tx.plan(list(zip([n for n, _ in state.params], metas)))


def sharded_state_tree(state) -> TrainStateTree:
    """The JAX TrainState's tree of a sharded ``state`` for this rank:
    the sharded parameters (and torch.optim moments) as :class:`Shard`s,
    every other leaf whole. Collective over the world under the fused
    optimizer (each sharded leaf's moments are gathered, over fsdp and
    then tp)."""
    from edl_tpu_torch.ops import opt_kernels as ok
    from edl_tpu_torch.parallel.sharding import gather_whole
    from edl_tpu_torch.train import comm as comm_lib

    model, tx, st = state.model, state.tx, state.opt_state
    n_heads = _n_heads(model)
    names = [n for n, _ in state.params]

    def leaf(name, t, p):
        return (_shard_leaf(name, t, p, n_heads) if _cuts(p)
                else to_flax_layout(name, _n(t), n_heads))

    params: dict = {}
    for name, p in state.params:
        _insert(params, flax_path(name), leaf(name, p, p))
    if _is_fused(tx):
        shard_plan = tx.plan(state.params)
        full = _full_plan(tx, state)

        def whole(seq):
            """fp32 moment buckets over the slices -> over whole leaves."""
            leaves = comm_lib.unpack_buckets(list(seq), shard_plan)
            leaves = [gather_whole(t, p)
                      for t, (_, p) in zip(leaves, state.params)]
            return comm_lib.pack_buckets(leaves, full)

        def flax_q(seq, codec):
            """QPlanes over the slices -> fp32 (the plain codec) -> whole
            leaves -> one QPlane a whole-leaf bucket: the layout, scales
            and bytes a dp run holding those moments writes."""
            out = []
            for b, pb in zip(whole([ok.dequant_plane(pl, codec)
                                    for pl in seq]), full.buckets):
                q, scale, rq, rscale = ok.quant_plane(b, codec)
                out.append(QPlaneTree(
                    bucket_layout(_n(q), pb, names, n_heads), _n(scale),
                    bucket_layout(_n(rq), pb, names, n_heads), _n(rscale)))
            return tuple(out)

        if bool(st.m) and isinstance(st.m[0], tuple):
            m, v = flax_q(st.m, tx.quant), flax_q(st.v, ok.V_QUANT)
        else:
            m, v = (tuple(bucket_layout(_n(b), pb, names, n_heads)
                          for b, pb in zip(whole(seq), full.buckets))
                    for seq in (st.m, st.v))
        opt_tree = FusedOptTree(np.asarray(int(st.count), np.int32), m, v)
    else:
        kind = _torch_kind(tx)
        slots = _SLOTS[kind]
        trees = []
        for slot in slots:
            tree: dict = {}
            for name, p in state.params:
                t = st.state.get(p, {}).get(slot, torch.zeros_like(p))
                _insert(tree, flax_path(name), leaf(name, t, p))
            trees.append(_key_sorted(tree))
        c = np.asarray(int(state.step), np.int32)
        if kind == "sgd_plain":
            opt_tree = (EmptyState(), EmptyState())
        elif kind == "sgd":
            opt_tree = (EmptyState(), (TraceState(trees[0]),
                                       ScheduleState(c)))
        else:
            opt_tree = (AdamState(c, trees[0], trees[1]), EmptyState(),
                        ScheduleState(c))
    stats: dict = {}
    for name, b in _bn_buffers(model):
        _insert(stats, flax_path(name), _n(b).copy())
    return TrainStateTree(step=np.asarray(int(state.step), np.int32),
                          params=_key_sorted(params), opt_state=opt_tree,
                          batch_stats=_key_sorted(stats) if stats else None)


def gather_shards(tree):
    """A :func:`sharded_state_tree` with every :class:`Shard` gathered
    whole (collective over the world, in the tree's leaf order): every
    rank's slice placed at its offset."""
    from edl_tpu_torch.parallel import distributed

    def walk(x):
        if isinstance(x, Shard):
            parts = distributed.all_gather(torch.from_numpy(
                np.ascontiguousarray(x.array)))
            offsets = distributed.all_gather(torch.tensor(x.offset,
                                                          dtype=torch.int64))
            out = np.empty(x.shape, x.array.dtype)
            for part, offset in zip(parts, offsets.tolist()):
                out[tuple(slice(o, o + n) for o, n in
                          zip(offset, x.array.shape))] = part.numpy()
            return out
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        return x

    return walk(tree)


@torch.no_grad()
def flax_to_state_sharded(read, state):
    """Write a checkpoint into a sharded ``state`` reading only what this
    rank holds: ``read(path, index)`` returns the region ``index`` (a
    tuple of slices, or None for the whole leaf) of the leaf at ``path``
    (the state dict's path of str keys, e.g. ("params", "lm_head",
    "kernel") or ("opt_state", "m", "0")). A fused moment bucket is read
    slot by slot, each sharded leaf's slot then cut to this rank's slice
    (on each dim it is split on: fsdp, tp).
    Quantized moments are dequantized whole, cut to this rank's slices
    and requantized at the slices' buckets' own scales: each moment ends
    within one quantization step of the saved one. Raises ValueError on a
    shape or dtype that does not match."""
    from edl_tpu_torch.ops import opt_kernels as ok
    from edl_tpu_torch.train import comm as comm_lib

    model, tx, st = state.model, state.tx, state.opt_state
    n_heads = _n_heads(model)
    names = [n for n, _ in state.params]
    params = [p for _, p in state.params]

    def region(prefix, name, p):
        path = prefix + flax_path(name)
        fshape = to_flax_layout(name, np.empty(tuple(p.shape), np.int8),
                                _local_heads(p, n_heads)).shape
        if not _cuts(p):
            src = read(path, None)
        else:
            index = [slice(0, n) for n in fshape]
            for spec in _cuts(p):
                lo = spec.index * fshape[spec.flax_dim]
                index[spec.flax_dim] = slice(lo, lo + fshape[spec.flax_dim])
            src = read(path, tuple(index))
        return from_flax_layout(name, src, tuple(p.shape))

    for name, p in state.params:
        _put(p, region(("params",), name, p), name)
    for name, b in _bn_buffers(model):
        _put(b, read(("batch_stats",) + flax_path(name), None), name)
    if _is_fused(tx):
        full = _full_plan(tx, state)
        shard_plan = tx.plan(state.params)
        quant = bool(st.m) and isinstance(st.m[0], tuple)
        codecs = {"m": tx.quant, "v": ok.V_QUANT}
        for key, seq in (("m", st.m), ("v", st.v)):
            # quantized moments: the whole-leaf buckets dequantized (the
            # plain codec), each slice cut from them into fp32 buckets
            # over the slices, then requantized at those buckets' scales
            bufs = ([torch.empty(b.padded, dtype=torch.float32)
                     for b in shard_plan.buckets][:len(seq)] if quant
                    else list(seq))
            if quant:
                for buf in bufs:
                    buf.zero_()
            views = comm_lib.unpack_buckets(bufs, shard_plan)
            for i, b in enumerate(full.buckets if seq else ()):
                whole_q = None
                if quant:
                    path = ("opt_state", key, str(i))
                    whole_q = ok.dequant_plane(ok.QPlane(*(
                        torch.as_tensor(np.asarray(read(path + (f,), None)))
                        for f in _QFIELDS)), codecs[key]).numpy()
                for s in b.slots:
                    name = names[s.leaf]
                    flat = (whole_q[s.offset:s.offset + s.size] if quant
                            else read(("opt_state", key, str(i)),
                                      (slice(s.offset, s.offset + s.size),)))
                    fshape = to_flax_layout(
                        name, np.empty(s.shape, np.int8), n_heads).shape
                    piece = np.asarray(flat).reshape(fshape)
                    index = [slice(None)] * len(fshape)
                    for spec in _cuts(params[s.leaf]):
                        n = fshape[spec.flax_dim] // spec.world
                        index[spec.flax_dim] = slice(spec.index * n,
                                                     (spec.index + 1) * n)
                    piece = piece[tuple(index)]
                    dst = views[s.leaf]
                    _put(dst, from_flax_layout(name, piece,
                                               tuple(dst.shape)),
                         f"opt_state.{key}[{i}].{name}")
            if quant:
                for plane, buf in zip(seq, bufs):
                    ok._store(plane, ok._rq2(buf.to(plane.q.device),
                                             codecs[key]))
        state.opt_state = st._replace(
            count=int(np.asarray(read(("opt_state", "count"), None))))
    else:
        kind = _torch_kind(tx)
        count = None
        if kind == "sgd_plain":
            slots = ()
        elif kind == "sgd":
            slots = (("momentum_buffer", ("opt_state", "1", "0", "trace")),)
        else:
            slots = (("exp_avg", ("opt_state", "0", "mu")),
                     ("exp_avg_sq", ("opt_state", "0", "nu")))
            count = int(np.asarray(read(("opt_state", "0", "count"), None)))
        for name, p in state.params:
            entry = st.state[p]
            for slot, prefix in slots:
                buf = torch.empty_like(p)
                _put(buf, region(prefix, name, p), f"{slot}.{name}")
                entry[slot] = buf
            if kind == "adamw":
                entry["step"] = torch.tensor(float(count),
                                             dtype=torch.float32)
    state.step = int(np.asarray(read(("step",), None)))
    return state
