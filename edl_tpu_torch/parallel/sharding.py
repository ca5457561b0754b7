"""Parameter sharding by logical axis names, and the FSDP parameter
plane (port of ``edl_tpu.parallel.sharding``: ``DEFAULT_RULES``,
``logical_to_spec``, ``param_shardings``, ``constrain``; with
``init_sharded``'s counterpart :func:`shard_module`).

Parameters carry LOGICAL axis names, a rule table maps them to mesh
axes, first match wins (flax's ``logical_to_mesh``). The JAX package
reads the names from the flax boxes (``with_logical_partitioning``) and
XLA's partitioner emits the collectives; the port keeps the transformer's
names in a table keyed by flax path (:data:`TRANSFORMER_LOGICAL`) and
runs the collectives by hand:

- :func:`param_shardings` gives each leaf its spec and, for a rank of
  the mesh, its slice of every dimension of the flax layout, as
  ``jax.device_put(leaf, NamedSharding(mesh, spec))`` places it;
- :func:`shard_tree` / :func:`gather_tree` cut a flax tree (numpy) into
  a rank's shards and put the ranks' shards back together;
- :func:`shard_module` replaces each parameter of a port module that the
  rules shard over ``fsdp`` or ``tp`` by this rank's slice (in the torch
  layout, ``bridge.torch_dim`` maps the rule's flax dim) and tags it
  (:func:`fsdp_spec`, :func:`tp_spec`);
  :func:`full` is what a forward reads instead of such a parameter: an
  autograd function whose forward all-gathers the leaf along its fsdp
  dim and whose backward reduce-scatters the gradient back to the slice,
  as a mean over the fsdp group. A tp slice is never gathered: the
  model computes with the rank's heads, MLP columns and vocab rows, and
  its tp layers run the collectives (``models/transformer.py``). The
  optimizer then runs on the slices (``train/step.py``).

``constrain`` is a no-op: ``with_sharding_constraint`` tells XLA where
an activation should live; the port has no partitioner, and its
activations are wherever the rank's forward computes them (its batch
rows, whole parameters gathered at the point of use).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.parallel.mesh import TP_AXIS

# Default rule table for the transformer family (the JAX package's).
#   batch: batch dim of activations; seq: sequence dim; vocab: the
#   lm_head's vocab dim; embed: model dim; heads, kv: attention heads and
#   per-head dim; mlp: feed-forward hidden dim; vocab_table/embed_table:
#   the token table (sharded on its embedding dim only, over tp); expert /
#   expert_router: MoE tables.
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("vocab", "tp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv", None),
    ("mlp", "tp"),
    ("vocab_table", None),
    ("embed_table", "tp"),
    ("expert", "ep"),
    ("expert_router", None),
)

# The rules by which the port places parameters: the JAX package's, with
# "seq" unsharded (an sp rank keeps every parameter whole along sp; see
# shard_module).
PARAM_RULES = tuple((n, None if n == "seq" else a) for n, a in DEFAULT_RULES)

# The transformer's logical names, by flax path (the JAX model's
# with_logical_partitioning calls); a path not matched is replicated
# (the LayerNorms).
TRANSFORMER_LOGICAL: tuple[tuple[str, tuple[str, ...]], ...] = (
    (r"tok_embed/embedding", ("vocab_table", "embed_table")),
    (r"pos_embed", ("seq", "embed")),
    (r"block\d+/attn/(query|key|value)/kernel", ("embed", "heads", "kv")),
    (r"block\d+/attn/out/kernel", ("heads", "kv", "embed")),
    (r"block\d+/mlp_in/kernel", ("embed", "mlp")),
    (r"block\d+/mlp_out/kernel", ("mlp", "embed")),
    (r"block\d+/moe_mlp/router", ("embed", "expert_router")),
    (r"block\d+/moe_mlp/w_in", ("expert", "embed", "mlp")),
    (r"block\d+/moe_mlp/w_out", ("expert", "mlp", "embed")),
    (r"lm_head/kernel", ("embed", "vocab")),
)

FSDP_AXIS = "fsdp"
SP_AXIS = "sp"


def logical_names(path: Sequence[str]) -> tuple[str, ...] | None:
    """The logical axis names of a transformer leaf by its flax path
    (None: a replicated leaf)."""
    joined = "/".join(path)
    for pattern, names in TRANSFORMER_LOGICAL:
        if re.fullmatch(pattern, joined):
            return names
    return None


def _mesh_axes(mesh) -> dict[str, int]:
    if mesh is None:
        return {}
    return dict(mesh.shape)


def logical_to_spec(logical: Sequence[str | None],
                    rules: Sequence[tuple[str, Any]] = DEFAULT_RULES,
                    mesh=None) -> tuple:
    """Map logical axis names to a PartitionSpec's entries (a tuple:
    None, an axis name or a tuple of them, trailing Nones dropped). Mesh
    axes not in ``mesh`` (or of size 1) are dropped, so one rule table
    serves every mesh shape."""
    axes_of = _mesh_axes(mesh)
    taken: set[str] = set()
    out: list[Any] = []
    for name in logical:
        axis = None
        if name is not None:
            for rule_name, rule_axis in rules:
                if rule_name == name:
                    axis = rule_axis
                    break
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if mesh is not None:
            axes = tuple(a for a in axes if axes_of.get(a, 1) > 1)
        axes = tuple(a for a in axes if a not in taken)
        taken.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclass(frozen=True)
class LeafShard:
    """One leaf's placement for one rank: its spec, and its slice of
    every dimension of the flax layout."""

    spec: tuple
    index: tuple[slice, ...]


def _dim_slice(mesh, entry, size: int, coords: dict) -> slice:
    if entry is None:
        return slice(0, size)
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    if size % count:
        raise ValueError(f"dim of {size} does not split over {axes} "
                         f"({count} ways)")
    step = size // count
    return slice(index * step, (index + 1) * step)


def leaf_shard(mesh, spec: tuple, shape: Sequence[int],
               coords: dict | None = None) -> LeafShard:
    """The slices of a leaf of flax ``shape`` that the rank at ``coords``
    (default: this process's) holds under ``spec``."""
    coords = mesh.coords if coords is None else coords
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return LeafShard(tuple(spec), tuple(
        _dim_slice(mesh, e, n, coords) for e, n in zip(entries, shape)))


def param_shardings(mesh, paths_shapes: Sequence[tuple[tuple, tuple]],
                    rules: Sequence[tuple[str, Any]] = DEFAULT_RULES,
                    coords: dict | None = None) -> list[LeafShard]:
    """Each transformer leaf's :class:`LeafShard`, from ``(flax path,
    flax shape)`` pairs: the leaves with logical names get their spec
    through ``rules``, the others are replicated."""
    out = []
    for path, shape in paths_shapes:
        names = logical_names(path)
        spec = () if names is None else logical_to_spec(names, rules, mesh)
        out.append(leaf_shard(mesh, spec, shape, coords))
    return out


def _tree_leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_tree_leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _insert(tree: dict, path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def shard_tree(params: dict, mesh, coords: dict | None = None,
               rules: Sequence[tuple[str, Any]] = DEFAULT_RULES) -> dict:
    """A flax transformer param tree (nested dicts of numpy) -> the
    shards the rank at ``coords`` holds (copies), in the flax layout."""
    leaves = _tree_leaves(params)
    shards = param_shardings(
        mesh, [(p, np.shape(a)) for p, a in leaves], rules, coords)
    out: dict = {}
    for (path, arr), sh in zip(leaves, shards):
        _insert(out, path, np.array(np.asarray(arr)[sh.index]))
    return out


def gather_tree(shards: Sequence[dict], mesh,
                rules: Sequence[tuple[str, Any]] = DEFAULT_RULES) -> dict:
    """The ranks' shard trees (in rank order over ``mesh.devices``) put
    back into whole leaves."""
    ranks = [int(r) for r in mesh.devices.reshape(-1)]
    coords = {r: dict(zip(mesh.axis_names,
                          map(int, np.argwhere(mesh.devices == r)[0])))
              for r in ranks}
    first = _tree_leaves(shards[0])
    out: dict = {}
    for i, (path, part0) in enumerate(first):
        names = logical_names(path)
        spec = () if names is None else logical_to_spec(names, rules, mesh)
        parts = [_tree_leaves(shards[r])[i][1] for r in range(len(ranks))]
        shape = list(np.shape(part0))
        for d, e in enumerate(spec):
            if e is not None:
                axes = (e,) if isinstance(e, str) else e
                shape[d] *= int(np.prod([mesh.shape[a] for a in axes]))
        full = np.empty(shape, np.asarray(part0).dtype)
        for r in ranks:
            sh = leaf_shard(mesh, spec, shape, coords[r])
            full[sh.index] = parts[r]
        _insert(out, path, full)
    return out


def constrain(x: torch.Tensor, logical: Sequence[str | None], mesh=None,
              rules: Sequence[tuple[str, Any]] = DEFAULT_RULES
              ) -> torch.Tensor:
    """``with_sharding_constraint`` by logical names: the identity (see
    the module docstring)."""
    del logical, mesh, rules
    return x


# -- the FSDP and tp parameter planes -------------------------------------------


@dataclass(frozen=True)
class FsdpSpec:
    """A parameter held as this rank's slice: ``dim`` of the torch layout
    split ``world`` ways over ``group`` (this rank holds slice ``index``),
    ``flax_dim`` the same dim in the flax layout, ``full_shape`` the
    shape :func:`full` gathers: the whole leaf's torch shape, or under tp
    the rank's tp slice's."""

    dim: int
    flax_dim: int
    world: int
    index: int
    group: Any
    full_shape: tuple[int, ...]


@dataclass(frozen=True)
class TpSpec(FsdpSpec):
    """A parameter split over tp: :class:`FsdpSpec`'s fields, with
    ``group`` the tp group's collectives (``distributed.tp_comm``) and
    ``full_shape`` the whole leaf's torch shape. The forward computes
    with the slice; the model's tp layers run the collectives."""


def fsdp_spec(p: torch.Tensor) -> FsdpSpec | None:
    return getattr(p, "_fsdp", None)


def tp_spec(p: torch.Tensor) -> TpSpec | None:
    return getattr(p, "_tp", None)


def cuts(p: torch.Tensor) -> list:
    """The parameter's cuts, in the order they were taken: its tp slice,
    then the fsdp slice of that."""
    return [s for s in (tp_spec(p), fsdp_spec(p)) if s is not None]


def whole_shape(p: torch.Tensor) -> tuple[int, ...]:
    """The torch shape of the whole leaf of which ``p`` is a slice."""
    spec = tp_spec(p) or fsdp_spec(p)
    return tuple(p.shape) if spec is None else spec.full_shape


def owns_chunk(p: torch.Tensor) -> bool:
    """Whether this rank writes ``p``'s slice to a sharded checkpoint: the
    JAX package's ``replica_id == 0``, the rank at coordinate 0 of every
    mesh axis that does not split the leaf."""
    return getattr(p, "_owner", True)


class _GatherParam(torch.autograd.Function):
    """Forward: the whole leaf, all-gathered along ``spec.dim``.
    Backward: its gradient reduce-scattered back to this rank's slice,
    as a mean over the group (1/W times the sum: W is a power of two in
    every world the tests and the card run, so the scaling is exact)."""

    @staticmethod
    def forward(ctx, shard, spec):
        ctx.spec = spec
        return gather_like(shard.detach(), spec)

    @staticmethod
    def backward(ctx, grad):
        spec = ctx.spec
        stacked = torch.stack(grad.chunk(spec.world, dim=spec.dim))
        out = distributed.reduce_scatter(stacked.reshape(-1), spec.group)
        shard_shape = stacked.shape[1:]
        return out.view(shard_shape).mul_(1.0 / spec.world), None


def full(p: torch.Tensor) -> torch.Tensor:
    """The parameter a forward reads: ``p`` itself, or for an
    fsdp-sharded parameter its slices gathered from the group
    (differentiable), up to the rank's tp slice."""
    spec = fsdp_spec(p)
    if spec is None:
        return p
    return _GatherParam.apply(p, spec)


SHARD_AXES = (TP_AXIS, FSDP_AXIS)


def shard_module(model: torch.nn.Module, mesh,
                 rules: Sequence[tuple[str, Any]] = DEFAULT_RULES
                 ) -> dict[str, Any]:
    """Keep only this rank's slice of every parameter the rules shard
    over fsdp or tp (the whole module was built, identically, on every
    rank): the tp slice first, then the fsdp slice of it (a leaf such as
    ``mlp_in``, ``P("fsdp", "tp")``, splits on two dims). Returns each
    sharded parameter's spec by name (its FsdpSpec where it has one,
    else its TpSpec). Axes of size 1 shard nothing.

    In the torch layout (``bridge.torch_dim``): q/k/v are (H·Dh, d) with
    the heads the major dim, so a rank's heads are one block of rows, and
    ``out`` (d, H·Dh) splits along its columns; ``mlp_in`` and
    ``lm_head`` split their rows over tp, ``mlp_out`` its columns, the
    token table its embedding columns. An sp axis shards no parameter
    (the JAX package's "seq" rule places ``pos_embed`` over sp; every sp
    rank here keeps it whole, and the model reads its block's rows).
    Expert tables split over ep or tp raise (ROADMAP Queue 1 item 14(d),
    its ep half)."""
    from edl_tpu_torch import bridge

    sizes = {a: mesh.axis_size(a) for a in SHARD_AXES}
    specs: dict[str, Any] = {}
    if all(n <= 1 for n in sizes.values()):
        return specs
    plan, owners = [], []
    for name, p in model.named_parameters():
        path = bridge.flax_path(name)
        names = logical_names(path)
        if names is None:
            continue
        spec = tuple(_without(e, SP_AXIS)
                     for e in logical_to_spec(names, rules, mesh))
        dims = {d: e for d, e in enumerate(spec) if e is not None}
        if not dims:
            continue
        if "moe_mlp" in path or any(e not in SHARD_AXES
                                    for e in dims.values()):
            raise NotImplementedError(
                f"{name}: spec {spec} shards an expert table or over more "
                "than fsdp and tp (expert tables over ep or tp: ROADMAP "
                "Queue 1 item 14(d))")
        for axis in SHARD_AXES:
            for fdim, e in dims.items():
                if e != axis:
                    continue
                tdim = bridge.torch_dim(name, fdim, len(names))
                if p.shape[tdim] % sizes[axis]:
                    raise ValueError(f"{name}: dim {tdim} of "
                                     f"{tuple(p.shape)} does not split over "
                                     f"{sizes[axis]} ranks")
                plan.append((name, p, axis, fdim, tdim))
        owners.append((p, all(mesh.coords[a] == 0 for a in mesh.axis_names
                              if a not in dims.values())))
    comm = distributed.tp_comm(mesh) if sizes[TP_AXIS] > 1 else None
    for p, owner in owners:
        p._owner = owner
    with torch.no_grad():
        for name, p, axis, fdim, tdim in plan:
            world, index = sizes[axis], mesh.coords[axis]
            cls, group = ((TpSpec, comm) if axis == TP_AXIS
                          else (FsdpSpec, mesh.group(axis)))
            s = cls(dim=tdim, flax_dim=fdim, world=world, index=index,
                    group=group, full_shape=tuple(p.shape))
            p.data = p.data.chunk(world, dim=tdim)[index].contiguous()
            setattr(p, "_tp" if axis == TP_AXIS else "_fsdp", s)
            specs[name] = s
    return specs
def _without(entry, axis: str):
    """A spec entry with ``axis`` taken out (None when nothing is left)."""
    if entry is None:
        return None
    axes = tuple(a for a in ((entry,) if isinstance(entry, str) else entry)
                 if a != axis)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def is_sharded(model: torch.nn.Module) -> bool:
    return any(cuts(p) for p in model.parameters())


def gather_like(t: torch.Tensor, spec) -> torch.Tensor:
    """``t``, a slice in ``spec``'s layout (a parameter or a moment),
    gathered along ``spec.dim`` over the spec's group (an FsdpSpec's
    process group, a TpSpec's tp collectives)."""
    if isinstance(spec, TpSpec):
        parts = spec.group.all_gather(t.contiguous())
        return torch.cat(parts.unbind(0), dim=spec.dim)
    if not distributed.is_initialized():
        raise RuntimeError("a sharded leaf is gathered over its world, "
                           "which this process has left")
    parts = distributed.all_gather(t.contiguous(), spec.group)
    return torch.cat(parts.unbind(0), dim=spec.dim)


def gather_whole(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``t``, in parameter ``p``'s sharded layout (``p`` itself, its
    gradient or a moment), gathered whole: over fsdp, then over tp
    (collective over both groups)."""
    for spec in reversed(cuts(p)):
        t = gather_like(t, spec)
    return t
