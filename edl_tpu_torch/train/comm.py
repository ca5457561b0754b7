"""The manual gradient path: bucketed, optionally hierarchical and
compressed data-parallel reductions (port of ``edl_tpu.train.comm``: the
bucket planner, ``CommConfig``, the wire accounting, the reductions,
``CommTrainStep``, the parity and convergence gates).

A step runs the forward and backward on this rank's share of the batch,
scales the local gradients by 1/W (each is the gradient of the local
mean, so their sum is the global mean's), packs them into flat,
dtype-grouped buckets (``plan_buckets(..., align=W)``, over the leaves in
the flax flatten order, so a bucket holds the same leaves as the JAX
package's and the int8 wire takes one scale per bucket as it does) and
reduces each bucket as an independent collective:

- one world: ``all_reduce`` of the bucket;
- several slices: a dense ``reduce_scatter`` inside the slice, the
  cross-slice leg on the rank's 1/C shard, then an ``all_gather`` inside
  the slice. The cross-slice leg is dense, top-k values and int32
  indices with an error-feedback residual (``_cross_topk``), or int8
  values with one fp32 scale a rank and a residual (``_cross_int8``, on
  the ``ops/pack.all_gather_packed`` wire). A flat world with
  compression on treats every rank as its own slice.

A step runs the buckets in phases (``_reduce_buckets``): every
reduce-scatter, then one ``ops/pack.pack_int8_buckets`` call over every
int8 leg's input (kernel K8 once over all of them), then each bucket's
cross-slice leg in bucket order, then every all-gather. Each bucket keeps
its own scale, so the result is bit for bit that of reducing the buckets
one by one (``_reduce_bucket``, the one-bucket case).

The loss and the float metrics are averaged over the world, and so are
the BatchNorm running buffers after each step (the JAX package's
``pmean`` of ``batch_stats``): without it the replicas drift apart. Each
rank keeps its own row of the JAX package's (world, m) residual. Every
rank starts from rank 0's parameters and buffers (one broadcast per dtype
at the first step). Transient comm state (the residuals) is not
checkpointed, as in the JAX package.

The MoE dispatch: ``MoEDispatchConfig``, ``moe_all_to_all`` (flat: one
all-to-all over the ep ranks; hier: the in-slice leg and the cross-slice
leg over ``mesh.ep_comm_groups``' columns, the cross leg optionally int8
through ``ops/pack``'s wire, K8 on a card), ``moe_leg_bytes``,
``MoEWire`` (what a wired ``MoEMLP`` dispatches through),
``MoECommStep`` (the comm step over an ep-only mesh, with the
``step.moe_dispatch`` span and the ``step_moe_dcn_bytes`` counter),
``moe_parity_gate`` and ``moe_convergence_smoke``. The all-to-alls are
differentiable: each leg's backward is its own transpose, and the int8
leg's is the derivative JAX takes of its expression (the scales carry
it; rounding has none).

``python -m edl_tpu_torch.train.comm smoke [--compress topk|int8]
[--steps N] [--envelope E] [--slices S] [--moe] [--device cpu]`` runs
the convergence smoke over the world the EDL_TPU_* env describes (a
world of one without it) and prints the JAX CLI's one
``{"comm_smoke": ...}`` line, or with ``--moe`` its
``{"moe_smoke": ...}`` line; it exits 0 only when every gate holds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace
from edl_tpu_torch.ops.pack import (all_gather_packed, all_to_all_packed,
                                   dequantize_int8, pack_int8_buckets)
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.parallel import mesh as mesh_lib
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.train.comm")

COMPRESS_MODES = ("off", "topk", "int8")


@dataclass(frozen=True)
class CommConfig:
    """Knobs of the manual gradient path.

    bucket_mb: target bucket payload in MiB (EDL_TPU_COMM_BUCKET_MB).
      A leaf larger than the target gets its own bucket.
    compress: cross-slice wire format (EDL_TPU_DCN_COMPRESS): 'off'
      (dense), 'topk' (values + indices, error feedback), 'int8' (one
      scale a rank, error feedback).
    topk_frac: fraction of each rank's shard shipped under 'topk'.
    min_compress_elems: shards smaller than this stay dense (index/scale
      overhead would exceed the payload).
    """

    bucket_mb: float = 4.0
    compress: str = "off"
    topk_frac: float = 0.01
    min_compress_elems: int = 1024

    def __post_init__(self):
        if self.compress not in COMPRESS_MODES:
            raise ValueError(
                f"compress must be one of {COMPRESS_MODES}, "
                f"got {self.compress!r}")
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac}")


# -- bucket planning (host-side, static) -------------------------------------


@dataclass(frozen=True)
class _Slot:
    """One leaf's home inside a bucket buffer."""

    leaf: int            # index into the leaf list
    offset: int          # start inside the bucket's flat buffer
    size: int
    shape: tuple


@dataclass(frozen=True)
class _Bucket:
    dtype: torch.dtype
    slots: tuple[_Slot, ...]
    size: int            # payload elements (sum of slot sizes)
    padded: int          # payload + pad, a multiple of align


@dataclass(frozen=True)
class BucketPlan:
    """Static partition of a leaf list into buckets, deterministic in the
    leaves' order, shapes and dtypes, ``bucket_mb`` and ``align``."""

    buckets: tuple[_Bucket, ...]
    n_leaves: int
    align: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def padded_elems(self) -> int:
        return sum(b.padded for b in self.buckets)


def plan_buckets(leaves: Sequence[torch.Tensor], bucket_mb: float,
                 align: int) -> BucketPlan:
    """Greedy, in-order bucket partition of the tensors ``leaves``.

    Leaves are grouped by dtype, then packed in list order into buckets
    of at most ``bucket_mb`` MiB payload; an oversized leaf gets a bucket
    of its own, never split. Each bucket is padded up to a multiple of
    ``align``.
    """
    budget = max(1, int(bucket_mb * (1 << 20)))
    by_dtype: dict[torch.dtype, list[tuple[int, torch.Tensor]]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append((i, leaf))
    buckets: list[_Bucket] = []
    for dtype in sorted(by_dtype, key=_dtype_name):
        pending: list[_Slot] = []
        pend_bytes = 0
        itemsize = _itemsize(dtype)

        def flush():
            nonlocal pending, pend_bytes
            if not pending:
                return
            size = sum(s.size for s in pending)
            padded = -(-size // align) * align
            buckets.append(_Bucket(dtype=dtype, slots=tuple(pending),
                                   size=size, padded=padded))
            pending, pend_bytes = [], 0

        offset = 0
        for i, leaf in by_dtype[dtype]:
            size = leaf.numel()
            if pending and pend_bytes + size * itemsize > budget:
                flush()
                offset = 0
            pending.append(_Slot(leaf=i, offset=offset, size=size,
                                 shape=tuple(leaf.shape)))
            offset += size
            pend_bytes += size * itemsize
            if pend_bytes >= budget:
                flush()
                offset = 0
        flush()
    return BucketPlan(buckets=tuple(buckets), n_leaves=len(leaves),
                      align=align)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a dtype: the JAX package sorts dtype groups by
    it ("float32", "int32", ...)."""
    return str(dtype).removeprefix("torch.")


def pack_buckets(leaves: Sequence[torch.Tensor], plan: BucketPlan
                 ) -> list[torch.Tensor]:
    """Leaf list -> list of flat padded bucket buffers (zero padding). A
    bucket of one leaf without padding is a view of that leaf."""
    out = []
    for b in plan.buckets:
        parts = [leaves[s.leaf].reshape(-1) for s in b.slots]
        if b.padded > b.size:
            parts.append(torch.zeros(b.padded - b.size, dtype=b.dtype,
                                     device=parts[0].device))
        out.append(torch.cat(parts) if len(parts) > 1 else parts[0])
    return out


def unpack_buckets(buffers: Sequence[torch.Tensor], plan: BucketPlan
                   ) -> list[torch.Tensor]:
    """Inverse of :func:`pack_buckets` (padding discarded): views into
    ``buffers``, in leaf order."""
    leaves: list = [None] * plan.n_leaves
    for buf, b in zip(buffers, plan.buckets):
        for s in b.slots:
            leaves[s.leaf] = buf[s.offset:s.offset + s.size].view(s.shape)
    return leaves


# -- wire accounting (static per plan) ---------------------------------------


def dcn_bytes_per_step(plan: BucketPlan, config: CommConfig,
                       n_slices: int, chips_per_slice: int) -> int:
    """Bytes ONE rank contributes to the cross-slice leg per step: the
    payload, not the fabric's duplication. Dense: the rank's
    reduce-scatter shard at native width; topk: k x (value + int32
    index); int8: one byte an element and the fp32 scale. A world of one
    slice crosses no slow edge and reports 0."""
    if n_slices <= 1:
        return 0
    return sum(_leg_bytes(b.padded // chips_per_slice, _itemsize(b.dtype),
                          config) for b in plan.buckets)


def _leg_bytes(m: int, itemsize: int, config: CommConfig) -> int:
    """Cross-slice bytes one rank sends for an m-element shard."""
    if config.compress == "off" or m < config.min_compress_elems:
        return m * itemsize
    if config.compress == "topk":
        k = _topk_k(m, config.topk_frac)
        return k * (itemsize + 4)
    return m * 1 + 4  # int8 payload + fp32 scale


def _topk_k(m: int, frac: float) -> int:
    return max(1, int(round(m * frac)))


# -- the reduction -----------------------------------------------------------


def _cross_dense(shard, group):
    return distributed.all_reduce(shard, group)


def _cross_topk(shard, resid, group, k):
    """Top-k values + int32 indices over the cross-slice edge with error
    feedback: every member contributes the k largest |.| entries of
    (shard + residual); the gathered (G, k) pairs add, row by row in
    group-rank order, into a dense result identical across the group.
    Unsent mass stays in the residual."""
    u = shard + resid
    _, idx = torch.topk(u.abs(), k)
    vals = u[idx]
    all_vals = distributed.all_gather(vals, group)
    all_idx = distributed.all_gather(idx.to(torch.int32), group).long()
    dense = torch.zeros_like(u)
    for row_idx, row_vals in zip(all_idx, all_vals):
        dense.index_add_(0, row_idx, row_vals)
    sent = torch.zeros_like(u).index_add_(0, idx, vals)
    return dense, u - sent


def _cross_int8(u, q, scale, group):
    """int8 cross-slice edge of u = shard + residual, packed as (q, scale)
    with one symmetric scale a rank (K8 on a card): error feedback keeps
    the quantization error local and re-contributed. u becomes the new
    residual in place. Returns the dense sum."""
    gathered, local = all_gather_packed(q, scale, group)
    dense = torch.sum(gathered.to(u.dtype), dim=0)
    u.sub_(local.to(u.dtype))
    return dense


def _leg(shard, config: CommConfig) -> str:
    """The cross-slice leg of a shard: "dense", "topk" or "int8"."""
    if config.compress == "off" or shard.shape[0] < config.min_compress_elems \
            or not shard.dtype.is_floating_point:
        return "dense"
    return config.compress


def _reduce_buckets(bufs, resids: list, *, n_slices: int, chips: int,
                    config: CommConfig, groups=(None, None)) -> list:
    """Every bucket's dp reduction, in phases: the intra-slice
    reduce-scatters; u = shard + residual of every int8 leg, packed in one
    ``pack_int8_buckets`` call; each bucket's cross-slice leg in bucket
    order; the intra-slice all-gathers. ``groups`` is this rank's
    (intra-slice, cross-slice) process groups (``mesh.comm_groups``).
    Returns the reduced full buckets. ``resids``, this rank's residual
    shards, is updated in place: an int8 leg's u replaces its residual as
    soon as it is formed and becomes the new one in place, so a step holds
    one residual a bucket, as one bucket at a time did; a dense leg's
    stays as it came."""
    if n_slices <= 1:
        # no slow edge: one dense all-reduce of each bucket
        return [distributed.all_reduce(b) for b in bufs]
    intra, cross = groups
    shards = [distributed.reduce_scatter(b, intra) if chips > 1 else b
              for b in bufs]
    legs = [_leg(shard, config) for shard in shards]
    int8 = [i for i, leg in enumerate(legs) if leg == "int8"]
    for i in int8:
        resids[i] = shards[i] + resids[i]
    packed = (dict(zip(int8, pack_int8_buckets([resids[i] for i in int8])))
              if int8 else {})
    outs = []
    for i, leg in enumerate(legs):
        shard, shards[i] = shards[i], None   # freed once its leg is done
        if leg == "dense":
            out = _cross_dense(shard, cross)
        elif leg == "topk":
            out, resids[i] = _cross_topk(
                shard, resids[i], cross, _topk_k(shard.shape[0],
                                                 config.topk_frac))
        else:
            out = _cross_int8(resids[i], *packed.pop(i), cross)
        outs.append(out)
    if chips > 1:
        outs = [distributed.all_gather(o, intra).reshape(-1) for o in outs]
    return outs


def _reduce_bucket(buf, resid, *, n_slices: int, chips: int,
                   config: CommConfig, groups=(None, None)):
    """One bucket's dp reduction: the one-bucket case of
    ``_reduce_buckets``. Returns (reduced full bucket, new residual
    shard)."""
    resids = [resid]
    (out,) = _reduce_buckets([buf], resids, n_slices=n_slices, chips=chips,
                             config=config, groups=groups)
    return out, resids[0]


def _needs_residual(bucket: _Bucket, chips: int, n_slices: int,
                    config: CommConfig) -> bool:
    return (config.compress != "off" and n_slices > 1
            and bucket.padded // chips >= config.min_compress_elems
            and bucket.dtype.is_floating_point)


# -- the step ----------------------------------------------------------------


class CommTrainStep:
    """``(state, batch) -> (state, metrics)`` with the manual bucketed
    gradient path, over the world ``parallel/distributed`` joined (a
    world of one without a process group). Drop-in for TrainLoop; same
    ``loss_fn(model, batch[, step]) -> (loss, aux)`` contract as
    ``make_train_step``.

    Built lazily: the first call plans the buckets from the state's
    leaves (``state.params``, flax order), forms the process groups,
    zeroes the residuals and broadcasts rank 0's parameters and buffers.
    """

    def __init__(self, loss_fn: Callable, *, config: CommConfig,
                 topology=None, with_step: bool = False):
        self.loss_fn = loss_fn
        self.config = config
        self.with_step = with_step
        self.world = distributed.world_size()
        topology = topology or mesh_lib.SliceTopology(1, self.world)
        if self.world % topology.n_slices:
            raise ValueError(
                f"dp={self.world} not divisible by n_slices="
                f"{topology.n_slices}")
        self.topology = topology
        # flat world + compression: every rank is its own slice, so the
        # whole world is the slow edge
        if config.compress != "off" and not topology.is_multi_slice:
            self.n_slices, self.chips = self.world, 1
        else:
            self.n_slices = topology.n_slices
            self.chips = self.world // topology.n_slices
        self.plan: BucketPlan | None = None
        self.groups = (None, None)
        self.resid: list[torch.Tensor] = []
        self.steps = 0
        self._bytes_counter = obs_metrics.registry().counter(
            "step_dcn_bytes",
            help="bytes this process contributed to cross-slice gradient "
                 "legs")

    # -- static accounting (bench/obs surface) ------------------------------

    def dcn_bytes_per_step(self) -> int:
        """Per-rank cross-slice payload bytes each step (0 until the
        first call plans the buckets; 0 on one slice unless compression
        treats the flat world as the slow edge)."""
        if self.plan is None:
            return 0
        return dcn_bytes_per_step(self.plan, self.config,
                                  n_slices=self.n_slices,
                                  chips_per_slice=self.chips)

    def dcn_overlap_pct(self) -> float:
        """Share of cross-slice bytes whose reduction could be in flight
        before the LAST bucket's gradients exist: a schedule property of
        the plan, not a measurement. 0 for a single bucket."""
        if self.plan is None or self.plan.n_buckets <= 1 \
                or self.n_slices <= 1:
            return 0.0
        per_bucket = [_leg_bytes(b.padded // self.chips, _itemsize(b.dtype),
                                 self.config) for b in self.plan.buckets]
        total = sum(per_bucket)
        if total <= 0:
            return 0.0
        return round(100.0 * (total - per_bucket[-1]) / total, 2)

    def stats(self) -> dict:
        return {"comm_buckets": self.plan.n_buckets if self.plan else 0,
                "comm_bucket_mb": self.config.bucket_mb,
                "dcn_compress": self.config.compress,
                "dcn_bytes_per_step": self.dcn_bytes_per_step(),
                "dcn_overlap_pct": self.dcn_overlap_pct(),
                "comm_steps": self.steps}

    # -- build ---------------------------------------------------------------

    def _build(self, state) -> None:
        leaves = [p for _, p in state.params]
        self.plan = plan_buckets(leaves, self.config.bucket_mb,
                                 align=self.world)
        if self.n_slices > 1:
            self.groups = mesh_lib.comm_groups(self.n_slices, self.chips)
        self.resid = [
            torch.zeros(b.padded // self.chips if _needs_residual(
                b, self.chips, self.n_slices, self.config) else 0,
                dtype=b.dtype, device=leaves[0].device)
            for b in self.plan.buckets]
        _sync_module(state.model, average=False)
        log.info(
            "comm step: %d buckets (%.1f MiB target, align %d), %dx%d "
            "topology, compress=%s, dcn_bytes/step=%d, schedulable overlap "
            "%.1f%%", self.plan.n_buckets, self.config.bucket_mb,
            self.world, self.n_slices, self.chips, self.config.compress,
            self.dcn_bytes_per_step(), self.dcn_overlap_pct())

    # -- dispatch ------------------------------------------------------------

    def __call__(self, state, batch):
        if self.plan is None:
            self._build(state)
        span = trace.start_span(
            "step.dcn_reduce", attrs={"buckets": self.plan.n_buckets,
                                      "compress": self.config.compress,
                                      "dcn_bytes":
                                          self.dcn_bytes_per_step()})
        try:
            state, metrics = self._step(state, batch)
        finally:
            if span is not None:
                span.end()
        self.steps += 1
        self._bytes_counter.inc(self.dcn_bytes_per_step())
        return state, metrics

    def _step(self, state, batch):
        leaves = [p for _, p in state.params]
        for p in leaves:
            p.grad = None
        loss, aux = (self.loss_fn(state.model, batch, state.step)
                     if self.with_step else self.loss_fn(state.model, batch))
        loss.backward()
        aux.pop("batch_stats", None)   # BatchNorm buffers: _sync_module
        inv_w = 1.0 / self.world   # power-of-two worlds: an EXACT scaling
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
        for g in grads:
            g.mul_(inv_w)
        for p, g in zip(leaves, self._reduce(grads)):
            p.grad = g
        # the loss summed from 1/W shares, the float metrics averaged:
        # one collective for all of them
        floats = [k for k, v in aux.items() if v.is_floating_point()]
        scalars = torch.stack([loss.detach().float() * inv_w]
                              + [aux[k].detach().float() for k in floats])
        distributed.all_reduce(scalars)
        metrics = {"loss": scalars[0], **aux}
        for i, k in enumerate(floats):
            metrics[k] = scalars[i + 1] / self.world
        _sync_module(state.model, average=True)
        return state.apply_gradients(), metrics

    def _reduce(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The reduced gradients (already scaled by 1/W): every bucket
        through ``_reduce_buckets``' phases."""
        out = _reduce_buckets(
            pack_buckets(grads, self.plan), self.resid,
            n_slices=self.n_slices, chips=self.chips, config=self.config,
            groups=self.groups)
        return unpack_buckets(out, self.plan)


class _PerLeafStep(CommTrainStep):
    """The reference of :func:`loss_parity_gate`: one ``all_reduce`` per
    gradient leaf after the same 1/W scaling, without buckets (DDP's
    reduction without its buckets). The JAX package's reference is its
    SPMD-jitted step; the port has no SPMD partitioner."""

    def _reduce(self, grads):
        return [distributed.all_reduce(g) for g in grads]


def _sync_module(model: torch.nn.Module, average: bool) -> None:
    """Rank 0's parameters and buffers to every rank (``average=False``,
    one broadcast per dtype), or the floating buffers averaged over the
    world (``average=True``: the BatchNorm running statistics)."""
    sync_tensors(list(model.buffers()) if average
                 else list(model.parameters()) + list(model.buffers()),
                 average)


def sync_tensors(tensors: list, average: bool = False) -> None:
    """Rank 0's ``tensors`` to every rank (one broadcast per dtype), or,
    with ``average``, the floating ones averaged over the world."""
    if distributed.world_size() == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        if t.is_floating_point() or not average:
            by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for dtype in sorted(by_dtype, key=_dtype_name):
            ts = by_dtype[dtype]
            flat = torch.cat([t.reshape(-1) for t in ts])
            if average:
                distributed.all_reduce(flat).div_(distributed.world_size())
            else:
                distributed.broadcast(flat, 0)
            offset = 0
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def make_comm_train_step(loss_fn: Callable, *,
                         config: CommConfig | None = None, topology=None,
                         with_step: bool = False) -> CommTrainStep:
    """Build the manual-collective step over the joined world; returns a
    TrainLoop-compatible ``step(state, batch)`` carrying its bucket plan
    and wire accounting (``.stats()``)."""
    return CommTrainStep(loss_fn, config=config or CommConfig(),
                         topology=topology, with_step=with_step)


# -- MoE: hierarchical all-to-all dispatch -----------------------------------
#
# An MoE layer's hot collective is the token all-to-all (dispatch to the
# experts' owners, combine back). On a sliced topology it decomposes as
# the gradient reduction does: a leg inside the slice, then a
# cross-slice leg carrying the blocks bound for other slices, optionally
# int8 on the wire (ops/pack's int8 all-to-all, K8 on a card). The
# decomposition is a permutation: uncompressed it is bit for bit the
# flat collective (moe_parity_gate).

MOE_DISPATCH_MODES = ("flat", "hier")
MOE_COMPRESS_MODES = ("off", "int8")


@dataclass(frozen=True)
class MoEDispatchConfig:
    """Knobs of the manual MoE dispatch path.

    mode: 'flat' (one all-to-all over the whole ep axis) or 'hier' (the
      in-slice leg + the cross-slice leg; EDL_TPU_MOE_DISPATCH).
    compress: the cross-slice leg's wire (EDL_TPU_MOE_COMPRESS): 'off'
      (dense, bit for bit with flat) or 'int8' (one scale a destination
      block). int8 needs mode='hier': only it has a separate cross leg.
    """

    mode: str = "hier"
    compress: str = "off"

    def __post_init__(self):
        if self.mode not in MOE_DISPATCH_MODES:
            raise ValueError(
                f"mode must be one of {MOE_DISPATCH_MODES}, "
                f"got {self.mode!r}")
        if self.compress not in MOE_COMPRESS_MODES:
            raise ValueError(
                f"compress must be one of {MOE_COMPRESS_MODES}, "
                f"got {self.compress!r}")
        if self.compress != "off" and self.mode != "hier":
            raise ValueError(
                "compress needs mode='hier' — the flat single "
                "collective has no separate DCN leg to compress")


class _Int8AllToAll(torch.autograd.Function):
    """The int8 cross leg: block i of ``x`` packed at its own scale (one
    ``ops/pack.pack_int8_buckets`` call over the blocks, K8 on a card),
    sent to member i, dequantized there, in ``x``'s dtype (packed from
    fp32, as the kernel takes it).

    The backward is the derivative JAX takes of its expression: rounding
    has none, so only the scales carry a gradient. A received block's
    scale cotangent, sum(g * q), goes back to its sender, where the scale
    amax/127 passes it to the block's largest |x| (shared among ties, as
    ``jnp.max`` shares it), with x's sign."""

    @staticmethod
    def forward(ctx, x, group):
        xf = x.float()
        packed = pack_int8_buckets([xf[i].contiguous()
                                    for i in range(xf.shape[0])])
        q_r, s_r = all_to_all_packed(torch.stack([p[0] for p in packed]),
                                     torch.stack([p[1] for p in packed]),
                                     group)
        ctx.save_for_backward(xf, q_r)
        ctx.group, ctx.dtype = group, x.dtype
        return dequantize_int8(q_r, s_r.reshape(
            (x.shape[0],) + (1,) * (x.dim() - 1))).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xf, q_r = ctx.saved_tensors
        dims = tuple(range(1, xf.dim()))
        ds = distributed.all_to_all((g.float() * q_r.float()).sum(dim=dims),
                                    ctx.group)
        a = xf.abs()
        amax = a.amax(dim=dims, keepdim=True)
        at = ((a == amax) & (amax > 0)).float()
        count = at.sum(dim=dims, keepdim=True).clamp(min=1.0)
        d_amax = (ds / 127.0).reshape(amax.shape)
        return (torch.sign(xf) * at * (d_amax / count)).to(ctx.dtype), None


def moe_all_to_all(x: torch.Tensor, *, n_slices: int, chips: int,
                   mode: str = "hier", compress: str = "off", group=None,
                   groups=(None, None)) -> torch.Tensor:
    """Destination-major block transport over the ep ranks
    (differentiable: each leg's backward is its own transpose).

    ``x`` is (W, ...) on every rank: block ``x[w]`` is this rank's
    payload bound for rank ``w`` (W = n_slices * chips, slice-major).
    Returns the source-major received buffer of the same shape.

    'flat': one all-to-all over ``group`` (the ep axis's). 'hier': an
    all-to-all inside the slice (``groups[0]``) delivers every block to
    the rank of this slice at its destination's in-slice position, then
    one over the stride-C columns (``groups[1]``, mesh.ep_comm_groups)
    carries the blocks bound for other slices. A permutation: bit for
    bit 'flat' when uncompressed. compress='int8' quantizes only the
    cross-slice leg (:class:`_Int8AllToAll`, one scale a destination
    block); the in-slice blocks stay exact.
    """
    w = n_slices * chips
    if x.shape[0] != w:
        raise ValueError(
            f"dest-major dim {x.shape[0]} != world {n_slices}x{chips}")
    if mode == "flat" or n_slices <= 1:
        return distributed.all_to_all_grad(x, group)
    intra, cross = groups
    b = x.reshape((n_slices, chips) + tuple(x.shape[1:]))
    if chips > 1:
        b = distributed.all_to_all_grad(b.transpose(0, 1).contiguous(),
                                        intra).transpose(0, 1)
    if compress == "int8" and b.is_floating_point():
        b = _Int8AllToAll.apply(b.contiguous(), cross)
    else:
        b = distributed.all_to_all_grad(b, cross)
    return b.reshape(x.shape)


def moe_leg_bytes(block_elems: int, itemsize: int, n_slices: int,
                  chips: int, compress: str) -> int:
    """Cross-slice bytes ONE rank sends for one dispatch/combine leg
    whose per-destination block has ``block_elems`` elements: the
    off-slice blocks only, payload bytes (int8: one byte an element and
    one fp32 scale a destination slice)."""
    if n_slices <= 1:
        return 0
    off = (n_slices - 1) * chips * block_elems
    if compress == "int8":
        return off * 1 + (n_slices - 1) * 4  # int8 payload + fp32 scales
    return off * itemsize


@dataclass
class MoEWire:
    """The transport a wired MoE layer dispatches through
    (``models/transformer.MoEMLP``'s ``wire``): the buffers' reshapes and
    the grouped collectives, with an ``on_leg`` hook so the owning step
    accounts the wire's bytes.

    dispatch: (E, cap, d) dispatch buffer -> (E/W, W*cap, d), the tokens
      received for this rank's local experts.
    combine: the inverse, (E/W, W*cap, d) expert outputs back to
      (E, cap, d) at the tokens' owners.
    local_slice: (E, ...) replicated table -> this rank's (E/W, ...)
      expert rows.
    """

    n_slices: int
    chips: int
    config: MoEDispatchConfig
    index: int = 0                   # this rank's place on the ep axis
    group: object = None             # the ep axis's process group
    groups: tuple = (None, None)     # (in-slice, cross-slice) groups
    on_leg: Callable | None = None

    @property
    def world(self) -> int:
        return self.n_slices * self.chips

    def _transport(self, x):
        if self.on_leg is not None:
            self.on_leg(tuple(int(v) for v in x.shape), x.element_size())
        return moe_all_to_all(x, n_slices=self.n_slices, chips=self.chips,
                              mode=self.config.mode,
                              compress=self.config.compress,
                              group=self.group, groups=self.groups)

    def dispatch(self, buf):
        e, cap, d = buf.shape
        w = self.world
        if e % w:
            raise ValueError(f"n_experts={e} not divisible by ep "
                             f"world {w}")
        el = e // w
        r = self._transport(buf.reshape(w, el, cap, d))
        return r.transpose(0, 1).reshape(el, w * cap, d)

    def combine(self, out):
        el, wcap, d = out.shape
        w = self.world
        cap = wcap // w
        r = self._transport(
            out.reshape(el, w, cap, d).transpose(0, 1).contiguous())
        return r.reshape(w * el, cap, d)

    def local_slice(self, table):
        el = table.shape[0] // self.world
        return table[self.index * el:(self.index + 1) * el]


def _validate_ep_mesh(mesh) -> str:
    """The manual MoE path owns ep-only meshes; return the axis name."""
    if "ep" not in mesh.axis_names:
        raise ValueError(
            f"MoE comm step needs an ep axis; mesh axes "
            f"{mesh.axis_names}")
    for name in mesh.axis_names:
        if name != "ep" and mesh.shape[name] != 1:
            raise ValueError(
                "MoE comm step owns ep-only meshes (token dispatch is "
                f"the cross-slice traffic); axis {name!r} has size "
                f"{mesh.shape[name]} — keep the XLA-partitioned step "
                "for mixed meshes")
    return "ep"


class MoECommStep(CommTrainStep):
    """``(state, batch) -> (state, metrics)`` for an expert-parallel
    transformer over an ep-only mesh: the bucketed gradient reduction of
    :class:`CommTrainStep` over the ep ranks (each rank's local-mean
    gradients x 1/W, then summed; an expert's rows get a gradient only
    on the rank that owns the expert, so the reduction assembles each
    expert once) and the token dispatch through ``self.wire``.

    Built from a loss FACTORY: ``loss_factory(wire)`` returns the
    ``loss_fn(model, batch)`` whose MoE layers transport through the wire
    (the parameters are the same, wired or not). Each rank routes its
    own rows at its own capacity, as each chip does in the JAX package's
    manual region.
    """

    def __init__(self, loss_factory: Callable, *, mesh,
                 config: CommConfig | None = None,
                 moe_config: MoEDispatchConfig | None = None,
                 topology=None, with_step: bool = False):
        moe_config = moe_config or MoEDispatchConfig()
        _validate_ep_mesh(mesh)
        world = int(mesh.shape["ep"])
        if world != distributed.world_size():
            raise ValueError(f"the ep mesh of {world} ranks is not the "
                             f"joined world of {distributed.world_size()}")
        topology = topology or mesh_lib.SliceTopology(1, world)
        # flat world + hier dispatch: every rank its own slice (S=W,
        # C=1), so a flat world runs the whole cross-slice wire (int8 too)
        if moe_config.mode == "hier" and not topology.is_multi_slice:
            self._moe_slices, self._moe_chips = world, 1
        else:
            self._moe_slices = topology.n_slices
            self._moe_chips = world // topology.n_slices
        groups = (None, None)
        if moe_config.mode == "hier" and self._moe_slices > 1:
            groups = mesh_lib.comm_groups(self._moe_slices,
                                          self._moe_chips)
        self.moe_config = moe_config
        self._legs: list[tuple[tuple, int]] = []
        self.wire = MoEWire(n_slices=self._moe_slices,
                            chips=self._moe_chips, config=moe_config,
                            index=mesh.coords["ep"], group=mesh.group("ep"),
                            groups=groups, on_leg=self._record_leg)
        super().__init__(loss_factory(self.wire),
                         config=config or CommConfig(), topology=topology,
                         with_step=with_step)
        self._moe_counter = obs_metrics.registry().counter(
            "step_moe_dcn_bytes",
            help="bytes this process contributed to cross-slice (DCN) MoE "
                 "dispatch/combine legs")

    def _record_leg(self, shape: tuple, itemsize: int):
        # the legs of the first step are the plan (every step has the same)
        if self.steps == 0:
            self._legs.append((shape, itemsize))

    # -- static accounting (bench/obs surface) ------------------------------

    def moe_dcn_bytes_per_step(self) -> int:
        """Per-rank cross-slice dispatch+combine payload bytes each step
        (0 until the first call has run the wire)."""
        compress = (self.moe_config.compress
                    if self.moe_config.mode == "hier" else "off")
        total = 0
        for shape, itemsize in self._legs:
            block = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            total += moe_leg_bytes(block, itemsize, self._moe_slices,
                                   self._moe_chips, compress)
        return total

    def moe_dispatch_overlap_pct(self) -> float:
        """Share of cross-slice dispatch bytes whose leg could be in
        flight under other layers' expert compute: every leg but the
        last combine. A schedule property, not a measurement."""
        n = len(self._legs)
        if n <= 1 or self._moe_slices <= 1:
            return 0.0
        return round(100.0 * (n - 1) / n, 2)

    def stats(self) -> dict:
        out = super().stats()
        out.update({"moe_dispatch": self.moe_config.mode,
                    "moe_compress": self.moe_config.compress,
                    "moe_dispatch_legs": len(self._legs),
                    "moe_dcn_bytes_per_step":
                        self.moe_dcn_bytes_per_step(),
                    "moe_dispatch_overlap_pct":
                        self.moe_dispatch_overlap_pct()})
        return out

    def __call__(self, state, batch):
        span = trace.start_span(
            "step.moe_dispatch", attrs={
                "mode": self.moe_config.mode,
                "compress": self.moe_config.compress,
                "moe_dcn_bytes": self.moe_dcn_bytes_per_step()})
        try:
            out = super().__call__(state, batch)
        finally:
            if span is not None:
                span.end()
        self._moe_counter.inc(self.moe_dcn_bytes_per_step())
        return out


def make_moe_comm_step(loss_factory: Callable, *, mesh,
                       config: CommConfig | None = None,
                       moe_config: MoEDispatchConfig | None = None,
                       topology=None, with_step: bool = False
                       ) -> MoECommStep:
    """Build the manual MoE step. ``loss_factory(wire) -> loss_fn``;
    returns a TrainLoop-compatible ``step(state, batch)`` carrying the
    dispatch wire's accounting in ``.stats()``."""
    return MoECommStep(loss_factory, mesh=mesh, config=config,
                       moe_config=moe_config, topology=topology,
                       with_step=with_step)


# -- gates -------------------------------------------------------------------


def tree_bitwise_equal(a, b) -> bool:
    """Two sequences (or name -> tensor dicts) of tensors: same shapes,
    dtypes and bits (NaN equal to NaN)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return False
        a, b = list(a.values()), [b[k] for k in a]
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_floating_point():
            if not bool(((x == y) | (x.isnan() & y.isnan())).all()):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def loss_parity_gate(loss_fn: Callable, state_fn: Callable, batch, *,
                     config: CommConfig, topology=None, steps: int = 3,
                     envelope: float = 5e-3,
                     with_step: bool = False) -> dict:
    """The gate the bench must pass before reporting cross-slice numbers.

    1. bucketed-DENSE vs the per-leaf reference (:class:`_PerLeafStep`):
       identical parameters AND loss after ``steps`` steps, bitwise
       (``bitwise_dense``). At W = 2 every element of either reduction is
       one addition of the same two 1/W shares, so this holds by
       construction; at larger worlds a ring all-reduce may sum a bucket
       and a leaf in different orders.
    2. if ``config.compress != off``: the compressed path's per-step loss
       stays within ``envelope`` of the reference's
       (``loss_envelope_ok`` / ``max_loss_delta``).

    PyTorch updates in place, so each path trains a fresh state from
    ``state_fn()`` (the JAX package reuses one immutable state); ``batch``
    is this rank's share.
    """
    dense_cfg = dataclasses.replace(config, compress="off")

    def run(step):
        state, losses = state_fn(), []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return state, losses

    s_ref, ref_losses = run(_PerLeafStep(loss_fn, config=dense_cfg,
                                         topology=topology,
                                         with_step=with_step))
    s_dense, dense_losses = run(make_comm_train_step(
        loss_fn, config=dense_cfg, topology=topology, with_step=with_step))
    gate = {"bitwise_dense": tree_bitwise_equal(
                [p for _, p in s_ref.params], [p for _, p in s_dense.params])
            and dense_losses[-1] == ref_losses[-1],
            "dense_loss_delta": abs(dense_losses[-1] - ref_losses[-1]),
            "envelope": envelope, "steps": steps}
    if config.compress != "off":
        _, comp_losses = run(make_comm_train_step(
            loss_fn, config=config, topology=topology, with_step=with_step))
        deltas = [abs(c - r) for c, r in zip(comp_losses, ref_losses)]
        gate["max_loss_delta"] = max(deltas)
        gate["loss_envelope_ok"] = max(deltas) <= envelope
    gate["ok"] = bool(gate["bitwise_dense"]
                      and gate.get("loss_envelope_ok", True))
    return gate


# -- convergence-parity smoke (the CI gate) ----------------------------------


def _local_rows(batch: dict, device: str | torch.device = "cpu") -> dict:
    """This rank's contiguous share of a global numpy batch, as tensors
    on ``device``."""
    w, r = distributed.world_size(), distributed.rank()
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // w
        out[k] = torch.from_numpy(
            np.ascontiguousarray(v[r * n:(r + 1) * n])).to(device)
    return out


def _smoke_cnn(world: int, device: str | torch.device = "cuda"):
    """Tiny BN CNN on separable synthetic images (the JAX package's
    data, the port's seeded init), its model on ``device``. Returns
    (loss_fn, state_fn, global numpy batch)."""
    from edl_tpu_torch.models.resnet import ResNetTiny
    from edl_tpu_torch.train import classification as cls
    from edl_tpu_torch.train import state as state_lib

    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    n, hw, classes = 8 * world, 16, 4
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    # class-colored images + noise: learnable in a few dozen steps
    images = (rng.normal(0, 0.3, size=(n, hw, hw, 3))
              + labels[:, None, None, None] / classes).astype(np.float32)

    def state_fn():
        model = ResNetTiny(num_classes=classes, dtype=torch.float32,
                           device=dev, seed=0)
        return cls.create_state(model, state_lib.sgd(0.05, momentum=0.9))

    def loss_fn(model, batch):
        model.train()
        logits = model(batch["image"])
        targets = cls.smoothed_labels(batch["label"], classes, 0.0)
        return cls.soft_cross_entropy(logits, targets), {}

    return loss_fn, state_fn, {"image": images, "label": labels}


def _smoke_transformer(world: int, device: str | torch.device = "cuda"):
    """Tiny Markov-LM transformer: the no-BN model (the JAX package's
    data, the port's seeded init), on ``device``. Returns (loss_fn,
    state_fn, global numpy batch)."""
    from edl_tpu_torch.bridge import flax_named_parameters
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lm_loss_fn)
    from edl_tpu_torch.train import state as state_lib
    from edl_tpu_torch.train.state import TrainState

    dev = resolve_device(device)
    vocab, seq = 32, 16
    gen = np.random.default_rng(11)
    successors = gen.integers(0, vocab, size=(vocab, 4))
    toks = np.empty((4 * world, seq), np.int32)
    toks[:, 0] = gen.integers(0, vocab, size=4 * world)
    for t in range(1, seq):
        pick = gen.integers(0, 4, size=4 * world)
        toks[:, t] = successors[toks[:, t - 1], pick]
    cfg = TransformerConfig(vocab_size=vocab, d_model=32, n_heads=2,
                            n_layers=2, d_ff=64, max_len=seq,
                            dtype=torch.float32)

    def state_fn():
        model = Transformer(cfg, device=dev, seed=0)
        # momentum-SGD: the optimizer the error-feedback analysis is for
        return TrainState.create(model=model,
                                 tx=state_lib.sgd(0.5, momentum=0.9),
                                 params=flax_named_parameters(model))

    return lm_loss_fn, state_fn, {"tokens": toks}


def _loaded(state_fn: Callable, state_dict: dict) -> Callable:
    """``state_fn`` with its model's weights replaced by ``state_dict``."""
    def loaded():
        state = state_fn()
        state.model.load_state_dict(state_dict)
        return state
    return loaded


def convergence_smoke(compress: str = "topk", steps: int = 40,
                      envelope: float = 0.25, topology=None,
                      weights: dict | None = None,
                      device: str | torch.device = "cuda") -> dict:
    """CNN + transformer convergence smokes over the joined world: train
    the compressed path against the dense per-leaf reference from the
    same init; both must LEARN (final loss below initial) and the
    compressed run must keep at least ``1 - envelope`` of the
    reference's improvement (|dense - compressed| <= envelope x
    (initial - dense), a RELATIVE envelope). The topk wire runs at 1/8
    density. ``weights`` ({"cnn": state_dict, "transformer": state_dict})
    replaces the port's seeded init, e.g. with the JAX package's bridged
    one. The models and batches live on ``device`` (CUDA unless the
    caller asks for the CPU; raises where CUDA is asked for and absent).
    Returns the report; ``ok`` only if every gate holds."""
    dev = resolve_device(device)
    world = distributed.world_size()
    report: dict = {"compress": compress, "steps": steps,
                    "envelope": envelope, "world": world,
                    "n_slices": topology.n_slices if topology else 1}
    config = CommConfig(bucket_mb=0.25, compress=compress, topk_frac=0.125,
                        min_compress_elems=64)

    def run(name, loss_fn, state_fn, batch):
        batch = _local_rows(batch, dev)
        if weights is not None:
            state_fn = _loaded(state_fn, weights[name])
        ref = _PerLeafStep(loss_fn, config=dataclasses.replace(
            config, compress="off"), topology=topology)
        comp = make_comm_train_step(loss_fn, config=config,
                                    topology=topology)
        s_a, s_b = state_fn(), state_fn()
        first = last_a = last_b = None
        for _ in range(steps):
            s_a, m_a = ref(s_a, batch)
            s_b, m_b = comp(s_b, batch)
            if first is None:
                first = float(m_a["loss"])
            last_a, last_b = float(m_a["loss"]), float(m_b["loss"])
        delta = abs(last_a - last_b)
        improvement = max(first - last_a, 1e-9)
        report[name] = {
            "loss_initial": round(first, 4),
            "loss_dense": round(last_a, 4),
            "loss_compressed": round(last_b, 4),
            "delta": round(delta, 5),
            "delta_rel": round(delta / improvement, 5),
            "learned": last_a < first and last_b < first,
            "within_envelope": delta <= envelope * improvement}

    run("cnn", *_smoke_cnn(world, dev))
    run("transformer", *_smoke_transformer(world, dev))
    report["ok"] = all(report[k]["learned"] and report[k]["within_envelope"]
                       for k in ("cnn", "transformer"))
    return report


# -- MoE dispatch gates -------------------------------------------------------


def moe_parity_gate(loss_factory: Callable, state_fn: Callable, batch, *,
                    mesh, moe_config: MoEDispatchConfig | None = None,
                    comm_config: CommConfig | None = None,
                    topology=None, steps: int = 3,
                    envelope: float = 0.1) -> dict:
    """The gate on the dispatch wire.

    1. hier uncompressed vs the flat single collective: identical
       parameters AND per-step losses after ``steps`` steps, bit for bit
       (``bitwise_hier``: the decomposition is a permutation).
    2. if ``moe_config.compress != 'off'``: the compressed path's
       per-step loss stays within ``envelope`` of flat's
       (``loss_envelope_ok`` / ``max_loss_delta``). int8 here rides
       activations, with no error feedback.

    Both arms are MoECommStep instances, each training a fresh state from
    ``state_fn()``; ``batch`` is this rank's rows.
    """
    moe_config = moe_config or MoEDispatchConfig()

    def run(mcfg):
        step = MoECommStep(loss_factory, mesh=mesh, config=comm_config,
                           moe_config=mcfg, topology=topology)
        s, losses = state_fn(), []
        for _ in range(steps):
            s, m = step(s, batch)
            losses.append(float(m["loss"]))
        return s, losses

    s_flat, l_flat = run(MoEDispatchConfig(mode="flat"))
    s_hier, l_hier = run(MoEDispatchConfig(mode="hier"))
    gate = {"bitwise_hier": tree_bitwise_equal(
                [p for _, p in s_flat.params], [p for _, p in s_hier.params])
            and l_flat == l_hier,
            "hier_loss_delta": max(abs(a - b)
                                   for a, b in zip(l_flat, l_hier)),
            "envelope": envelope, "steps": steps}
    if moe_config.compress != "off":
        _, l_comp = run(moe_config)
        deltas = [abs(a - b) for a, b in zip(l_flat, l_comp)]
        gate["max_loss_delta"] = max(deltas)
        gate["loss_envelope_ok"] = max(deltas) <= envelope
    gate["ok"] = bool(gate["bitwise_hier"]
                      and gate.get("loss_envelope_ok", True))
    return gate


def _smoke_moe(world: int, device: str | torch.device = "cuda"):
    """Tiny MoE Markov-LM (the JAX package's data, the port's seeded
    init), on ``device``. Returns ``(loss_factory, dense_loss, state_fn,
    global numpy batch)``: the factory wires the loss for the manual
    step; the dense loss runs the einsum dispatch over every expert."""
    import functools

    from edl_tpu_torch.bridge import flax_named_parameters
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lm_loss_moe)
    from edl_tpu_torch.train import state as state_lib
    from edl_tpu_torch.train.state import TrainState

    dev = resolve_device(device)
    vocab, seq = 32, 16
    gen = np.random.default_rng(23)
    successors = gen.integers(0, vocab, size=(vocab, 4))
    toks = np.empty((4 * world, seq), np.int32)
    toks[:, 0] = gen.integers(0, vocab, size=4 * world)
    for t in range(1, seq):
        pick = gen.integers(0, 4, size=4 * world)
        toks[:, t] = successors[toks[:, t - 1], pick]
    cfg = TransformerConfig(vocab_size=vocab, d_model=32, n_heads=2,
                            n_layers=2, d_ff=64, max_len=seq,
                            dtype=torch.float32, moe=True,
                            n_experts=2 * world, moe_top_k=2)

    def state_fn():
        model = Transformer(cfg, device=dev, seed=0)
        model.train()
        return TrainState.create(model=model,
                                 tx=state_lib.sgd(0.5, momentum=0.9),
                                 params=flax_named_parameters(model))

    def loss_factory(wire):
        return functools.partial(lm_loss_moe, aux_weight=cfg.moe_aux_weight,
                                 wire=wire)

    dense_loss = functools.partial(lm_loss_moe,
                                   aux_weight=cfg.moe_aux_weight)
    return loss_factory, dense_loss, state_fn, {"tokens": toks}


def moe_convergence_smoke(compress: str = "int8", steps: int = 40,
                          envelope: float = 0.25, topology=None,
                          device: str | torch.device = "cuda") -> dict:
    """The MoE convergence smoke (``smoke --moe``): train the
    hierarchical, compressed dispatch against the uncompressed flat one
    from the same init. Both must learn, and the compressed run must keep
    at least ``1 - envelope`` of the baseline's improvement (signed: only
    a compressed run that ends worse by more than ``envelope x
    improvement`` fails). The bit-for-bit parity gate runs first; a red
    gate fails the smoke. ``jit_loss_final`` is the dense dispatch over
    every expert on the whole global batch (the JAX package's jit path,
    which routes the global batch at the global capacity), trained on
    every rank alike; it is reported, not gated."""
    from edl_tpu_torch.train.step import make_train_step

    dev = resolve_device(device)
    world = distributed.world_size()
    spec = mesh_lib.MeshSpec({"ep": -1})
    mesh = (mesh_lib.make_hybrid_mesh(spec, topology)
            if topology is not None and topology.is_multi_slice
            else mesh_lib.make_mesh(spec))
    loss_factory, dense_loss, state_fn, batch = _smoke_moe(world, dev)
    local = _local_rows(batch, dev)
    comm_cfg = CommConfig(bucket_mb=0.25)

    gate = moe_parity_gate(
        loss_factory, state_fn, local, mesh=mesh, topology=topology,
        comm_config=comm_cfg,
        moe_config=MoEDispatchConfig(mode="hier", compress=compress))

    def run(mcfg):
        step = MoECommStep(loss_factory, mesh=mesh, config=comm_cfg,
                           moe_config=mcfg, topology=topology)
        s = state_fn()
        first = last = None
        for _ in range(steps):
            s, m = step(s, local)
            if first is None:
                first = float(m["loss"])
            last = float(m["loss"])
        return first, last, step

    first, dense_last, _ = run(MoEDispatchConfig(mode="flat"))
    _, comp_last, comp_step = run(
        MoEDispatchConfig(mode="hier", compress=compress))

    jit_step = make_train_step(dense_loss)
    whole = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    s_jit = state_fn()
    jit_last = None
    for _ in range(steps):
        s_jit, m = jit_step(s_jit, whole)
        jit_last = float(m["loss"])

    delta = comp_last - dense_last  # signed: + = compression cost
    improvement = max(first - dense_last, 1e-9)
    report = {
        "compress": compress, "steps": steps, "envelope": envelope,
        "world": world,
        "n_slices": topology.n_slices if topology else 1,
        "parity_gate": gate,
        "loss_initial": round(first, 4),
        "loss_dense": round(dense_last, 4),
        "loss_compressed": round(comp_last, 4),
        "jit_loss_final": round(jit_last, 4),
        "delta": round(delta, 5),
        "delta_rel": round(delta / improvement, 5),
        "learned": dense_last < first and comp_last < first,
        "within_envelope": delta <= envelope * improvement,
        "moe_dcn_bytes_per_step": comp_step.moe_dcn_bytes_per_step(),
        "moe_dispatch_overlap_pct":
            comp_step.moe_dispatch_overlap_pct()}
    report["ok"] = bool(gate["ok"] and report["learned"]
                        and report["within_envelope"])
    return report


def _main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="edl_tpu_torch.train.comm")
    sub = parser.add_subparsers(dest="cmd", required=True)
    smoke = sub.add_parser(
        "smoke", help="convergence-parity smoke: compressed DCN leg vs "
                      "the dense reference on the CNN + transformer tinies")
    smoke.add_argument("--compress", choices=("topk", "int8"),
                       default=None,
                       help="DCN wire format (default: topk; int8 "
                            "with --moe, which has no topk wire)")
    smoke.add_argument("--moe", action="store_true",
                       help="run the MoE dispatch smoke (hier+int8 "
                            "all-to-all vs the flat/off manual "
                            "baseline, bit-for-bit parity gate first) "
                            "instead of the gradient-wire smokes")
    smoke.add_argument("--steps", type=int, default=40)
    smoke.add_argument("--envelope", type=float, default=0.25,
                       help="RELATIVE loss envelope: the compressed "
                            "run must keep >= 1-envelope of dense's "
                            "loss improvement")
    smoke.add_argument("--slices", type=int, default=2,
                       help="emulated slice count (1 = flat dp)")
    smoke.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    compress = args.compress or ("int8" if args.moe else "topk")
    if args.moe and compress == "topk":
        raise SystemExit("--moe supports --compress int8 only "
                         "(token blocks have no sparse wire)")
    device = resolve_device(args.device)
    env = distributed.init_from_env(device=device)
    device = distributed.rank_device(device, max(0, env.rank))
    world = distributed.world_size()
    topo = None
    if args.slices > 1:
        if world % args.slices:
            raise SystemExit(f"{world} devices not divisible by "
                             f"--slices {args.slices}")
        topo = mesh_lib.SliceTopology(args.slices, world // args.slices)
    if args.moe:
        report = moe_convergence_smoke(compress=compress, steps=args.steps,
                                       envelope=args.envelope,
                                       topology=topo, device=device)
        print(json.dumps({"moe_smoke": report}))
        distributed.shutdown()
        return 0 if report["ok"] else 1
    report = convergence_smoke(compress=compress,
                               steps=args.steps, envelope=args.envelope,
                               topology=topo, device=device)
    print(json.dumps({"comm_smoke": report}))
    distributed.shutdown()
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(_main())
