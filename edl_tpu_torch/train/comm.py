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

The MoE dispatch (``MoEDispatchConfig``, ``moe_all_to_all``, ``MoEWire``,
``MoECommStep`` and its gates) comes with ROADMAP Queue 1 item 14, DGC
with item 11.
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
from edl_tpu_torch.ops.pack import all_gather_packed, pack_int8_buckets
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
    if distributed.world_size() == 1:
        return
    tensors = (list(model.buffers()) if average
               else list(model.parameters()) + list(model.buffers()))
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
