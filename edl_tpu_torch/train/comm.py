"""Bucket planning over a parameter list (trimmed port of
``edl_tpu.train.comm``: ``BucketPlan``, ``plan_buckets``,
``pack_buckets`` and ``unpack_buckets``).

The fused optimizer packs parameters into the same flat, dtype-grouped,
padded buckets as the JAX package, so a bucket holds the same leaves on
both sides: the quantized moments (ROADMAP Queue 1 item 7) keep one
scale per bucket. The leaf order is the order of the tensor list given,
and for the transformer that is the flax flatten order (sorted keys),
from ``edl_tpu_torch.bridge.flax_named_parameters``. Everything else of the
JAX module (the comm train step, compressed and hierarchical
reductions, DGC) waits for ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


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
        itemsize = torch.empty((), dtype=dtype).element_size()

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
