"""Ring of preallocated shared-memory batch slots for the mp loader
(copy of ``edl_tpu.data.shm_ring``).

The hand-off half of the multi-process input plane (data/mp_loader.py):
worker processes write collated batches straight into a slot's mapping
and send only a tiny (key, shape, dtype, offset) descriptor back over
the result queue — pixel bytes never ride a pipe and never get pickled.
The parent wraps the slot in `np.ndarray` views (zero-copy) and recycles
the slot once the consumer has moved past the batch.

Slots are plain `multiprocessing.shared_memory` segments sized for one
collated batch each.  The ring is created by the PARENT before the
workers fork, so children inherit the mappings directly; only the
parent ever `unlink()`s.  `close()` is idempotent and tolerates live
numpy views (the consumer may still hold the last batch): the mapping
then stays alive until those views die, but the /dev/shm name is gone —
teardown never leaks a segment.
"""

from __future__ import annotations

import itertools
import os
from multiprocessing import shared_memory

import numpy as np

_ring_ids = itertools.count()

# 64-byte alignment for every array inside a slot: keeps rows cache-line
# aligned and lets downstream consumers (device DMA, vectorized numpy)
# treat views like freshly allocated buffers.
_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def batch_nbytes(batch: dict[str, np.ndarray]) -> int:
    """Aligned bytes one slot needs to hold `batch` (the sizing probe)."""
    return sum(_align(np.asarray(v).nbytes) for v in batch.values())


def _view(buf, shape, dtype, offset) -> np.ndarray:
    # np.frombuffer (NOT np.ndarray(buffer=...)): frombuffer registers a
    # real buffer export on the memoryview, so SharedMemory.close() with
    # a live view raises BufferError instead of silently unmapping the
    # pages under it (a segfault on next read). ShmRing.close() catches
    # that and lets the mapping die with the last view.
    dtype = np.dtype(dtype)
    count = int(np.prod(shape)) if shape else 1
    return np.frombuffer(buf, dtype, count=count,
                         offset=offset).reshape(shape)


def write_batch(buf, batch: dict[str, np.ndarray]
                ) -> list[tuple[str, tuple[int, ...], str, int]] | None:
    """Write `batch` into a slot buffer; returns the view metadata
    [(key, shape, dtype.str, offset)] or None if the batch does not fit
    (the caller falls back to shipping it over the queue)."""
    offset = 0
    meta = []
    cap = len(buf)
    for k in sorted(batch):
        # ascontiguousarray only when needed: it promotes 0-d to (1,)
        # (the device-augment seed is a 0-d uint32 and must round-trip
        # shape-intact — same guard as tensor_wire.send_tensors)
        arr = np.asarray(batch[k])
        if not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)
        if offset + arr.nbytes > cap:
            return None
        _view(buf, arr.shape, arr.dtype, offset)[...] = arr
        meta.append((k, arr.shape, arr.dtype.str, offset))
        offset = _align(offset + arr.nbytes)
    return meta


def read_batch(buf, meta) -> dict[str, np.ndarray]:
    """Zero-copy np.ndarray views over a slot from `write_batch` meta.

    Views alias the slot: they are valid until the slot is recycled
    (i.e. until the consumer advances past this batch) — copy if kept.
    """
    return {k: _view(buf, shape, dtype, off)
            for k, shape, dtype, off in meta}


class ShmRing:
    """N preallocated shared-memory slots, parent-owned.

    The parent creates the ring before forking workers; slot acquisition
    / recycling is the parent's job (mp_loader tracks which slot each
    dispatched descriptor owns), so the ring itself is just storage +
    teardown.
    """

    def __init__(self, slot_bytes: int, n_slots: int):
        if slot_bytes <= 0 or n_slots <= 0:
            raise ValueError(f"bad ring: {n_slots} x {slot_bytes}B")
        self.slot_bytes = _align(slot_bytes)
        self.slots: list[shared_memory.SharedMemory] = []
        rid = next(_ring_ids)
        try:
            for i in range(n_slots):
                self.slots.append(shared_memory.SharedMemory(
                    create=True, size=self.slot_bytes,
                    name=f"edl_mp_{os.getpid()}_{rid}_{i}"))
        except BaseException:
            self.close()
            raise
        self._closed = False

    def __len__(self) -> int:
        return len(self.slots)

    def buf(self, slot: int):
        return self.slots[slot].buf

    def close(self) -> None:
        """Unlink every segment (idempotent; safe with live views).

        unlink() removes the /dev/shm name immediately — the memory
        itself lives until the last mapping (parent views, worker
        processes) drops, so consumers holding the final batch keep
        valid data while the leak-check surface stays clean.
        """
        for shm in self.slots:
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
            try:
                shm.close()
            except BufferError:
                # A consumer still holds a zero-copy view over this
                # slot. The unlink above already dropped the name; hand
                # the mapping's lifetime to the view chain (the mmap
                # unmaps when the last view dies) and close the fd now —
                # leaving close() to retry in __del__ would just raise
                # the same BufferError unraisably at GC.  The surgery
                # pokes SharedMemory privates whose names/layout drift
                # across CPython versions, so any miss degrades to
                # leaving teardown to the view chain (nothing leaks:
                # the /dev/shm name is gone), never to a crash.
                try:
                    fd = shm._fd
                    shm._buf = None
                    shm._mmap = None
                    if isinstance(fd, int) and fd >= 0:
                        os.close(fd)
                        shm._fd = -1
                except (AttributeError, OSError):
                    pass
        self._closed = True
