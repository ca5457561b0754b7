"""Process-based loader worker pool with shared-memory batch hand-off
(port of ``edl_tpu.data.mp_loader``).

Scales the host input plane past the GIL: N forked worker processes
each pull batch descriptors `(step, indices, pre-assigned per-sample RNG
seeds, batch-transform seed)` from their task queue, run source fetch +
sample/batch transforms (cv2 decode, crop, flip — the CPU-bound stage),
collate straight into a preallocated shared-memory slot
(data/shm_ring.py), and answer with a tiny metadata message.  The
parent reassembles results STRICTLY in step order and yields zero-copy
`np.ndarray` views over the slots — pixel bytes are written once by the
worker and read once by the consumer; no pickle, no extra copy.  This
is the multi-worker double-buffered feed of the reference's DALI reader
stack (example/collective/resnet50/dali.py) rebuilt for the
deterministic elastic contract.

Determinism: every random draw a step needs is made by the PARENT from
the per-(epoch, rank) generator before dispatch (DataLoader's per-step
seed protocol, data/pipeline.py), so worker scheduling cannot change
the stream — the mp path is bit-identical to the inline path, and an
elastic stop-resume replays the identical order from the step cursor.

Robustness contract:
- a dead/killed worker's in-flight descriptors are re-dispatched
  exactly ONCE to surviving workers (attempt-tagged: late messages from
  the corpse are ignored, the redispatched attempt owns the slot);
- a second death of the same descriptor, or the death of every worker,
  raises `EdlDataError` instead of hanging;
- a poisoned sample (transform/source exception) surfaces the worker's
  traceback on the consumer side at that step's turn, in order;
- each worker answers on its own result queue: a multiprocessing queue
  shares one write lock among its writers, so a worker SIGKILLed while
  its feeder thread holds that lock would wedge every survivor's
  answers on a shared queue (the JAX package's design can hang so);
  the parent reads only the queues of live workers;
- `close()` (also driven by `DataLoader.close()`, context-manager exit
  and GC via `weakref.finalize`) joins the workers and unlinks every
  shm segment — abandoning an epoch iterator mid-epoch first drains
  in-flight slots so no worker is left writing into reclaimed memory.

Workers are started with the `fork` method so sources and transform
closures need no pickling (the reference's reader closures aren't
picklable either). The pool forks lazily, at the first batch, after the
model is on the card: a worker runs numpy (and cv2, its threading pinned
off in data/image.py) only, never torch, so it never touches the CUDA
context it inherits (a child that did would fail with "Cannot
re-initialize CUDA in forked subprocess", or deadlock on an inherited
lock).
"""

from __future__ import annotations

import collections
import queue
import signal
import time
import traceback
from typing import Callable, Sequence

import multiprocessing as mp
from multiprocessing import connection

import numpy as np

from edl_tpu_torch.data import shm_ring
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.exceptions import EdlDataError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.data.mp_loader")

# Descriptor: (step, idx, sample_seeds | None, batch_seed | None)
Descriptor = tuple

_DRAIN_TIMEOUT = 30.0
_POLL = 0.05


class _WorkerEnv:
    """Everything a worker needs, inherited through fork (not pickled)."""

    def __init__(self, source, sample_transforms, transforms, ring,
                 task_qs, result_qs, stop, emit_seed=False):
        self.source = source
        self.sample_transforms = sample_transforms
        self.transforms = transforms
        self.ring = ring
        self.task_qs = task_qs
        self.result_qs = result_qs
        self.stop = stop
        self.emit_seed = emit_seed


def _worker_main(env: _WorkerEnv, wid: int) -> None:
    # The parent owns ctrl-C: a KeyboardInterrupt mid-slot-write would
    # look like a poisoned sample instead of a clean shutdown.
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    # materialize_batch lives in pipeline.py (shared with the inline
    # path — the determinism contract is one function, not two copies).
    from edl_tpu_torch.data.pipeline import materialize_batch

    task_q = env.task_qs[wid]
    result_q = env.result_qs[wid]
    while True:
        try:
            task = task_q.get(timeout=0.2)
        except queue.Empty:
            if env.stop.is_set():
                return
            continue
        if task is None:
            return
        step, attempt, slot, idx, sseeds, bseed = task
        try:
            batch = materialize_batch(env.source, idx,
                                      env.sample_transforms,
                                      env.transforms, sseeds, bseed,
                                      emit_seed=env.emit_seed)
            meta = shm_ring.write_batch(env.ring.buf(slot), batch)
            # meta=None: batch outgrew the slot (shape drift after the
            # sizing probe) — ship it pickled rather than fail; the
            # parent logs the slow path.
            spill = None if meta is not None else batch
            result_q.put((wid, step, attempt, slot, meta, spill, None))
        except BaseException:  # noqa: BLE001 — surfaced at the consumer
            result_q.put((wid, step, attempt, slot, None, None,
                              traceback.format_exc()))


class _Pending:
    __slots__ = ("desc", "wid", "attempt", "slot")

    def __init__(self, desc, wid, attempt, slot):
        self.desc = desc
        self.wid = wid
        self.attempt = attempt
        self.slot = slot


class MpLoaderPool:
    """Worker pool + shm ring; reused across epochs by one DataLoader.

    Args:
      source: the loader's source (fork-inherited; each worker keeps its
        own shard cache if the source has one).
      sample_transforms / transforms: the loader's transform stacks.
      num_workers: pool width (>= 1).
      slot_bytes: bytes one collated batch needs (size with a probe
        batch via `shm_ring.batch_nbytes`).
      n_slots: ring depth; default 2*workers+2 keeps every worker busy
        with one task queued each plus reorder slack.
      emit_seed: attach each descriptor's batch seed to its batch as a
        0-d uint32 "augment_seed" (the device-augmentation hand-off —
        DataLoader.emit_batch_seed).
    """

    def __init__(self, source, sample_transforms: Sequence[Callable],
                 transforms: Sequence[Callable], num_workers: int,
                 slot_bytes: int, n_slots: int | None = None,
                 emit_seed: bool = False):
        if num_workers < 1:
            raise EdlDataError(f"num_workers must be >= 1, got {num_workers}")
        n_slots = n_slots or 2 * num_workers + 2
        try:
            ctx = mp.get_context("fork")
        except ValueError as exc:  # pragma: no cover - non-POSIX hosts
            raise EdlDataError(
                "mp loader needs the fork start method (POSIX)") from exc
        self.ring = shm_ring.ShmRing(slot_bytes, n_slots)
        self._stop = ctx.Event()
        self._task_qs = [ctx.Queue() for _ in range(num_workers)]
        self._result_qs = [ctx.Queue() for _ in range(num_workers)]
        env = _WorkerEnv(source, list(sample_transforms), list(transforms),
                         self.ring, self._task_qs, self._result_qs,
                         self._stop, emit_seed=emit_seed)
        self._procs = [ctx.Process(target=_worker_main, args=(env, wid),
                                   daemon=True,
                                   name=f"edl-mp-loader-{wid}")
                       for wid in range(num_workers)]
        for p in self._procs:
            p.start()
        self._alive = set(range(num_workers))
        self._free: collections.deque[int] = collections.deque(
            range(n_slots))
        self.closed = False
        self.broken = False  # wedged drain: next epoch rebuilds the pool
        # input-plane accounting (consumer-thread-only counters; the
        # obs registry reads them as a scrape-time view)
        self.batches_served = 0
        self.redispatches = 0
        self.spills = 0
        self._obs = obs_metrics.register_stats("mp_loader", self.stats)

    def stats(self) -> dict:
        """Pool counters as a dict view (obs registry source)."""
        return {"workers": len(self._procs),
                "workers_alive": len(self._alive),
                "batches_served": self.batches_served,
                "redispatches": self.redispatches,
                "slot_spills": self.spills,
                "slots_free": len(self._free),
                "broken": self.broken}

    # -- liveness ----------------------------------------------------------

    def _check_workers(self, pending: dict[int, _Pending],
                       outstanding: dict[int, int],
                       redispatch: bool) -> None:
        """Detect deaths; re-dispatch (exactly once) or reclaim slots."""
        died = [wid for wid in self._alive
                if not self._procs[wid].is_alive()]
        if not died:
            return
        for wid in died:
            self._alive.discard(wid)
            log.warning("loader worker %d died (exitcode=%s)", wid,
                        self._procs[wid].exitcode)
        for step, pend in list(pending.items()):
            if pend.wid not in died:
                continue
            if not redispatch:
                # drain path: nobody will write this slot again
                self._free.append(pend.slot)
                outstanding.pop(step, None)
                del pending[step]
                continue
            if pend.attempt >= 1:
                raise EdlDataError(
                    f"loader batch {step} lost twice: worker {pend.wid} "
                    "died re-running a descriptor from an earlier dead "
                    "worker")
            if not self._alive:
                raise EdlDataError(
                    "all loader workers died; cannot re-dispatch "
                    f"in-flight batch {step}")
            pend.attempt += 1
            pend.wid = self._least_loaded(outstanding)
            self.redispatches += 1
            outstanding[step] = pend.wid
            step_, idx, sseeds, bseed = pend.desc
            self._task_qs[pend.wid].put(
                (step_, pend.attempt, pend.slot, idx, sseeds, bseed))
            log.warning("re-dispatched batch %d to worker %d", step,
                        pend.wid)

    def _least_loaded(self, outstanding: dict[int, int]) -> int:
        loads = collections.Counter(outstanding.values())
        return min(self._alive, key=lambda w: loads[w])

    # -- the ordered map ---------------------------------------------------

    def imap(self, descs: Sequence[Descriptor]):
        """Yield the batch of each descriptor, strictly in `descs` order.

        Yielded batches are zero-copy views over the ring; each stays
        valid until the NEXT yield (when its slot is recycled) — copy
        (or place it, as prefetch_to_device does) before advancing if a
        batch must outlive that.
        """
        if self.closed or self.broken:
            raise EdlDataError("mp loader pool is closed")
        todo = collections.deque(descs)
        pending: dict[int, _Pending] = {}
        outstanding: dict[int, int] = {}  # step -> wid (for load counts)
        results: dict[int, tuple] = {}
        order = collections.deque(d[0] for d in descs)
        prev_slot: int | None = None
        try:
            while order:
                # keep every free slot dispatched ahead of the consumer
                while todo and self._free and self._alive:
                    desc = todo.popleft()
                    slot = self._free.popleft()
                    wid = self._least_loaded(outstanding)
                    pending[desc[0]] = _Pending(desc, wid, 0, slot)
                    outstanding[desc[0]] = wid
                    step, idx, sseeds, bseed = desc
                    self._task_qs[wid].put((step, 0, slot, idx, sseeds,
                                            bseed))
                head = order[0]
                if head in results:
                    order.popleft()
                    slot, meta, spill, err = results.pop(head)
                    if prev_slot is not None:
                        self._free.append(prev_slot)
                        prev_slot = None
                    if err is not None:
                        self._free.append(slot)
                        raise EdlDataError(
                            f"loader worker failed on batch {head}:\n{err}")
                    self.batches_served += 1
                    if meta is None:
                        self._free.append(slot)  # spilled over the queue
                        self.spills += 1
                        yield spill
                    else:
                        prev_slot = slot
                        yield shm_ring.read_batch(self.ring.buf(slot),
                                                  meta)
                    continue
                self._pump(pending, outstanding, results, redispatch=True)
                if not self._alive and head not in results \
                        and head not in pending:
                    # head never dispatched and nobody left to take it
                    raise EdlDataError("all loader workers died")
        finally:
            if prev_slot is not None:
                self._free.append(prev_slot)
            # accepted-but-unyielded results (consumer closed early)
            # still own their slots
            for slot, _meta, _spill, _err in results.values():
                self._free.append(slot)
            results.clear()
            self._drain(pending, outstanding)

    def _pump(self, pending, outstanding, results, *, redispatch,
              timeout: float = _POLL) -> None:
        """Absorb one completion (or time out and check liveness)."""
        # a Queue's read end (CPython's `_reader`) is what
        # connection.wait multiplexes; a dead worker's queue is not read
        readers = {self._result_qs[w]._reader: w for w in self._alive}
        ready = connection.wait(list(readers), timeout)
        try:
            if not ready:
                raise queue.Empty
            wid, step, attempt, slot, meta, spill, err = \
                self._result_qs[readers[ready[0]]].get_nowait()
        except queue.Empty:
            self._check_workers(pending, outstanding, redispatch)
            return
        pend = pending.get(step)
        if pend is None or attempt != pend.attempt:
            # late echo from a dead worker's attempt (the redispatched
            # attempt owns the slot) — or a drain already reclaimed it
            return
        del pending[step]
        outstanding.pop(step, None)
        results[step] = (slot, meta, spill, err)
        if spill is not None:
            log.warning("batch %d outgrew its shm slot; shipped over "
                        "the queue (slow path)", step)

    def _drain(self, pending, outstanding) -> None:
        """Wait out in-flight work so every slot is reclaimed.

        Runs on normal epoch end AND when the consumer abandons the
        iterator mid-epoch (stop-resume): a worker may be mid-write, so
        slots cannot be recycled until its completion lands. A wedged
        worker trips the deadline; the pool is then torn down (killed,
        unlinked) and marked broken — the next epoch builds a fresh one.
        """
        deadline = time.monotonic() + _DRAIN_TIMEOUT
        while pending and time.monotonic() < deadline:
            results: dict[int, tuple] = {}
            try:
                self._pump(pending, outstanding, results, redispatch=False)
            except EdlDataError:  # worker died while draining
                continue
            for slot, _meta, _spill, _err in results.values():
                self._free.append(slot)
        if pending:
            log.error("mp loader drain timed out with %d batches in "
                      "flight; rebuilding the pool", len(pending))
            self.broken = True
            self.close()

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Stop workers (join, escalate to kill) and unlink the ring."""
        if self.closed:
            return
        self.closed = True
        self._stop.set()
        for q in self._task_qs:
            try:
                q.put_nowait(None)
            except Exception:  # noqa: BLE001 — teardown is best effort
                pass
        for p in self._procs:
            p.join(timeout=5.0)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
            if p.is_alive():  # pragma: no cover - SIGTERM ignored
                p.kill()
                p.join(timeout=2.0)
        for q in [*self._task_qs, *self._result_qs]:
            q.close()
            # don't let a queue feeder thread block interpreter exit
            q.cancel_join_thread()
        self.ring.close()
        obs_metrics.unregister(self._obs)


def default_num_workers() -> int:
    """The `EDL_TPU_LOADER_WORKERS` env contract (0 = inline/threaded)."""
    return max(0, config.env_int("EDL_TPU_LOADER_WORKERS", 0))


def probe_slot_bytes(batch: dict[str, np.ndarray]) -> int:
    """Ring slot size for a probe batch (re-exported for DataLoader)."""
    return shm_ring.batch_nbytes(batch)
