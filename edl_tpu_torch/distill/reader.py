"""DistillReader: wrap a data reader, append teacher predictions (port of
``edl_tpu.distill.reader``; the same pipeline, invariants and wire).

The user-facing distill API — capability of the reference's DistillReader +
distill_worker pipeline (distill/distill_reader.py:68,313-374,
distill_worker.py:57-167,318-448,656-781), redesigned for the TPU host:

- the reference forks a reader process + N predict processes (Paddle's
  serving client demands it); our data plane is raw sockets + numpy, which
  release the GIL, so the pipeline is ONE process with a reader thread, a
  worker thread per assigned teacher, and a manage thread — same
  concurrency, no pickling/IPC tax, and the student's JAX dispatch thread
  is unaffected (here: the student's CUDA launch thread).

Invariants (the reference's poison-pill/exactly-once contract, proven in
tests/test_distill_reader.py under teacher kill/join):

  D1. every yielded batch carries predictions for exactly its own rows, in
      row order (out-of-order teacher replies are re-assembled by task id);
  D2. batches are yielded in reader order;
  D3. a teacher failure re-queues its in-flight tasks (bounded retries);
      nothing is lost or duplicated across teacher churn — with request
      pipelining (r6) a worker may own up to ``pipeline_depth`` tasks on
      one connection, and a mid-flight death re-queues every one of them
      exactly once;
  D4. the epoch terminates exactly when every sliced task has been served
      (feed-count == serve-count accounting, the poison-pill role);
  D5. backpressure: at most ``(pipeline_depth+1)*teachers + 2`` tasks in
      flight;
  D6. liveness: if NO connected teacher serves a task for
      ``deadman_timeout`` seconds while work is outstanding AND some
      teacher is known-dead, the epoch raises EdlDistillError naming the
      dead teachers — a permanently connect-refusing fixed teacher fails
      fast instead of hanging (the reference hangs in exactly this
      case). A discovery pool that is legitimately empty (scale-to-zero)
      keeps waiting for the balancer to reassign.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

import numpy as np

from edl_tpu_torch.distill.teacher_server import TeacherClient, TeacherRejected
from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.backoff import Backoff
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger
from edl_tpu_torch.utils.timeline import timeline

log = get_logger("edl_tpu_torch.distill.reader")


class EdlDistillError(EdlError):
    pass


@dataclass
class Task:
    task_id: int
    batch_id: int
    part: int            # slice index within the batch
    feeds: dict
    rows: int
    retries: int = 0
    # admission-shed rejections are accounted SEPARATELY from
    # connection-death retries: a shed is the pool saying "later", not
    # a fault, so it gets its own (larger) bounded budget
    shed_retries: int = 0


@dataclass
class _Batch:
    batch: dict
    n_parts: int = 0
    parts: dict = field(default_factory=dict)   # part -> predictions dict
    complete: bool = False


class _NopTeacherClient:
    """Fake teacher for tests/offline smoke (the reference's
    ``_NOP_PREDICT_TEST`` trick, distill_worker.py:34-42,306-315): runs the
    ENTIRE pipeline — slicing, workers, reordering, churn — with zero
    network. Predictions are zeros of shape (rows, dim) per predict name."""

    def __init__(self, endpoint: str, predicts: tuple[str, ...],
                 dim: int = 1, delay: float = 0.0):
        self.endpoint = endpoint
        self.predicts = predicts
        self.dim = dim
        self.delay = delay

    def predict(self, feeds: dict) -> dict:
        if self.delay:
            time.sleep(self.delay)
        rows = next(iter(feeds.values())).shape[0]
        return {name: np.zeros((rows, self.dim), np.float32)
                for name in self.predicts}

    def close(self) -> None:
        pass


class _PredictWorker(threading.Thread):
    """Owns one teacher connection; serves tasks from the shared queue.

    A task is owned from get() until either a successful out_queue.put or
    a re-queue — exactly-once across worker death (invariant D3). With a
    pipelining-capable client (``predict_async``) the worker keeps up to
    ``pipeline_depth`` requests in flight on its one connection, so
    teacher round-trip latency hides under the teacher's own compute and
    the student's train step; responses resolve FIFO and stay
    sequence-checked inside the client."""

    def __init__(self, pipeline: "_EpochPipeline", endpoint: str):
        super().__init__(daemon=True, name=f"distill-predict-{endpoint}")
        self.pipeline = pipeline
        self.endpoint = endpoint
        self.stop_event = threading.Event()
        self.broken = threading.Event()
        self.connected = threading.Event()  # client_factory succeeded

    def _check_outs(self, outs: dict) -> str | None:
        """Response contract checks; returns the failure reason."""
        p = self.pipeline
        missing = [k for k in p.predicts if k not in outs]
        if missing:
            return f"missing predicts {missing}"
        if p.sparse_predicts and p.compress_topk:
            # per-part top-k consistency: a teacher serving a different K
            # than negotiated would otherwise surface batches later as an
            # opaque np.concatenate shape error with no endpoint
            for name in outs:
                if not name.endswith((".idx", ".val")):
                    continue
                arr = outs[name]
                if arr.ndim >= 1 and arr.shape[-1] != p.compress_topk:
                    return (f"served top-{arr.shape[-1]} for {name!r} but "
                            f"the negotiated compress_topk is "
                            f"{p.compress_topk} (shape {arr.shape}); "
                            f"mixed --serve-topk across the pool?")
        return None

    def run(self) -> None:
        p = self.pipeline
        tl = timeline("distill.worker")
        try:
            client = p.client_factory(self.endpoint)
        except Exception as exc:
            log.warning("connect to teacher %s failed: %s", self.endpoint, exc)
            p.dead_teachers[self.endpoint] = f"connect: {exc}"
            self.broken.set()
            return
        self.connected.set()
        p.dead_teachers.pop(self.endpoint, None)
        depth = (p.pipeline_depth
                 if hasattr(client, "predict_async") else 1)
        inflight: deque = deque()   # [(task, handle-or-None)] send order
        # worker-owned (Backoff is not thread-safe by design); reset on
        # every successful serve so only CONSECUTIVE sheds escalate
        shed_backoff = Backoff(base=0.05, factor=2.0, max_delay=1.0)

        def die(exc: Exception, task: Task) -> None:
            """Connection-level failure: every in-flight task on this
            connection is lost; re-queue each exactly once (D3)."""
            task.retries += 1
            log.warning("teacher %s failed task %d (try %d): %s",
                        self.endpoint, task.task_id, task.retries, exc)
            p.dead_teachers[self.endpoint] = f"predict: {exc}"
            for t, _ in inflight:
                if t is not task:
                    t.retries += 1
            too_many = [t for t, _ in inflight
                        if t.retries > p.max_retries]
            if too_many:
                p.fail(f"task {too_many[0].task_id} failed "
                       f"{too_many[0].retries} times: {exc}")
            else:
                for t, _ in inflight:
                    p.in_queue.put(t)   # another worker re-serves them
            inflight.clear()
            self.broken.set()

        try:
            while not self.stop_event.is_set():
                # fill the window; block on intake only when idle
                while len(inflight) < depth:
                    try:
                        task = (p.in_queue.get(timeout=0.2) if not inflight
                                else p.in_queue.get_nowait())
                    except queue.Empty:
                        break
                    inflight.append((task, None))
                    if depth > 1:
                        try:
                            with tl.span("send"):
                                handle = client.predict_async(task.feeds)
                        except Exception as exc:
                            die(exc, task)
                            return
                        inflight[-1] = (task, handle)
                if not inflight:
                    continue
                task, handle = inflight[0]
                try:
                    with tl.span("predict"):
                        outs = (handle.result() if handle is not None
                                else client.predict(task.feeds))
                except TeacherRejected as rej:
                    # Typed admission shed — the connection is FINE; the
                    # teacher answered "come back later". Re-queue the
                    # task (a less-loaded teacher may take it) behind a
                    # jittered backoff floored at the server's
                    # retry_after hint, bounded by its own budget so a
                    # permanently-shedding pool fails typed instead of
                    # spinning forever. Never surfaces to the training
                    # step unless the budget is exhausted.
                    inflight.popleft()
                    task.shed_retries += 1
                    if task.shed_retries > p.shed_retry_budget:
                        p.fail(f"teacher pool shedding: task "
                               f"{task.task_id} rejected "
                               f"{task.shed_retries} times (budget "
                               f"{p.shed_retry_budget}): {rej}")
                        return
                    p.in_queue.put(task)
                    delay = max(shed_backoff.delay(), rej.retry_after_s)
                    if self.stop_event.wait(min(delay, 2.0)):
                        return
                    continue
                except Exception as exc:
                    die(exc, task)
                    return
                shed_backoff.reset()
                inflight.popleft()
                reason = self._check_outs(outs)
                if reason is not None:
                    p.fail(f"teacher {self.endpoint} {reason}")
                    return
                p.out_queue.put((task, outs))
        finally:
            # stopped mid-flight (teacher departed the desired set, epoch
            # teardown): hand unserved tasks back — they did not fail, so
            # no retry is charged
            for t, _ in inflight:
                p.in_queue.put(t)
            client.close()


class _EpochPipeline:
    """All shared state of one epoch's pipeline run."""

    def __init__(self, reader: "DistillReader"):
        self.predicts = reader._wire_predicts
        self.max_retries = reader.max_retries
        self.shed_retry_budget = reader.shed_retry_budget
        self.client_factory = reader._client_factory
        self.pipeline_depth = reader.pipeline_depth
        self.compress_topk = reader.compress_topk
        self.sparse_predicts = reader.sparse_predicts
        self.in_queue: queue.Queue = queue.Queue()
        self.out_queue: queue.Queue = queue.Queue()
        self.stop = threading.Event()
        self.error: list[str] = []
        n0 = max(1, len(reader._get_servers()))
        slots = self._window(n0)
        self.sem = threading.Semaphore(slots)
        self._sem_slots = slots   # manage-thread-owned bookkeeping
        self.reader_done = threading.Event()
        self.total_tasks = 0        # valid once reader_done is set
        self.total_batches = 0
        # deadman facts: serves counted by the consumer, dead-teacher
        # reasons recorded by workers, the clock owned by the manage
        # thread (reset whenever a connected worker is live or no work
        # is outstanding)
        self.served_count = 0
        self.dead_teachers: dict[str, str] = {}
        self.deadman_ts = time.monotonic()

    def fail(self, msg: str) -> None:
        self.error.append(msg)
        self.stop.set()

    def acquire_slot(self) -> bool:
        """Backpressure acquire that stays responsive to stop."""
        while not self.stop.is_set():
            if self.sem.acquire(timeout=0.1):
                return True
        return False

    def _window(self, n_teachers: int) -> int:
        """In-flight task window: per-connection pipelining depth + one
        task resolving at the head, per teacher, + slack (reduces to the
        reference's 2*teachers+2 at depth 1, distill_reader.py:215)."""
        return (self.pipeline_depth + 1) * max(1, n_teachers) + 2

    def resize_window(self, n_teachers: int) -> None:
        """Track the live teacher count so a teacher joining mid-epoch
        actually widens throughput. Called only from the manage thread;
        shrink is best-effort (never blocks the pipeline)."""
        target = self._window(n_teachers)
        while self._sem_slots < target:
            self.sem.release()
            self._sem_slots += 1
        while self._sem_slots > target and self.sem.acquire(blocking=False):
            self._sem_slots -= 1


_FMT_DICT = "dict"
_FMT_SAMPLE = "sample"
_FMT_SAMPLE_LIST = "sample_list"
_FMT_BATCH = "batch"


class DistillReader:
    """Wrap ``reader`` so iteration yields its batches + teacher predicts.

    Native format: dict batches (equal leading dim) — ``DataLoader.epoch``
    fits directly. The reference's three positional-slot reader formats
    (distill_reader.py:313-329, fetch: distill_worker.py:656-781) are
    supported as adapters over the same pipeline via ``ins=[...]`` +
    ``set_sample_generator`` / ``set_sample_list_generator`` /
    ``set_batch_generator``; iteration then yields the ORIGINAL structure
    with prediction slots appended (per-sample tuples / sample lists /
    stacked-array tuples respectively).

    Args:
      reader: callable returning an iterator of dict batches, or an
        iterable of such batches — or None when using the slot-format
        setters (the reference's construction order).
      feeds: batch keys sent to the teacher (dict format).
      ins: positional slot spec for the slot formats — a name per slot,
        ``None`` for passthrough slots not sent to the teacher (the
        reference's ``ins=['img', None]``).
      predicts: teacher output names appended to each batch.
      teachers: fixed teacher endpoint list (reference set_fixed_teacher);
        OR
      discovery: endpoints of discovery servers + ``service`` for dynamic
        teacher assignment. Both may instead be bound later via
        ``set_fixed_teacher`` / ``set_dynamic_teacher``.
      teacher_batch_size: rows per teacher RPC (reference default 16).
      deadman_timeout: seconds without any connected teacher serving a
        task (while work is outstanding) before the epoch raises
        EdlDistillError instead of waiting forever (invariant D6).
      pipeline_depth: in-flight requests kept per teacher connection
        (request pipelining; the client sequence-tags them and the server
        answers FIFO). Depth 1 restores strict request/response lockstep;
        clients without ``predict_async`` (test fakes) always run at
        depth 1. The reader window scales with it (invariant D5).
      compress_topk: negotiate top-k+fp16 logit compression with the
        teacher (~125x smaller response wire at 1000 classes, K=8; see
        teacher_server.compress_outputs). Default: transparently
        scatter-expanded back to dense fp32.
      sparse_predicts: with compress_topk, skip the expansion and yield
        ``name.idx``/``name.val`` pairs for sparse-aware losses
        (train/classification.make_sparse_distill_step). Dict format
        only.
      shed_retry_budget: bounded retries per task on teacher admission
        sheds (typed retry-after responses); past it the epoch raises
        EdlDistillError. Default EDL_TPU_SERVE_RETRY_BUDGET (8).
      tenant / priority: multi-tenant identity attached to every
        predict request — the teacher pool queues/sheds per (tenant,
        priority class); see distill/admission.py.

    Env: ``EDL_TPU_DISTILL_NOP=1`` swaps real connections for nop teachers
    (offline smoke; tests inject ``client_factory`` directly).
    """

    def __init__(self, reader=None, feeds: Iterable[str] | None = None,
                 predicts: Iterable[str] = (), *,
                 ins: Iterable[str | None] | None = None,
                 teachers: list[str] | None = None,
                 discovery: str | None = None, service: str | None = None,
                 teacher_batch_size: int = 16, max_retries: int = 3,
                 manage_interval: float = 0.5,
                 client_factory: Callable | None = None,
                 rpc_timeout: float = 30.0,
                 deadman_timeout: float = 60.0,
                 pipeline_depth: int = 4,
                 compress_topk: int = 0,
                 compress_values: str = "float16",
                 sparse_predicts: bool = False,
                 shed_retry_budget: int | None = None,
                 tenant: str = "", priority: str = ""):
        self.reader = reader
        self._format = _FMT_DICT
        self._ins = list(ins) if ins is not None else None
        if feeds is not None:
            self.feeds = tuple(feeds)
        elif self._ins is not None:
            self.feeds = tuple(n for n in self._ins if n is not None)
        else:
            self.feeds = ()
        self.predicts = tuple(predicts)
        self.sparse_predicts = sparse_predicts
        # what actually travels: sparse mode receives name.idx/name.val
        # pairs per predict (compress_outputs' naming) instead of the
        # dense tensor — the pipeline reassembles THESE keys.
        self._wire_predicts = tuple(
            f"{n}{suffix}" for n in self.predicts
            for suffix in ((".idx", ".val") if sparse_predicts else ("",)))
        self.teacher_batch_size = teacher_batch_size
        self.max_retries = max_retries
        self.manage_interval = manage_interval
        self.deadman_timeout = deadman_timeout
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.compress_topk = int(compress_topk)
        # bounded budget for admission-shed retries per task (satellite
        # of the r23 serving tier): sheds requeue behind a jittered
        # backoff, and past the budget the epoch fails TYPED instead of
        # retrying forever against a permanently-overloaded pool
        self.shed_retry_budget = (
            shed_retry_budget if shed_retry_budget is not None
            else config.env_int("EDL_TPU_SERVE_RETRY_BUDGET", 8))
        self._fixed_teachers = list(teachers) if teachers else None
        self._discovery_endpoints = discovery
        self._service = service
        self._discovery_client = None
        if sparse_predicts and not compress_topk:
            raise EdlDistillError("sparse_predicts requires compress_topk")
        if client_factory is None:
            if config.env_flag("EDL_TPU_DISTILL_NOP", False):
                client_factory = lambda ep: _NopTeacherClient(  # noqa: E731
                    ep, self._wire_predicts)
            else:
                client_factory = lambda ep: TeacherClient(  # noqa: E731
                    ep, timeout=rpc_timeout, compress_topk=compress_topk,
                    compress_values=compress_values,
                    expand=not sparse_predicts,
                    max_inflight=self.pipeline_depth,
                    tenant=tenant, priority=priority)
        self._client_factory = client_factory
        # the last completed epoch's counts: batches yielded, teacher
        # tasks served and the rows they carried
        self.last_epoch: dict | None = None

    # -- teacher set --------------------------------------------------------

    def _get_servers(self) -> list[str]:
        if self._fixed_teachers is not None:
            return self._fixed_teachers
        if self._discovery_endpoints is None:
            raise EdlDistillError("need fixed `teachers` or `discovery` "
                                  "(set_fixed_teacher / set_dynamic_teacher)")
        if self._discovery_client is None:
            from edl_tpu_torch.distill.discovery_client import DiscoveryClient
            self._discovery_client = DiscoveryClient(
                self._discovery_endpoints, self._service or "distill").start()
        return self._discovery_client.get_servers()

    def set_fixed_teacher(self, teachers: str | list[str]) -> "DistillReader":
        """Swap in a fixed teacher set — a comma-joined endpoint string
        or a list (reference set_fixed_teacher,
        distill_reader.py:279-291)."""
        if isinstance(teachers, str):
            teachers = [t for t in teachers.split(",") if t]
        self._fixed_teachers = list(teachers)
        return self

    # historical spelling used by earlier rounds' docs
    set_fixed_teachers = set_fixed_teacher

    def set_dynamic_teacher(self, discovery_servers: str | list[str],
                            teacher_service_name: str,
                            require_max_teacher: int = 0
                            ) -> "DistillReader":
        """Bind discovery-mode teacher assignment after construction
        (reference distill_reader.py:293-307). ``require_max_teacher`` is
        accepted for signature parity; the balancer assigns shares
        centrally (distill/balance.py), so a per-reader cap is not used.
        """
        if isinstance(discovery_servers, (list, tuple)):
            discovery_servers = ",".join(discovery_servers)
        self._fixed_teachers = None
        self._discovery_endpoints = discovery_servers
        self._service = teacher_service_name
        return self

    def close(self) -> None:
        if self._discovery_client is not None:
            self._discovery_client.stop()
            self._discovery_client = None

    # -- reference slot-format adapters -------------------------------------
    # (distill_reader.py:313-329 setters; slicing read_sample/
    # read_sample_list/read_batch and reassembly fetch_* in
    # distill_worker.py:481-781 — here both directions are thin
    # wrap/unwrap layers over the ONE dict pipeline, so all D1-D6
    # invariants apply to every format for free.)

    def set_sample_generator(self, reader) -> "DistillReader":
        """Reader yields ONE sample per iteration: a tuple/list of
        per-slot arrays matching ``ins``. Iteration then yields
        per-sample tuples ``(*slots, *predicts)``."""
        return self._set_slot_reader(reader, _FMT_SAMPLE)

    def set_sample_list_generator(self, reader) -> "DistillReader":
        """Reader yields a LIST of sample tuples per iteration; iteration
        yields lists of the same length with predict slots appended to
        each sample."""
        return self._set_slot_reader(reader, _FMT_SAMPLE_LIST)

    def set_batch_generator(self, reader) -> "DistillReader":
        """Reader yields a tuple of stacked per-slot arrays (leading dim
        = batch); iteration yields the same tuple with stacked predict
        arrays appended."""
        return self._set_slot_reader(reader, _FMT_BATCH)

    def _set_slot_reader(self, reader, fmt: str) -> "DistillReader":
        if self.reader is not None:
            raise EdlDistillError("reader has already been set")
        if self.sparse_predicts:
            raise EdlDistillError(
                "sparse_predicts is dict-format only (slot formats "
                "append dense prediction slots)")
        if self._ins is None:
            raise EdlDistillError(
                f"{fmt} readers are positional — construct DistillReader "
                f"with ins=[...] (None marks passthrough slots)")
        self.reader = reader
        self._format = fmt
        return self

    def _slot_keys(self) -> list[str]:
        return [n if n is not None else f"_slot{i}"
                for i, n in enumerate(self._ins)]

    def _wrap_slots(self, keys: list[str]) -> Iterator[dict]:
        """Slot-format input -> the pipeline's dict batches. Samples are
        grouped ``teacher_batch_size`` per dict batch (SAMPLE) or one
        incoming list/batch per dict batch, so reassembly-by-batch
        restores the original structure exactly."""
        src = self.reader() if callable(self.reader) else iter(self.reader)

        def pack(samples: list[tuple]) -> dict:
            return {k: np.stack([s[i] for s in samples])
                    for i, k in enumerate(keys)}

        if self._format == _FMT_SAMPLE:
            group: list[tuple] = []
            for sample in src:
                group.append(tuple(np.asarray(s) for s in sample))
                if len(group) == self.teacher_batch_size:
                    yield pack(group)
                    group = []
            if group:
                yield pack(group)
        elif self._format == _FMT_SAMPLE_LIST:
            for sample_list in src:
                yield pack([tuple(np.asarray(s) for s in sample)
                            for sample in sample_list])
        else:  # _FMT_BATCH
            for batch in src:
                yield {k: np.asarray(batch[i])
                       for i, k in enumerate(keys)}

    def _unwrap_slots(self, merged: dict, keys: list[str]) -> Iterator:
        """One pipeline dict batch -> original-structure output(s) with
        predict slots appended (the reference's fetch_sample/
        fetch_sample_list/fetch_batch reassembly)."""
        names = list(keys) + list(self.predicts)

        def sample(i: int) -> tuple:
            return tuple(merged[n][i] for n in names)

        rows = merged[keys[0]].shape[0]
        if self._format == _FMT_SAMPLE:
            for i in range(rows):
                yield sample(i)
        elif self._format == _FMT_SAMPLE_LIST:
            yield [sample(i) for i in range(rows)]
        else:  # _FMT_BATCH: stacked arrays, originals untouched
            yield tuple(merged[n] for n in names)

    # -- pipeline threads ---------------------------------------------------

    def _reader_thread(self, p: _EpochPipeline, src) -> None:
        tl = timeline("distill.reader")
        task_id = 0
        batch_id = 0
        try:
            it = src() if callable(src) else iter(src)
            for batch in it:
                if p.stop.is_set():
                    return
                rows = next(iter(batch.values())).shape[0]
                n_parts = -(-rows // self.teacher_batch_size)
                p.out_queue.put(("batch", batch_id, batch, n_parts))
                for part in range(n_parts):
                    lo = part * self.teacher_batch_size
                    hi = min(lo + self.teacher_batch_size, rows)
                    feeds = {k: np.ascontiguousarray(batch[k][lo:hi])
                             for k in self.feeds}
                    task = Task(task_id, batch_id, part, feeds, hi - lo)
                    task_id += 1
                    with tl.span("feed"):
                        if not p.acquire_slot():
                            return
                    p.in_queue.put(task)
                batch_id += 1
        except Exception as exc:
            p.fail(f"reader failed: {type(exc).__name__}: {exc}")
        finally:
            p.total_tasks = task_id
            p.total_batches = batch_id
            p.reader_done.set()

    def _manage_thread(self, p: _EpochPipeline,
                       workers: dict[str, _PredictWorker]) -> None:
        """Diff discovered teachers vs. worker pool (reference
        predict_manage_worker, distill_worker.py:57-161)."""
        while not p.stop.is_set():
            try:
                desired = set(self._get_servers())
            except Exception as exc:
                log.warning("teacher discovery failed: %s", exc)
                desired = set(workers)
            else:
                # Prune dead-teacher records for endpoints no longer in
                # the discovered set: a teacher that departed AND was
                # removed from assignment must not permanently trip the
                # scale-to-zero deadman below (the D6 docstring's
                # empty-pool promise). Fixed teachers stay in `desired`,
                # so their records — and the fail-fast — survive.
                for ep in list(p.dead_teachers):
                    if ep not in desired:
                        p.dead_teachers.pop(ep, None)
            for ep in list(workers):
                w = workers[ep]
                if ep not in desired or w.broken.is_set() \
                        or not w.is_alive():
                    w.stop_event.set()
                    if not w.is_alive():
                        workers.pop(ep)
            for ep in desired:
                if ep not in workers:
                    w = _PredictWorker(p, ep)
                    workers[ep] = w
                    w.start()
            p.resize_window(len(workers))
            # Epoch deadman: predict-time failures are bounded by
            # max_retries, but a teacher whose CONNECT always fails is
            # popped and re-created here every tick while queued tasks
            # wait forever (the reference hangs in exactly this case).
            # If no CONNECTED worker is live, work is outstanding, and
            # nothing has been served for deadman_timeout — fail,
            # naming the dead teachers. A discovery-mode pool that is
            # legitimately EMPTY (scale-to-zero, preemption) is not a
            # failure: the balancer will reassign, so the clock also
            # resets while no known-dead teacher exists.
            alive = any(w.is_alive() and w.connected.is_set()
                        and not w.broken.is_set()
                        for w in workers.values())
            outstanding = not (p.reader_done.is_set()
                               and p.served_count >= p.total_tasks)
            empty_pool_ok = (self._fixed_teachers is None
                             and not p.dead_teachers)
            if alive or not outstanding or empty_pool_ok:
                p.deadman_ts = time.monotonic()
            elif (time.monotonic() - p.deadman_ts
                  > self.deadman_timeout):
                dead = ", ".join(f"{ep} ({why})" for ep, why in
                                 sorted(p.dead_teachers.items())) \
                    or "none registered"
                p.fail(f"distill deadman: no live teacher served a task "
                       f"for {self.deadman_timeout:.0f}s with work "
                       f"outstanding; dead teachers: {dead}")
                return
            if p.stop.wait(self.manage_interval):
                return

    # -- the generator ------------------------------------------------------

    def __call__(self) -> Iterator:
        """One epoch. Dict format yields merged dict batches; slot
        formats yield the original structure with predicts appended."""
        if self.reader is None:
            raise EdlDistillError("must set a reader before iterating "
                                  "(constructor arg or set_*_generator)")
        if not self.feeds:
            raise EdlDistillError(
                "no teacher feeds configured — pass feeds=[...] (dict "
                "format) or ins=[...] with at least one named slot")
        if self._format == _FMT_DICT:
            yield from self._dict_epoch(self.reader)
            return
        keys = self._slot_keys()
        for merged in self._dict_epoch(lambda: self._wrap_slots(keys)):
            yield from self._unwrap_slots(merged, keys)

    def _dict_epoch(self, src) -> Iterator[dict]:
        p = _EpochPipeline(self)
        workers: dict[str, _PredictWorker] = {}
        threads = [
            threading.Thread(target=self._reader_thread, args=(p, src),
                             daemon=True, name="distill-reader"),
            threading.Thread(target=self._manage_thread, args=(p, workers),
                             daemon=True, name="distill-manage"),
        ]
        [t.start() for t in threads]
        tl = timeline("distill.fetch")

        pending: dict[int, _Batch] = {}
        next_yield = 0
        served_tasks = 0
        served_rows = 0
        seen: set[tuple[int, int]] = set()
        try:
            while True:
                if p.error:
                    raise EdlDistillError("; ".join(p.error))
                if (p.reader_done.is_set() and served_tasks == p.total_tasks
                        and next_yield == p.total_batches):
                    self.last_epoch = {"batches": next_yield,
                                       "tasks": served_tasks,
                                       "served_rows": served_rows}
                    return                      # D4: exactly-once epoch end
                try:
                    item = p.out_queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item[0] == "batch":
                    _, bid, batch, n_parts = item
                    entry = pending.setdefault(bid, _Batch(batch))
                    entry.batch = batch
                    entry.n_parts = n_parts
                    entry.complete = n_parts == 0
                else:
                    task, outs = item
                    key = (task.batch_id, task.part)
                    if key in seen:
                        raise EdlDistillError(f"duplicate serve for {key}")
                    seen.add(key)
                    served_tasks += 1
                    served_rows += task.rows
                    p.served_count = served_tasks  # deadman's progress fact
                    p.sem.release()
                    entry = pending.setdefault(task.batch_id, _Batch({}))
                    entry.parts[task.part] = outs
                    if entry.n_parts and len(entry.parts) == entry.n_parts:
                        entry.complete = True
                # D2: yield strictly in reader order.
                while next_yield in pending and pending[next_yield].complete:
                    entry = pending.pop(next_yield)
                    with tl.span("assemble"):
                        merged = dict(entry.batch)
                        for name in self._wire_predicts:
                            merged[name] = np.concatenate(
                                [entry.parts[i][name]
                                 for i in range(entry.n_parts)], axis=0) \
                                if entry.n_parts else np.zeros((0, 1))
                    yield merged
                    next_yield += 1
        finally:
            p.stop.set()
            # The manage thread may be mid-install/remove; join it first so
            # the worker dict is stable (and no worker is added after we
            # snapshot), then signal every worker.
            threads[1].join(timeout=2.0)
            for w in list(workers.values()):
                w.stop_event.set()
