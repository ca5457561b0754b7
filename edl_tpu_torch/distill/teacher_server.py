"""Teacher inference server: batched forward serving over the tensor wire
(port of ``edl_tpu.distill.teacher_server``; protocol unchanged, so JAX
and port clients and servers interoperate).

A coalescing batcher concatenates concurrent client requests into one
device batch and pads it to a fixed bucket, so the model sees a handful
of batch shapes.

Protocol (tensor_wire frames):
    request  meta {"op": "predict"}          tensors {feed_name: array}
    response meta {"ok": true}               tensors {fetch_name: array}
    request  meta {"op": "ping"}             -> {"ok": true}, no tensors
Requests may carry {"seq": n}; the response echoes it. Responses on one
connection come back strictly in request order, and the server does NOT
wait for a predict to finish before reading the next request — clients
may pipeline many requests per connection (TeacherClient.predict_async).

Wire compression (two independent levers; see `compress_outputs`):
  - client-negotiated: request meta carries {"compress": {"topk": K,
    "values": "float16"}} and eligible dense outputs come back as
    name.idx/name.val with meta {"compressed": {name: {...}}};
  - server-side device top-k: predict_fn emits name.idx/name.val
    directly (top-k before the host transfer, see
    distill/sharded_teacher.py); the server announces the same meta
    from `compressed_meta`.
  Dense clients scatter-expand transparently (`expand_outputs`); sparse
  clients (TeacherClient(expand=False)) consume idx/val as-is.

CLI: ``python -m edl_tpu_torch.distill.teacher_server --model
ResNet50_vd --num-classes 1000 --input-shape 224,224,3 --params <ckpt>``
serves a zoo model (random, or restored from a checkpoint of either
package), on the card unless ``--device cpu``; ``--local-mesh dp=N``
drives N local cards from this one process (``sharded_teacher.py``).
"""

from __future__ import annotations

import argparse
import queue
import socket
import socketserver
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from edl_tpu_torch.data import tensor_wire
from edl_tpu_torch.distill.admission import (PRIORITIES, AdmissionConfig,
                                             AdmissionQueue,
                                             AdmissionReject,
                                             normalize_priority)
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace
from edl_tpu_torch.utils.logging import get_logger
from edl_tpu_torch.utils.net import split_endpoint

log = get_logger("edl_tpu_torch.distill.teacher_server")


DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# Fixed-bucket per-request latency histogram edges (ms, upper bounds;
# final bucket is open-ended). Fixed buckets — not a reservoir — so the
# registrar can difference two cumulative snapshots into an exact
# windowed histogram and quantiles never drift under load. The pattern
# generalized into the shared obs Histogram type (obs/metrics.py);
# these edges are the obs plane's canonical log ladder.
LATENCY_BUCKETS_MS = obs_metrics.LOG_BUCKETS_MS


def latency_quantile(hist_ms: dict, q: float) -> float | None:
    """q-quantile of a ``{bucket_upper_ms: count}`` histogram (keys may
    be str off the wire). Answers with the bucket's UPPER edge —
    conservative: the reported p95 is never below the true one, so an
    SLO decision made on it never under-provisions. None when empty.
    (Shim over the shared obs Histogram quantile.)"""
    return obs_metrics.Histogram.quantile(hist_ms, q)


def pad_to_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n  # beyond the largest bucket: serve exact


@dataclass
class _Request:
    tensors: dict[str, np.ndarray]
    rows: int
    done: threading.Event = field(default_factory=threading.Event)
    result: dict[str, np.ndarray] | None = None
    error: str | None = None
    tenant: str = "default"
    cls: str = "normal"   # priority class (admission.PRIORITIES)
    # submit time: the latency histogram measures submit -> results
    # ready (coalesce wait + device compute + host fetch) — what a
    # pipelined client experiences per request, the serving SLO signal
    t_submit: float = field(default_factory=time.monotonic)


class Batcher:
    """Coalesce concurrent predict requests into padded device batches.

    Staged pipeline: three threads connected by bounded queues so
    the card never waits on host work —

        coalesce  — collect + concatenate + pad the next group while the
                    card computes the current one (adaptive window below);
        compute   — calls predict_fn; CUDA launches are asynchronous,
                    so the call returns its fetch without waiting
                    and the thread immediately feeds the card the NEXT
                    coalesced batch;
        complete  — calls the fetch that predict_fn returned (the
                    device->host sync), slices per request, sets done.
                    Overlaps the transfer of batch N with the compute of
                    batch N+1.

    (De)serialization and `compress_outputs` run on the per-connection
    handler/writer threads (see `_Handler`), never here.

    Batching modes (``EDL_TPU_SERVE_BATCHING``):

    ``continuous`` (default) — iteration-level admission, no timed
    window. A group dispatches the moment the pipeline can take it
    (idle-device latency is one queue hop), and while the pipeline is
    full the forming group keeps ADMITTING newly-arrived requests up to
    ``max_batch`` rows — each device step starts from everything that
    arrived during the previous one, the Orca/vLLM scheduling shape.
    ``max_wait`` is unused; ``max_wait_cap`` only bounds how long one
    group may keep forming against a saturated pipeline.

    ``window`` — the adaptive coalescing window, kept for A/B
    benches: a group closes after ``max_wait`` ONLY when the device
    pipeline is idle, extending up to ``max_wait_cap`` while a previous
    group is in flight.

    Intake is an `AdmissionQueue` (bounded multi-tenant WFQ): submits
    may raise `AdmissionReject`, which the wire handler answers with a
    typed retry-after response instead of queuing toward a collapsed
    p95. See distill/admission.py.
    """

    def __init__(self, predict_fn, *, max_batch: int = 64,
                 max_wait: float = 0.002,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_wait_cap: float | None = None,
                 stage_depth: int = 2,
                 batching: str | None = None,
                 admission: AdmissionConfig | None = None):
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.max_wait_cap = (max_wait_cap if max_wait_cap is not None
                             else max(8 * max_wait, 0.016))
        self.buckets = tuple(sorted(buckets))
        self.admission_config = admission or AdmissionConfig.from_env()
        self.batching = batching or self.admission_config.batching
        if self.batching not in ("continuous", "window"):
            raise ValueError(f"unknown batching mode {self.batching!r}")
        self._q = AdmissionQueue(self.admission_config)
        # bounded stage queues: coalesce may run at most `stage_depth`
        # groups ahead of the card, the card at most `stage_depth` ahead
        # of the host fetch
        self._compute_q: queue.Queue = queue.Queue(maxsize=stage_depth)
        self._post_q: queue.Queue = queue.Queue(maxsize=stage_depth)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run_coalesce, daemon=True,
                             name="teacher-coalesce"),
            threading.Thread(target=self._run_compute, daemon=True,
                             name="teacher-compute"),
            threading.Thread(target=self._run_complete, daemon=True,
                             name="teacher-complete"),
        ]
        # adaptive-window state: groups currently past coalesce (queued,
        # computing, or fetching) — the "device busy" signal; plus an EMA
        # of realized window lengths for observability. All mutated from
        # three stage threads + read by the registrar's stats scrape, so
        # every field below is annotated for the guarded-by checker.
        self._stats_lock = threading.Lock()
        self._groups_inflight = 0    # guarded-by: _stats_lock
        self._window_ema_s = max_wait  # guarded-by: _stats_lock
        self._carry: _Request | None = None  # coalesce-thread-only
        # Cumulative utilization counters (the registry `info` data source:
        # reference discovery/register.py:36-40 reserves the field for
        # "report job performance to the scheduler").
        self._served_rows = 0        # guarded-by: _stats_lock
        self._served_requests = 0    # guarded-by: _stats_lock
        self._busy_s = 0.0           # guarded-by: _stats_lock
        # interval-union accounting across stages
        self._busy_until = 0.0       # guarded-by: _stats_lock
        self._started_at = time.monotonic()
        # intake high-water mark: observed demand
        self._pending_hwm = 0        # guarded-by: _stats_lock
        # Coalescing histogram: device-batch ROW count (pre-padding) ->
        # number of served groups. Whether concurrent client requests
        # actually merge (vs degenerate 1-request batches) is THE
        # efficiency question for a serving pool; the histogram makes it
        # observable instead of inferred.
        self._batch_hist: dict[int, int] = {}  # guarded-by: _stats_lock
        # Per-request latency histogram (fixed buckets, cumulative):
        # the SLO signal the serving scaler consumes. The shared obs
        # Histogram type (its own leaf lock; _stats_lock still orders
        # it against the sibling counters so one stats() snapshot is
        # coherent). inf = overflow.
        self._lat_hist = obs_metrics.Histogram(
            LATENCY_BUCKETS_MS)         # guarded-by: _stats_lock
        # per-priority-class split of the same signal: the registrar
        # differences these into windowed per-class p95 so graceful
        # degradation is observable PER CLASS, not globally
        self._lat_hist_by_class = {
            c: obs_metrics.Histogram(LATENCY_BUCKETS_MS)
            for c in PRIORITIES}        # guarded-by: _stats_lock

    def start(self) -> "Batcher":
        for t in self._threads:
            t.start()
        return self

    def submit(self, tensors: dict[str, np.ndarray], *,
               tenant: str = "default", priority: str = "normal"
               ) -> _Request:
        """Admit one predict request. Raises `AdmissionReject` when the
        tenant's queue is full, the class's delay budget is blown, or
        the batcher is draining — the caller answers with a typed
        retry-after instead of queueing."""
        rows = next(iter(tensors.values())).shape[0] if tensors else 0
        req = _Request(tensors=tensors, rows=rows, tenant=tenant or
                       "default", cls=normalize_priority(priority))
        self._q.submit(req, rows, req.tenant, req.cls)
        depth = self._q.qsize()
        if depth > self._pending_hwm:
            with self._stats_lock:
                self._pending_hwm = max(self._pending_hwm, depth)
        return req

    def begin_drain(self) -> None:
        """Stop admitting (every new submit rejects with retry-after)
        while already-admitted work completes normally — the graceful
        half of the scaler's drain protocol."""
        self._q.begin_drain()

    def _join(self, group: list[_Request], names: list[str], rows: int,
              req: _Request | None) -> tuple[int, bool]:
        """Try to add ``req`` to the forming group; heterogeneous feeds
        or row overflow OPEN the next group via carry (order
        preserved). Returns (rows, keep_collecting)."""
        if req is None:
            return rows, True
        if list(req.tensors) != names or rows + req.rows > self.max_batch:
            self._carry = req
            return rows, False
        group.append(req)
        return rows + req.rows, True

    def _collect(self) -> list[_Request]:
        if self.batching == "continuous":
            return self._collect_continuous()
        return self._collect_window()

    def _collect_continuous(self) -> list[_Request]:
        """Iteration-level admission: dispatch as soon as the pipeline
        has room, and while it has none keep admitting arrivals into
        the forming group — each device step starts from everything
        that arrived during the last one."""
        first = self._carry
        self._carry = None
        if first is None:
            first = self._q.get(timeout=0.2)
            if first is None:
                return []
        t_first = time.monotonic()
        hard = t_first + self.max_wait_cap
        names = list(first.tensors)
        group, rows = [first], first.rows
        while rows < self.max_batch:
            req = self._q.get_nowait()
            if req is not None:
                rows, more = self._join(group, names, rows, req)
                if not more:
                    break
                continue
            # intake empty: dispatch now unless the pipeline is full —
            # then the card could not take the group anyway, so keep
            # admitting until a slot frees (bounded by max_wait_cap)
            if not self._compute_q.full() or self._stop.is_set() \
                    or time.monotonic() >= hard:
                break
            req = self._q.get(timeout=0.001)
            rows, more = self._join(group, names, rows, req)
            if not more:
                break
        window = time.monotonic() - t_first
        with self._stats_lock:
            self._window_ema_s += 0.2 * (window - self._window_ema_s)
        return group

    def _collect_window(self) -> list[_Request]:
        """Window mode: one blocking pop, then drain whatever arrives
        within the adaptive window (bounded by max_batch rows)."""
        first = self._carry
        self._carry = None
        if first is None:
            first = self._q.get(timeout=0.2)
            if first is None:
                return []
        t_first = time.monotonic()
        soft = t_first + self.max_wait
        hard = t_first + self.max_wait_cap
        names = list(first.tensors)
        group, rows = [first], first.rows
        while rows < self.max_batch:
            now = time.monotonic()
            if now >= hard:
                break
            with self._stats_lock:
                busy = self._groups_inflight > 0
            if now >= soft and not busy:
                break   # device idle: dispatching NOW starts work
            # device busy: the card can't take this group yet, so keep
            # coalescing (1 ms polls re-check the busy signal)
            timeout = min((hard if busy else soft) - now, 0.001)
            req = self._q.get(timeout=max(timeout, 0.0))
            if req is None:
                if self._stop.is_set():
                    break
                continue
            rows, more = self._join(group, names, rows, req)
            if not more:
                break
        window = time.monotonic() - t_first
        with self._stats_lock:
            self._window_ema_s += 0.2 * (window - self._window_ema_s)
        return group

    def _fail_group(self, group: list[_Request], exc: Exception) -> None:
        log.exception("batch predict failed")
        for req in group:
            req.error = f"{type(exc).__name__}: {exc}"
            req.done.set()

    def _run_coalesce(self) -> None:
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            names = list(group[0].tensors)
            rows = sum(g.rows for g in group)
            bucket = pad_to_bucket(rows, self.buckets)
            try:
                feeds = {}
                for name in names:
                    cat = np.concatenate([g.tensors[name] for g in group],
                                         axis=0)
                    if bucket > rows:
                        pad = np.zeros((bucket - rows,) + cat.shape[1:],
                                       cat.dtype)
                        cat = np.concatenate([cat, pad], axis=0)
                    feeds[name] = cat
            except Exception as exc:  # ragged feeds etc.
                self._fail_group(group, exc)
                continue
            with self._stats_lock:
                self._groups_inflight += 1
            self._compute_q.put((group, feeds, rows))
        self._compute_q.put(None)

    def _group_left(self) -> None:
        with self._stats_lock:
            self._groups_inflight -= 1

    def _run_compute(self) -> None:
        while True:
            item = self._compute_q.get()
            if item is None:
                break
            group, feeds, rows = item
            t0 = time.monotonic()
            try:
                outs = self.predict_fn(feeds)
                if not callable(outs):
                    raise TypeError("predict_fn must return a fetch "
                                    f"callable, got {type(outs).__name__}")
            except Exception as exc:
                self._fail_group(group, exc)
                self._group_left()
                continue
            self._post_q.put((group, outs, rows, t0))
        self._post_q.put(None)

    def _run_complete(self) -> None:
        while True:
            item = self._post_q.get()
            if item is None:
                break
            group, outs, rows, t0 = item
            try:
                # the device->host fetch: predict_fn only launched, so
                # the card is already on the next batch while this blocks
                outs = outs()
            except Exception as exc:
                self._fail_group(group, exc)
                self._group_left()
                continue
            now = time.monotonic()
            with self._stats_lock:
                # union of [t0, now] intervals: overlapped stages must not
                # double-count device busy time
                self._busy_s += max(0.0, now - max(t0, self._busy_until))
                self._busy_until = now
                self._served_rows += rows
                self._served_requests += len(group)
                self._batch_hist[rows] = self._batch_hist.get(rows, 0) + 1
                for req in group:
                    lat_ms = (now - req.t_submit) * 1e3
                    self._lat_hist.observe(lat_ms)
                    self._lat_hist_by_class[req.cls].observe(lat_ms)
                self._groups_inflight -= 1
            # feed the admission plane's service-rate estimate (its own
            # leaf lock; never taken with _stats_lock held)
            self._q.note_served(rows)
            offset = 0
            for req in group:
                req.result = {k: v[offset:offset + req.rows]
                              for k, v in outs.items()}
                offset += req.rows
                req.done.set()

    def stats(self) -> dict:
        """Cumulative serving counters (consumed by TeacherRegistrar).

        The un-suffixed keys are a PINNED contract (the autoscaler
        and drain poller consume queue_depth / inflight_groups / the
        latency quantiles; tests/test_serving_continuous.py pins the
        schema). ``*_by_class`` / ``*_by_tenant`` keys are one-level
        dicts the obs plane renders as labeled gauges."""
        # admission snapshot first (its own leaf lock — the two locks
        # are never nested, in either order)
        adm = self._q.stats()
        with self._stats_lock:
            hist = dict(sorted(self._batch_hist.items()))
            groups = sum(hist.values())
            rows_mean = (sum(r * c for r, c in hist.items()) / groups
                         if groups else 0.0)
            lat = self._lat_hist.snapshot()  # ascending edges, inf last
            lat_by_class = {c: h.snapshot()
                            for c, h in self._lat_hist_by_class.items()}
            out = {"served_rows": self._served_rows,
                   "served_requests": self._served_requests,
                   "busy_s": round(self._busy_s, 4),
                   "uptime_s": round(time.monotonic() - self._started_at, 4),
                   "queue_depth": self._q.qsize(),
                   # groups past intake (queued/computing/fetching): with
                   # queue_depth == 0 this is the whole "work still in
                   # flight" signal a draining pool waits out
                   "inflight_groups": self._groups_inflight,
                   "pending_hwm": self._pending_hwm,
                   "batching": self.batching,
                   "coalesce_window_ms": round(self._window_ema_s * 1e3,
                                               3),
                   # JSON object keys are strings on the wire
                   "batch_rows_hist": {str(r): c for r, c in hist.items()},
                   "batch_rows_mean": round(rows_mean, 2),
                   "latency_hist_ms": {str(b): c for b, c in lat.items()},
                   "latency_ms_p50": latency_quantile(lat, 0.5),
                   "latency_ms_p95": latency_quantile(lat, 0.95)}
        out.update(adm)
        out["latency_hist_ms_by_class"] = {
            c: {str(b): n for b, n in snap.items()}
            for c, snap in lat_by_class.items()}
        p95s = {c: latency_quantile(snap, 0.95)
                for c, snap in lat_by_class.items()}
        out["latency_ms_p95_by_class"] = {
            c: v for c, v in p95s.items() if v is not None}
        return out

    def stop(self) -> None:
        self._stop.set()
        self._q.close()
        for t in self._threads:
            t.join(timeout=5.0)


def compress_outputs(outs: dict[str, np.ndarray], spec: dict
                     ) -> tuple[dict, dict[str, np.ndarray]]:
    """Top-k + narrow-dtype compression of eligible prediction tensors.

    ``spec`` = ``{"topk": K, "values": "float16"}`` (client-negotiated
    per request). A 2-D floating (rows, classes) tensor with classes > K
    becomes ``name.idx`` (uint16 when classes fit, else int32; sorted by
    descending value) + ``name.val`` (K values in the narrow dtype);
    everything else passes through unchanged. Returns a meta fragment
    ``{"compressed": {name: {topk, classes, values}}}`` the client uses
    to expand — at 1000 classes and K=8 this turns 4000 B/row of fp32
    logits into 32 B/row, the lever the reference got from Paddle
    Serving's fetch-var selection (distill_worker.py:203-226).
    """
    k = int(spec.get("topk", 0))
    vdt = np.dtype(spec.get("values", "float16"))
    compressed: dict[str, dict] = {}
    out: dict[str, np.ndarray] = {}
    for name, arr in outs.items():
        if not (k > 0 and arr.ndim == 2 and arr.shape[1] > k
                and np.issubdtype(arr.dtype, np.floating)):
            out[name] = arr
            continue
        idx = np.argpartition(arr, -k, axis=1)[:, -k:]
        vals = np.take_along_axis(arr, idx, axis=1)
        order = np.argsort(-vals, axis=1)  # descending, deterministic
        idx = np.take_along_axis(idx, order, axis=1)
        vals = np.take_along_axis(vals, order, axis=1)
        idt = (np.uint16 if arr.shape[1] - 1 <= np.iinfo(np.uint16).max
               else np.int32)
        out[name + ".idx"] = idx.astype(idt)
        out[name + ".val"] = vals.astype(vdt)
        compressed[name] = {"topk": k, "classes": int(arr.shape[1]),
                            "values": vdt.str}
    return ({"compressed": compressed} if compressed else {}), out


# Non-top-k logit mass is impossible after expansion; this stands in for
# -inf so softmax puts ~zero weight there without inf-arithmetic edges.
EXPAND_FILL = -1e30


def expand_outputs(meta: dict, tensors: dict[str, np.ndarray]
                   ) -> dict[str, np.ndarray]:
    """Scatter-expand a compressed response back to dense fp32 logits
    (non-top-k entries get EXPAND_FILL), leaving downstream losses
    unchanged. Inverse of `compress_outputs`; any rank — the classes
    axis is the LAST one (sequence teachers serve (rows, seq, K))."""
    for name, info in (meta.get("compressed") or {}).items():
        idx = tensors.pop(name + ".idx")
        val = tensors.pop(name + ".val")
        dense = np.full(idx.shape[:-1] + (int(info["classes"]),),
                        EXPAND_FILL, np.float32)
        np.put_along_axis(dense, idx.astype(np.int64),
                          val.astype(np.float32), axis=-1)
        tensors[name] = dense
    return tensors


def _predict_response(out: dict[str, np.ndarray], comp: dict | None,
                      server_meta: dict | None):
    """Build a predict response: client-negotiated compression + the
    server-side sparse announcements. Runs on the per-connection WRITER
    thread, overlapped with the batcher's device stages."""
    compressed = {}
    if comp:  # client-negotiated host-side top-k of dense outs
        # never re-compress outputs the predict_fn already emits
        # sparse (name.idx/name.val) — a smaller client K would
        # otherwise shred name.val into name.val.idx/...
        sparse = {k: v for k, v in out.items()
                  if k.endswith((".idx", ".val"))}
        frag, out = compress_outputs(
            {k: v for k, v in out.items() if k not in sparse}, comp)
        out.update(sparse)
        compressed.update(frag.get("compressed", {}))
    if server_meta:  # predict_fn emitted device-side sparse outs
        compressed.update(
            {name: info for name, info in server_meta.items()
             if name + ".idx" in out})
    if compressed:
        return {"ok": True, "compressed": compressed}, out
    return {"ok": True}, out


class _Handler(socketserver.BaseRequestHandler):
    """Pipelined connection handler: the recv loop submits predict
    requests to the batcher WITHOUT waiting for results; a per-connection
    writer thread completes them strictly in request order (encode +
    compress off the recv path). A client may therefore keep many
    requests in flight on one connection — responses come back FIFO,
    tagged with the request's ``seq`` when it carried one.

    Backpressure: at most MAX_INFLIGHT responses are queued per
    connection; past that the recv loop blocks, which stops reading the
    socket and lets TCP flow control push back on the client.
    """

    MAX_INFLIGHT = 128

    def handle(self) -> None:
        batcher: Batcher = self.server.batcher  # type: ignore[attr-defined]
        server_meta: dict = getattr(self.server, "compressed_meta", {})
        sock: socket.socket = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Register with the server so stop() can hard-close live
        # connections: a stopping teacher must look to its clients like a
        # killed one (immediate RST -> requeue elsewhere), not a silent
        # peer that strands their in-flight requests until rpc_timeout.
        conns = getattr(self.server, "active_conns", None)
        if conns is not None:
            with self.server.conns_lock:  # type: ignore[attr-defined]
                conns.add(sock)
        resp_q: queue.Queue = queue.Queue(maxsize=self.MAX_INFLIGHT)
        writer = threading.Thread(
            target=self._write_loop, args=(sock, resp_q, server_meta),
            daemon=True, name="teacher-conn-send")
        writer.start()
        try:
            while True:
                try:
                    meta, tensors = tensor_wire.recv_tensors(sock)
                except (tensor_wire.TensorWireError, OSError):
                    return
                seq = meta.get("seq")
                # the client's trace context rides meta["_tc"] (tensor
                # wire attaches it); pop it even when tracing is off
                # here so it never leaks into request handling
                remote_ctx = trace.extract(meta)
                if meta.get("op") == "predict":
                    if not tensors:
                        resp_q.put(("done", seq,
                                    {"ok": False,
                                     "error": "no feed tensors"}, {}))
                        continue
                    tenant = meta.get("tenant", "default")
                    prio = meta.get("priority", "normal")
                    # the admission decision is the multi-tenant
                    # attribution point: every accept/shed carries
                    # (tenant, class) so a merged trace answers "whose
                    # requests were shed during THAT pool resize"
                    adm = trace.start_span(
                        "serve.admit", parent=remote_ctx,
                        attrs={"tenant": tenant, "class": prio})
                    try:
                        req = batcher.submit(
                            tensors, tenant=tenant, priority=prio)
                    except AdmissionReject as rej:
                        if adm is not None:
                            adm.end(admitted=False, reason=rej.reason)
                        # typed load-shed response on the SAME open
                        # connection — never a dropped socket: the
                        # client backs off retry_after_ms and retries
                        # (here or on another teacher)
                        resp_q.put(("done", seq,
                                    {"ok": False, "rejected": True,
                                     "error": str(rej),
                                     "reason": rej.reason,
                                     "retry_after_ms": rej.retry_after_ms},
                                    {}))
                        continue
                    if adm is not None:
                        adm.end(admitted=True, rows=req.rows)
                    resp_q.put(("predict", seq, meta.get("compress"), req))
                else:
                    try:
                        resp_meta, resp_tensors = self._control(
                            batcher, meta)
                    except Exception as exc:
                        resp_meta = {"ok": False,
                                     "error": f"{type(exc).__name__}: {exc}"}
                        resp_tensors = {}
                    resp_q.put(("done", seq, resp_meta, resp_tensors))
        finally:
            if conns is not None:
                with self.server.conns_lock:  # type: ignore[attr-defined]
                    conns.discard(sock)
            resp_q.put(None)

    @staticmethod
    def _control(batcher: Batcher, meta: dict):
        op = meta.get("op")
        if op == "ping":
            return {"ok": True}, {}
        if op == "stats":
            return {"ok": True, **batcher.stats()}, {}
        if op == "drain":
            # graceful-shutdown handshake: stop admitting, finish
            # in-flight work; the drain poller watches queue_depth +
            # inflight_groups go quiet before stopping the process
            batcher.begin_drain()
            return {"ok": True, "draining": True}, {}
        return {"ok": False, "error": f"unknown op {op!r}"}, {}

    @staticmethod
    def _write_loop(sock: socket.socket, resp_q: queue.Queue,
                    server_meta: dict) -> None:
        broken = False   # after a send failure keep DRAINING (the recv
        # loop's final sentinel put must never block on a full queue)
        while True:
            item = resp_q.get()
            if item is None:
                return
            if broken:
                continue
            kind, seq, a, b = item
            if kind == "predict":
                req: _Request = b
                req.done.wait()
                if req.error is not None:
                    resp_meta, out = {"ok": False, "error": req.error}, {}
                else:
                    try:
                        resp_meta, out = _predict_response(
                            req.result, a, server_meta)
                    except Exception as exc:
                        resp_meta = {"ok": False,
                                     "error": f"{type(exc).__name__}: {exc}"}
                        out = {}
            else:
                resp_meta, out = a, b
            if seq is not None:
                resp_meta = {**resp_meta, "seq": seq}
            try:
                tensor_wire.send_tensors(sock, resp_meta, out)
            except OSError:
                broken = True


class _ThreadingServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class TeacherServer:
    """In-process handle: serve `predict_fn` on a TCP port.

    predict_fn: dict[str, np.ndarray] -> fetch, a zero-argument callable
    returning a dict of numpy arrays. predict_fn launches the device work
    and is called only from the batcher's compute thread, with batch
    sizes drawn from `buckets`; fetch does the device->host copy and is
    called on the complete thread (`sharded_predict_fn` builds both).
    """

    def __init__(self, predict_fn, *, port: int = 0, host: str = "0.0.0.0",
                 max_batch: int = 64, max_wait: float = 0.002,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 compressed_meta: dict[str, dict] | None = None,
                 max_wait_cap: float | None = None,
                 batching: str | None = None,
                 admission: AdmissionConfig | None = None):
        """``compressed_meta``: announce that `predict_fn` ALREADY emits
        sparse ``name.idx``/``name.val`` outputs (device-side
        top-k — only K values ever cross host<->device instead
        of the full class row). Shape: ``{name: {"topk": K, "classes":
        C, "values": "<f2"}}``; it is attached to predict responses so
        dense clients scatter-expand transparently while sparse clients
        consume as-is."""
        self.batcher = Batcher(predict_fn, max_batch=max_batch,
                               max_wait=max_wait, buckets=buckets,
                               max_wait_cap=max_wait_cap,
                               batching=batching, admission=admission)
        self.compressed_meta = dict(compressed_meta or {})
        self._server = _ThreadingServer((host, port), _Handler)
        self._server.batcher = self.batcher  # type: ignore[attr-defined]
        self._server.compressed_meta = self.compressed_meta  # type: ignore[attr-defined]
        self._server.active_conns = set()  # type: ignore[attr-defined]
        self._server.conns_lock = threading.Lock()  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._started = False
        # the Batcher's stats() dict stays the registrar's API; the
        # per-process obs registry serves the same numbers as gauges
        self._obs = obs_metrics.register_stats("teacher",
                                               self.batcher.stats)

    def start(self) -> "TeacherServer":
        if self._started:
            return self
        self._started = True
        self.batcher.start()
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="teacher-serve").start()
        log.info("teacher server on :%d", self.port)
        return self

    def drain(self) -> None:
        """Stop admitting new requests; in-flight work completes. The
        in-process mirror of the wire ``op: "drain"``."""
        self.batcher.begin_drain()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # Hard-close live connections: clients see ECONNRESET now and
        # requeue their in-flight work to surviving teachers at once,
        # exactly as if the process had been killed — without this they
        # stall head-of-line until rpc_timeout (measured as a 60s e2e
        # dip in bench_distill_churn before the fix).
        with self._server.conns_lock:  # type: ignore[attr-defined]
            conns = list(self._server.active_conns)  # type: ignore[attr-defined]
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.batcher.stop()
        obs_metrics.unregister(self._obs)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class TeacherRejected(tensor_wire.TensorWireError):
    """Typed admission rejection off the wire: the teacher answered
    ``{"ok": false, "rejected": true, "retry_after_ms": R}`` instead of
    serving. NOT a dead connection — the socket stays usable; callers
    back off ``retry_after_s`` (jittered) and retry, here or on another
    teacher (reader.py's bounded shed-retry budget)."""

    def __init__(self, message: str, retry_after_ms: float = 100.0,
                 reason: str = "overload"):
        super().__init__(message)
        self.retry_after_ms = float(retry_after_ms)
        self.reason = reason

    @property
    def retry_after_s(self) -> float:
        return self.retry_after_ms / 1e3


class _PendingPredict:
    """Handle for one in-flight request on a pipelined TeacherClient.
    ``result()`` blocks until THIS request's response arrives (receiving
    and completing any earlier in-flight requests along the way — the
    server responds strictly in request order per connection)."""

    __slots__ = ("_client", "seq", "_meta", "_tensors", "_arrived")

    def __init__(self, client: "TeacherClient", seq: int):
        self._client = client
        self.seq = seq
        self._meta: dict | None = None
        self._tensors: dict | None = None
        self._arrived = False

    def response(self) -> tuple[dict, dict]:
        """Raw (meta, tensors) of the response, no ok-check/expansion."""
        self._client._wait_for(self)
        return self._meta, self._tensors  # type: ignore[return-value]

    def result(self) -> dict[str, np.ndarray]:
        """Predict semantics: raise on server error, expand per the
        client's negotiation settings."""
        meta, tensors = self.response()
        if not meta.get("ok"):
            if meta.get("rejected"):
                raise TeacherRejected(
                    meta.get("error", "admission rejected"),
                    meta.get("retry_after_ms", 100.0),
                    meta.get("reason", "overload"))
            raise tensor_wire.TensorWireError(
                meta.get("error", "predict failed"))
        if self._client.expand:
            tensors = expand_outputs(meta, tensors)
        return tensors


class TeacherClient:
    """Client of one teacher server (used by DistillReader's predict
    workers; the reference counterpart wraps paddle_serving_client,
    distill_worker.py:187-282).

    ``predict`` is the blocking one-shot; ``predict_async`` returns a
    `_PendingPredict` handle and may be called again before resolving it,
    keeping up to ``max_inflight`` requests pipelined on the ONE
    connection — the lever that hides teacher round-trip latency under
    student compute. Requests are sequence-tagged and the server echoes
    the tag; a FIFO mismatch fails loudly instead of silently pairing a
    response with the wrong request. Not thread-safe by design: each
    reader worker owns its client (a lock still guards the send path for
    accidental sharing).

    ``compress_topk > 0`` negotiates top-k+fp16 logit compression per
    request (see `compress_outputs`); with ``expand=True`` (default) the
    response is scatter-expanded back to dense fp32 transparently, with
    ``expand=False`` the sparse ``name.idx``/``name.val`` pair is
    returned for sparse-aware losses."""

    def __init__(self, endpoint: str, timeout: float = 30.0, *,
                 compress_topk: int = 0, compress_values: str = "float16",
                 expand: bool = True, max_inflight: int = 32,
                 tenant: str = "", priority: str = ""):
        self.endpoint = endpoint
        self.compress_topk = int(compress_topk)
        self.compress_values = compress_values
        self.expand = expand
        # multi-tenant identity: attached to every predict request so
        # the teacher's admission plane can queue/shed per (tenant,
        # priority class). Empty = the server's defaults.
        self.tenant = tenant
        self.priority = priority
        self.max_inflight = max(1, int(max_inflight))
        host, port = split_endpoint(endpoint)
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._seq = 0
        self._pending: "deque[_PendingPredict]" = deque()
        self._send_lock = threading.Lock()

    def _submit(self, meta: dict, tensors: dict | None = None
                ) -> _PendingPredict:
        with self._send_lock:
            if len(self._pending) >= self.max_inflight:
                self._recv_one()   # bound memory: drain the oldest
            handle = _PendingPredict(self, self._seq)
            self._seq += 1
            tensor_wire.send_tensors(self._sock,
                                     {**meta, "seq": handle.seq}, tensors)
            self._pending.append(handle)
        return handle

    def _recv_one(self) -> None:
        meta, tensors = tensor_wire.recv_tensors(self._sock)
        if not self._pending:
            raise tensor_wire.TensorWireError(
                "response with no request in flight")
        h = self._pending.popleft()
        rseq = meta.get("seq")
        if rseq is not None and rseq != h.seq:
            raise tensor_wire.TensorWireError(
                f"pipelining desync: response seq {rseq} != expected "
                f"{h.seq} on {self.endpoint}")
        h._meta, h._tensors, h._arrived = meta, tensors, True

    def _wait_for(self, handle: _PendingPredict) -> None:
        while not handle._arrived:
            self._recv_one()

    def inflight(self) -> int:
        return len(self._pending)

    def predict_async(self, feeds: dict[str, np.ndarray]) -> _PendingPredict:
        meta: dict = {"op": "predict"}
        if self.compress_topk > 0:
            meta["compress"] = {"topk": self.compress_topk,
                                "values": self.compress_values}
        if self.tenant:
            meta["tenant"] = self.tenant
        if self.priority:
            meta["priority"] = self.priority
        return self._submit(meta, feeds)

    def predict(self, feeds: dict[str, np.ndarray]
                ) -> dict[str, np.ndarray]:
        return self.predict_async(feeds).result()

    def ping(self) -> bool:
        try:
            meta, _ = self._submit({"op": "ping"}).response()
            return bool(meta.get("ok"))
        except (tensor_wire.TensorWireError, OSError):
            return False

    def drain(self) -> bool:
        """Ask the remote teacher to stop admitting (op: drain)."""
        try:
            meta, _ = self._submit({"op": "drain"}).response()
            return bool(meta.get("ok"))
        except (tensor_wire.TensorWireError, OSError):
            return False

    def stats(self) -> dict:
        """Serving counters of the remote teacher (op: stats)."""
        meta, _ = self._submit({"op": "stats"}).response()
        if not meta.get("ok"):
            raise tensor_wire.TensorWireError(
                meta.get("error", "stats failed"))
        return {k: v for k, v in meta.items() if k not in ("ok", "seq")}

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _zoo_model(model_name: str, num_classes: int,
               input_shape: tuple[int, ...], device):
    """The zoo model, seeded (the JAX CLI's ``PRNGKey(0)`` init; the RNG
    streams differ, so parity holds through ``--params``). Its Dense
    layers bind their input width up front: an MLP gets the flattened
    served shape."""
    from edl_tpu_torch.models import get_model

    kw = {"num_classes": num_classes, "device": device, "seed": 0}
    if model_name in ("mlp", "MLP"):
        kw["in_features"] = int(np.prod(input_shape))
    return get_model(model_name)(**kw)


def _restore_params(model, params_path: str) -> None:
    """Load the ``params``/``batch_stats`` sub-trees of a trainer's
    checkpoint (either package's; the optimizer state the serving
    process neither has nor wants is ignored) into ``model``. A remote
    URI (gs://, hdfs://, file://) is mirrored into a temp dir first."""
    import tempfile

    from edl_tpu_torch import bridge
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.utils.fs import split_scheme

    scheme, rest = split_scheme(params_path)
    if scheme not in ("", "file"):
        mgr = CheckpointManager(
            tempfile.mkdtemp(prefix="edl-teacher-params-"),
            remote=params_path)
    else:
        mgr = CheckpointManager(rest if scheme == "file" else params_path)
    try:
        restored = mgr.restore_raw()
        if restored is None:
            return
        raw, status = restored
        tree = {"params": raw["params"]}
        if raw.get("batch_stats"):
            tree["batch_stats"] = raw["batch_stats"]
        model.load_state_dict(bridge.flax_variables_to_torch(tree))
        log.info("teacher params restored from %s (epoch=%d)",
                 params_path, status.epoch)
    finally:
        mgr.close(raise_errors=False)


def _build_model_predict(model_name: str, num_classes: int, params_path: str,
                         input_key: str, output_key: str,
                         input_shape: tuple[int, ...] = (32, 32, 3),
                         input_dtype: str = "float32",
                         serve_topk: int = 0,
                         local_mesh: str = "",
                         input_normalize: str = "",
                         device: str = "cuda"):
    """CLI helper: a zoo model's forward with seeded or restored
    parameters on ``device`` (or over ``local_mesh``'s local devices);
    returns ``(predict, compressed_meta)`` (meta None without
    serve_topk). ``serve_topk > 0``: top-k runs ON THE DEVICE and only
    (idx, val) pairs cross to the host, at 1000 classes and K=16 a 62x
    smaller device->host copy a row. ``input_normalize`` ('imagenet' |
    'unit') normalizes raw pixels on the device, as the teacher was
    trained: students on the JPEG plane ship uint8."""
    from edl_tpu_torch.distill.sharded_teacher import (parse_local_mesh,
                                                       sharded_predict_fn)
    from edl_tpu_torch.ops.augment import normalize_image

    devices = (parse_local_mesh(local_mesh, device) if local_mesh
               else None)
    model = _zoo_model(model_name, num_classes, input_shape, device)
    if serve_topk > num_classes:
        log.warning("--serve-topk %d > %d classes; clamping", serve_topk,
                    num_classes)
        serve_topk = num_classes
    if params_path:
        _restore_params(model, params_path)
    norm = input_normalize or None

    def apply_with_norm(m, x):
        return m(normalize_image(x, norm))

    return sharded_predict_fn(
        apply_with_norm, model, device, devices=devices,
        input_key=input_key, output_key=output_key,
        input_dtype=np.dtype(input_dtype), serve_topk=serve_topk,
        classes=num_classes)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.distill.teacher_server",
        description="Serve a zoo model as a distill teacher")
    parser.add_argument("--model", default="mlp",
                        help="edl_tpu_torch.models factory name (mlp, "
                             "ResNet50_vd, CNNClassifier, ...)")
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--params", default="",
                        help="checkpoint dir (or gs:///hdfs:// mirror URI) "
                             "to restore params from")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=23900)
    parser.add_argument("--input-key", default="image")
    parser.add_argument("--output-key", default="logits")
    parser.add_argument("--input-shape", default="32,32,3",
                        help="per-sample input shape, e.g. 28,28,1")
    parser.add_argument("--input-dtype", default="float32",
                        help="float32 for images, int32 for token ids")
    parser.add_argument("--input-normalize", default="",
                        choices=("", "imagenet", "unit"),
                        help="pixel normalization of feeds on the device "
                             "(MUST match the teacher's training "
                             "preprocessing when students ship raw "
                             "uint8, e.g. the JPEG plane)")
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument("--batching", default="",
                        choices=("", "continuous", "window"),
                        help="batch admission mode (default: "
                             "EDL_TPU_SERVE_BATCHING or continuous)")
    parser.add_argument("--serve-topk", type=int, default=0,
                        help="device-side top-k: serve only K "
                             "(idx, fp16 val) pairs per row instead of "
                             "the dense class row")
    parser.add_argument("--local-mesh", default="",
                        help="drive several local cards from this one "
                             "process, e.g. 'dp=8' (sharded_teacher.py)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    shape = tuple(int(x) for x in args.input_shape.split(","))
    predict, compressed_meta = _build_model_predict(
        args.model, args.num_classes, args.params,
        args.input_key, args.output_key, shape,
        args.input_dtype, args.serve_topk, args.local_mesh,
        args.input_normalize, args.device)
    server = TeacherServer(predict, port=args.port, host=args.host,
                           max_batch=args.max_batch,
                           max_wait=args.max_wait_ms / 1000.0,
                           compressed_meta=compressed_meta,
                           batching=args.batching or None)
    server.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
