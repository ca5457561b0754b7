"""Open-loop load generation for the teacher serving plane (port of
``edl_tpu.distill.loadgen``).

Arrival times come from a schedule alone, never from completions.
`TeacherClient` is the wrong tool for that twice over: it is not
thread-safe, and its ``max_inflight`` gate blocks the submitter on slow
responses, which turns the load into a closed loop and hides exactly the
overload it should show (coordinated omission). This module keeps its
own minimal connection: one send lock and one receiver thread per
endpoint, submits never wait on results, and latency is measured from
the request's *scheduled* arrival (a generator falling behind still
charges the delay to the server).

Accounting is per priority class: offered / completed / shed / error
counts, latency quantiles, and SLO attainment (completed within the SLO
as a fraction of OFFERED: a shed or lost request counts against its
class), plus each endpoint's first completion (when a grown teacher
began answering). The event timeline backs the shed-then-recover and
kill-then-recover checks.

Rejections (``{"rejected": true, ...}``) are terminal here: an open-loop
run measures shed offered load, it does not retry. A dead connection
fails its in-flight requests, is dropped, and the next arrival fails
over to another live endpoint (a teacher that dies unannounced).

Stdlib + numpy + tensor_wire only (no torch): the generator runs on
scheduler nodes next to the pool it probes. With the default feed,
`LoadStats.summary` is the JAX package's for the same events.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from collections import deque

import numpy as np

from edl_tpu_torch.data import tensor_wire
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.distill.loadgen")

DEFAULT_MIX = {"high": 0.2, "normal": 0.5, "low": 0.3}


def percentile(samples: list[float], q: float) -> float | None:
    """Nearest-rank percentile; None on no samples."""
    if not samples:
        return None
    xs = sorted(samples)
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]


class LoadStats:
    """Thread-safe per-class accounting shared by every connection."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._counts: dict[str, dict[str, int]] = {}  # guarded-by: _lock
        self._lat_ms: dict[str, list[float]] = {}     # guarded-by: _lock
        # (t_rel, class, outcome) — outcome in {"ok", "shed", "error"}
        self.events: list[tuple[float, str, str]] = []  # guarded-by: _lock
        # endpoint -> t_rel of its first completed request
        self.first_ok: dict[str, float] = {}            # guarded-by: _lock

    def _cls(self, cls: str) -> dict[str, int]:  # holds-lock: _lock
        return self._counts.setdefault(
            cls, {"offered": 0, "ok": 0, "shed": 0, "error": 0})

    def note_offered(self, cls: str) -> None:
        with self._lock:
            self._cls(cls)["offered"] += 1

    def note_done(self, cls: str, outcome: str,
                  latency_ms: float | None = None,
                  endpoint: str | None = None) -> None:
        t = self._clock() - self._t0
        with self._lock:
            self._cls(cls)[outcome] += 1
            if outcome == "ok" and latency_ms is not None:
                self._lat_ms.setdefault(cls, []).append(latency_ms)
            if outcome == "ok" and endpoint is not None:
                self.first_ok.setdefault(endpoint, t)
            self.events.append((t, cls, outcome))

    # -- recovery oracles ------------------------------------------------

    def first_event(self, outcome: str) -> float | None:
        with self._lock:
            ts = [t for t, _, o in self.events if o == outcome]
        return min(ts) if ts else None

    def ok_after(self, t: float, cls: str | None = None) -> int:
        """Completions after t — the recovery signal (work flows again
        after the first shed / after a teacher's kill)."""
        with self._lock:
            return sum(1 for et, ec, o in self.events
                       if o == "ok" and et > t
                       and (cls is None or ec == cls))

    def summary(self, slo_ms: float | dict | None = None) -> dict:
        dur = max(self._clock() - self._t0, 1e-9)
        with self._lock:
            counts = {c: dict(v) for c, v in self._counts.items()}
            lat = {c: list(v) for c, v in self._lat_ms.items()}
        by_class: dict[str, dict] = {}
        all_lat: list[float] = []
        for cls, c in sorted(counts.items()):
            samples = lat.get(cls, [])
            all_lat.extend(samples)
            slo = (slo_ms.get(cls) if isinstance(slo_ms, dict)
                   else slo_ms)
            attained = (sum(1 for x in samples if x <= slo)
                        if slo is not None else None)
            by_class[cls] = {
                **c,
                "shed_pct": round(100.0 * c["shed"]
                                  / max(c["offered"], 1), 1),
                "p50_ms": percentile(samples, 0.5),
                "p95_ms": percentile(samples, 0.95),
                "attainment": (round(attained / max(c["offered"], 1), 4)
                               if attained is not None else None),
            }
        total = {k: sum(c[k] for c in counts.values())
                 for k in ("offered", "ok", "shed", "error")}
        return {
            "duration_s": round(dur, 2),
            **total,
            "rps_offered": round(total["offered"] / dur, 1),
            "rps_sustained": round(total["ok"] / dur, 1),
            "p50_ms": percentile(all_lat, 0.5),
            "p95_ms": percentile(all_lat, 0.95),
            "by_class": by_class,
        }


class _Conn:
    """One pipelined connection: sends under a lock, one receiver
    thread matching FIFO responses to the pending deque (the server
    answers strictly in request order per connection)."""

    def __init__(self, endpoint: str, stats: LoadStats, *,
                 timeout: float = 5.0, clock=time.monotonic):
        from edl_tpu_torch.utils.net import split_endpoint
        host, port = split_endpoint(endpoint)
        self.endpoint = endpoint
        self._stats = stats
        self._clock = clock
        # lifecycle: long-lived(owned by the generator's conn pool;
        # closed on eviction/failure and in run_open_loop's finally)
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._pending: deque = deque()  # (t_sched, cls)  guarded-by: _lock
        self._dead = False              # guarded-by: _lock
        self._recv = threading.Thread(target=self._recv_loop, daemon=True,
                                      name=f"loadgen-recv-{endpoint}")
        self._recv.start()

    @property
    def alive(self) -> bool:
        with self._lock:
            return not self._dead

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def send(self, meta: dict, tensors: dict, cls: str,
             t_sched: float) -> bool:
        """False when the connection is (or just went) dead — the
        caller fails over; nothing was recorded for this request."""
        with self._lock:
            if self._dead:
                return False
            # enqueue BEFORE the bytes go out: the receiver may see the
            # response before send_tensors returns
            self._pending.append((t_sched, cls))
            try:
                tensor_wire.send_tensors(self._sock, meta, tensors)
                return True
            except (OSError, tensor_wire.TensorWireError):
                self._pending.pop()
                self._die_locked()
                return False

    def _recv_loop(self) -> None:
        while True:
            try:
                meta, _ = tensor_wire.recv_tensors(self._sock)
            except (OSError, tensor_wire.TensorWireError):
                with self._lock:
                    self._die_locked()
                return
            now = self._clock()
            with self._lock:
                if not self._pending:
                    continue  # late control response; ignore
                t_sched, cls = self._pending.popleft()
            if meta.get("rejected"):
                self._stats.note_done(cls, "shed")
            elif meta.get("ok"):
                self._stats.note_done(cls, "ok",
                                      (now - t_sched) * 1e3, self.endpoint)
            else:
                self._stats.note_done(cls, "error")

    def _die_locked(self) -> None:  # holds-lock: _lock
        """Fail every in-flight request once; idempotent."""
        if self._dead:
            return
        self._dead = True
        while self._pending:
            _, cls = self._pending.popleft()
            self._stats.note_done(cls, "error")
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            self._die_locked()
        self._recv.join(timeout=2.0)


def run_open_loop(endpoints, *, duration_s: float, rps: float,
                  rows: int = 4, feature_dim: int = 4,
                  mix: dict[str, float] | None = None, tenants: int = 2,
                  seed: int = 0, poisson: bool = True,
                  conn_timeout: float = 5.0, drain_s: float = 2.0,
                  stats: LoadStats | None = None,
                  stop: threading.Event | None = None,
                  on_arrival=None,
                  feed: dict | None = None) -> LoadStats:
    """Drive ``rps`` requests/sec of ``rows``-row predicts for
    ``duration_s`` against the pool and return the accounting.

    ``endpoints`` is a list of ``host:port`` strings or a zero-arg
    callable returning the CURRENT list (registry-backed: a drained or
    killed teacher drops out on the next refresh). Arrivals are Poisson
    (seeded) unless ``poisson=False`` (fixed spacing); each arrival
    picks its class from ``mix`` and its tenant round-robin, and tries
    up to two live endpoints before recording the request as an error
    (offered load is never silently un-offered). ``on_arrival(i, t)``
    is the fault hook: the caller kills a teacher mid-run from it.
    ``feed`` replaces the default ``{"x": zeros(rows, feature_dim)}``
    request tensors (a model's real input, e.g. images).
    """
    mix = dict(mix or DEFAULT_MIX)
    stats = stats or LoadStats()
    stop = stop or threading.Event()
    rng = random.Random(seed)
    classes = sorted(mix)
    weights = [mix[c] for c in classes]
    endpoints_fn = endpoints if callable(endpoints) else (lambda: endpoints)
    # one connection per (endpoint, class): the server completes each
    # connection's responses in request order, so classes sharing a
    # socket would head-of-line block high behind admitted low —
    # separate connections per class model separate tenant processes
    conns: dict[tuple[str, str], _Conn] = {}
    if feed is None:
        feed = {"x": np.zeros((rows, feature_dim), np.float32)}

    def conn_for(ep: str, cls: str) -> _Conn | None:
        key = (ep, cls)
        conn = conns.get(key)
        if conn is not None and conn.alive:
            return conn
        if conn is not None:
            conns.pop(key).close()
        try:
            # lifecycle: long-lived(pool-owned; closed on eviction + finally)
            conns[key] = _Conn(ep, stats, timeout=conn_timeout)
        except OSError:
            return None
        return conns[key]

    t0 = time.monotonic()
    t_next, sent, rr = 0.0, 0, 0
    try:
        while not stop.is_set():
            t_next += (rng.expovariate(rps) if poisson else 1.0 / rps)
            if t_next > duration_s:
                break
            delay = t0 + t_next - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if on_arrival is not None:
                on_arrival(sent, t_next)
            cls = rng.choices(classes, weights)[0]
            tenant = f"tenant{sent % max(tenants, 1)}"
            meta = {"op": "predict", "seq": sent, "tenant": tenant,
                    "priority": cls}
            stats.note_offered(cls)
            eps = endpoints_fn()
            delivered = False
            for attempt in range(2):
                if not eps:
                    break
                ep = eps[(rr + attempt) % len(eps)]
                conn = conn_for(ep, cls)
                # t_sched, not now: a generator running late still
                # charges the delay to the server (no coordinated
                # omission)
                if conn is not None and conn.send(meta, feed, cls,
                                                 t0 + t_next):
                    delivered = True
                    break
            rr += 1
            if not delivered:
                stats.note_done(cls, "error")
            sent += 1
        # grace for in-flight responses (bounded — a wedged teacher
        # fails its pending on close instead of hanging the run)
        deadline = time.monotonic() + drain_s
        while (time.monotonic() < deadline
               and any(c.pending() for c in conns.values())):
            time.sleep(0.02)
    finally:
        for conn in conns.values():
            conn.close()
    return stats
