"""Typed metrics primitives and the per-process registry (copy of
``edl_tpu.obs.metrics``).

One scrape surface for the subsystems that each keep a ``stats()`` dict:
Counter/Gauge/Histogram primitives with FIXED log buckets (fixed, not a
reservoir, so two cumulative snapshots difference EXACTLY into a
windowed histogram and quantiles never drift under load), a process-wide
:class:`Registry`, a Prometheus-text scrape endpoint
(``EDL_TPU_METRICS_PORT``), and a JSON snapshot that can be published
into the coordination store so the Collector/scaler read the same
numbers a human scrapes. ``render()`` gives the JAX package's text byte
for byte for the same registry contents.

Existing ``stats()`` dicts stay the subsystem API: they register as
*sources* (``registry().register_stats("teacher", server.stats)``) and
the registry renders their numeric fields as gauges at collect time.
Collection NEVER runs a source callback while holding the registry
lock (sources take their own subsystem locks; holding ours across the
call would manufacture lock-order edges the lockgraph plane exists to
kill).

Pure stdlib: torch/numpy-free, asserted by ``python -m edl_tpu_torch.obs
selftest`` and the obs row in analysis/layers.toml.
"""

from __future__ import annotations

import bisect
import itertools
import json
import math
import re
import threading
import time
from typing import Any, Callable, Iterable

from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.obs.metrics")

# The canonical fixed log-bucket ladder (ms): the teacher server's
# LATENCY_BUCKETS_MS generalized — a 1/2.5/5-per-decade series wide
# enough for sub-ms wire ops and multi-second restores alike.
LOG_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                  500.0, 1000.0, 2500.0, 5000.0, 10000.0)

_INF = float("inf")


def log_buckets(lo: float, hi: float, per_decade: int = 3
                ) -> tuple[float, ...]:
    """A 1-2.5-5 log ladder covering [lo, hi] — fixed edges by
    construction, so snapshots taken at different times difference
    exactly bucket-by-bucket."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    steps = (1.0, 2.5, 5.0)[:max(1, min(per_decade, 3))]
    out = []
    decade = 10.0 ** math.floor(math.log10(lo))
    while decade <= hi:
        for s in steps:
            edge = decade * s
            if lo <= edge <= hi * (1 + 1e-9):
                out.append(edge)
        decade *= 10.0
    return tuple(out) or (hi,)


class Counter:
    """Monotonic cumulative count. Thread-safe; the lock is a leaf
    (no callback ever runs under it)."""

    __slots__ = ("name", "help", "_lock", "_v")
    kind = "counter"

    def __init__(self, name: str = "", help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Point-in-time value. Thread-safe leaf lock."""

    __slots__ = ("name", "help", "_lock", "_v")
    kind = "gauge"

    def __init__(self, name: str = "", help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Fixed-bucket cumulative histogram.

    ``edges`` are upper bounds; observations above the last edge land in
    the open-ended ``inf`` bucket. Because the edges never move, the
    windowed view over any interval is the exact per-bucket difference
    of two cumulative snapshots (:meth:`window`) — the property the
    teacher registrar's windowed p50/p95 differencing relies on, now a
    shared primitive instead of a pattern copied between modules.

    Snapshots use the same sparse ``{upper_edge: count}`` dict shape the
    Batcher already ships over the wire (keys may arrive as strings off
    JSON; :meth:`quantile` accepts both).
    """

    __slots__ = ("name", "help", "edges", "_lock", "_counts", "_sum", "_n")
    kind = "histogram"

    def __init__(self, edges: Iterable[float] = LOG_BUCKETS_MS,
                 name: str = "", help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self.edges = tuple(sorted(float(e) for e in edges))
        if not self.edges:
            raise ValueError("histogram needs at least one bucket edge")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.edges) + 1)   # +1 = inf bucket
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict[float, int]:
        """Sparse cumulative ``{upper_edge: count}`` (inf = overflow) —
        the exact shape the teacher's ``latency_hist_ms`` always had."""
        with self._lock:
            counts = list(self._counts)
        out: dict[float, int] = {}
        for edge, c in zip(self.edges, counts):
            if c:
                out[edge] = c
        if counts[-1]:
            out[_INF] = counts[-1]
        return out

    @staticmethod
    def window(cur: dict, prev: dict) -> dict[float, int]:
        """Exact windowed histogram: per-bucket difference of two
        cumulative snapshots (fixed edges line up by construction).
        Accepts string keys straight off the wire."""
        prev_n = {float(k): int(v) for k, v in (prev or {}).items()}
        out: dict[float, int] = {}
        for k, v in (cur or {}).items():
            d = int(v) - prev_n.get(float(k), 0)
            if d > 0:
                out[float(k)] = d
        return out

    @staticmethod
    def quantile(hist: dict, q: float) -> float | None:
        """q-quantile of a sparse ``{upper_edge: count}`` snapshot
        (keys may be strings off the wire). Answers the bucket's UPPER
        edge — conservative: a p95 read from this never under-reports,
        so an SLO decision made on it never under-provisions. None when
        empty."""
        items = sorted(((float(k), int(v)) for k, v in hist.items()),
                       key=lambda kv: kv[0])
        total = sum(c for _, c in items)
        if total <= 0:
            return None
        target = q * total
        cum = 0
        for edge, count in items:
            cum += count
            if cum >= target:
                return edge
        return items[-1][0]


Metric = Counter | Gauge | Histogram

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(raw: str) -> str:
    name = _SANITIZE.sub("_", str(raw))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _escape_label(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Registry:
    """Per-process metric registry + stats-dict source aggregator.

    ``counter``/``gauge``/``histogram`` are get-or-create by name (a
    kind clash raises — two subsystems silently sharing one name under
    different types is exactly the drift this plane exists to stop).
    ``register_stats`` adopts an existing ``stats() -> dict`` surface
    as a collect-time gauge source; the dict API stays the subsystem's
    contract and the registry is the view over it.
    """

    def __init__(self, namespace: str = "edl"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}     # guarded-by: _lock
        self._sources: dict[int, tuple[str, Callable[[], dict | None]]] = {}
        self._ids = itertools.count(1)
        self._scrapes = 0                          # guarded-by: _lock

    # -- typed metrics -----------------------------------------------------

    def _get_or_make(self, name: str, factory, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        return self._get_or_make(
            name, lambda: Counter(name, help), "counter")

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        return self._get_or_make(name, lambda: Gauge(name, help), "gauge")

    def histogram(self, name: str, edges: Iterable[float] = LOG_BUCKETS_MS,
                  help: str = "") -> Histogram:  # noqa: A002
        return self._get_or_make(
            name, lambda: Histogram(edges, name, help), "histogram")

    # -- stats-dict sources ------------------------------------------------

    def register_stats(self, kind: str,
                       fn: Callable[[], dict | None]) -> int:
        """Adopt a ``stats() -> dict`` surface; returns an unregister
        handle. The callable runs at collect time, NEVER under the
        registry lock."""
        handle = next(self._ids)
        with self._lock:
            self._sources[handle] = (kind, fn)
        return handle

    def unregister(self, handle: int) -> None:
        with self._lock:
            self._sources.pop(handle, None)

    # -- collection --------------------------------------------------------

    def _collect_sources(self) -> list[tuple[str, int, dict]]:
        """(kind, instance-id, stats dict) per live source. Callbacks
        run WITHOUT the registry lock; a throwing/closed source is
        skipped, never fatal to a scrape."""
        with self._lock:
            sources = list(self._sources.items())
        out = []
        seen: dict[str, int] = {}
        for _, (kind, fn) in sorted(sources):
            iid = seen.get(kind, 0)
            seen[kind] = iid + 1
            try:
                stats = fn()
            except Exception as exc:  # noqa: BLE001 — a dying subsystem
                # must not take the scrape surface down with it
                log.debug("stats source %s failed: %s", kind, exc)
                continue
            if isinstance(stats, dict):
                out.append((kind, iid, stats))
        return out

    def snapshot(self) -> dict:
        """JSON-safe full snapshot: typed metrics + every source's
        stats dict — what gets published into the coordination store
        so the Collector/scaler read the numbers a human scrapes."""
        with self._lock:
            metrics = list(self._metrics.items())
            scrapes = self._scrapes
        out: dict[str, Any] = {"ts": time.time(), "scrapes": scrapes,
                               "metrics": {}, "sources": {}}
        for name, m in metrics:
            if isinstance(m, Histogram):
                out["metrics"][name] = {
                    "kind": m.kind, "sum": m.sum, "count": m.count,
                    "hist": {str(k): v for k, v in m.snapshot().items()}}
            else:
                out["metrics"][name] = {"kind": m.kind, "value": m.value}
        for kind, iid, stats in self._collect_sources():
            out["sources"][f"{kind}/{iid}"] = stats
        return out

    def publish(self, store, key: str, lease: int = 0) -> None:
        """Best-effort snapshot into the coordination store (the
        Collector/scaler-visible copy of the scrape surface)."""
        try:
            store.put(key, json.dumps(self.snapshot(), sort_keys=True,
                                      default=str), lease=lease)
        except Exception as exc:  # noqa: BLE001 — observability must
            # never take a subsystem down
            log.debug("metrics snapshot publish failed: %s", exc)

    def render(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
            self._scrapes += 1
        ns = self.namespace
        lines: list[str] = []
        for name, m in metrics:
            full = _metric_name(f"{ns}_{name}")
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} {m.kind}")
            if isinstance(m, Histogram):
                snap = m.snapshot()
                cum = 0
                for edge in m.edges:
                    cum += snap.get(edge, 0)
                    lines.append(f'{full}_bucket{{le="{_fmt_value(edge)}"}}'
                                 f' {cum}')
                cum += snap.get(_INF, 0)
                lines.append(f'{full}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{full}_sum {_fmt_value(m.sum)}")
                lines.append(f"{full}_count {m.count}")
            else:
                lines.append(f"{full} {_fmt_value(m.value)}")
        for kind, iid, stats in self._collect_sources():
            base = _metric_name(f"{ns}_{kind}")
            for key in sorted(stats):
                value = stats[key]
                mname = _metric_name(f"{base}_{key}")
                if isinstance(value, bool):
                    value = int(value)
                if isinstance(value, (int, float)):
                    lines.append(f"# TYPE {mname} gauge")
                    lines.append(f'{mname}{{iid="{iid}"}} '
                                 f'{_fmt_value(float(value))}')
                elif isinstance(value, dict):
                    # sub-histogram shape ({bucket: count}) -> labeled.
                    # Keys ending "_by_<label>" (e.g. queue_depth_by_class,
                    # rejected_by_tenant) name their OWN label dimension
                    # instead of the generic "bucket", so per-tenant /
                    # per-class serving gauges come out as
                    # edl_teacher_..._by_class{class="high"} — directly
                    # aggregable in PromQL.
                    samples = [(k, v) for k, v in value.items()
                               if isinstance(v, (int, float))
                               and not isinstance(v, bool)]
                    if not samples:
                        continue
                    label = "bucket"
                    _, sep, suffix = key.rpartition("_by_")
                    if sep and suffix.isidentifier():
                        label = suffix
                    lines.append(f"# TYPE {mname} gauge")
                    for k, v in sorted(samples, key=lambda kv: str(kv[0])):
                        lines.append(
                            f'{mname}{{iid="{iid}",'
                            f'{label}="{_escape_label(k)}"}} '
                            f'{_fmt_value(float(v))}')
        return "\n".join(lines) + "\n"


_REGISTRY = Registry()
_serve_once = threading.Lock()
_serve_checked = False
_http = None


def registry() -> Registry:
    """The per-process registry. First use starts the scrape endpoint
    when ``EDL_TPU_METRICS_PORT`` is set (idempotent, best-effort)."""
    global _serve_checked
    if not _serve_checked:
        with _serve_once:
            if not _serve_checked:
                _serve_checked = True
                port = config.env_int("EDL_TPU_METRICS_PORT", 0)
                if port > 0:
                    serve(port)
    return _REGISTRY


def register_stats(kind: str, fn: Callable[[], dict | None]) -> int:
    return registry().register_stats(kind, fn)


def unregister(handle: int) -> None:
    _REGISTRY.unregister(handle)


class MetricsServer:
    """Threaded HTTP scrape endpoint: GET /metrics -> Prometheus text,
    GET /snapshot -> the JSON snapshot. One daemon thread + listening
    socket per process, torn down by close()."""

    def __init__(self, reg: Registry, port: int, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry_ref = reg

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path = self.path.split("?", 1)[0].rstrip("/") or "/metrics"
                if path == "/metrics":
                    body = registry_ref.render().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/snapshot":
                    body = json.dumps(registry_ref.snapshot(),
                                      default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # route into our logger
                log.debug("metrics http: " + fmt, *args)

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="edl-metrics-http")
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._thread.join(timeout=2.0)
        self._srv.server_close()


def serve(port: int, host: str = "127.0.0.1") -> MetricsServer | None:
    """Start (or return) the process's scrape endpoint. Best-effort: a
    busy port logs and returns None rather than failing the subsystem
    that happened to touch the registry first."""
    global _http
    if _http is not None:
        return _http
    try:
        # lifecycle: long-lived(process-wide scrape endpoint; stop_serving is the teardown)
        _http = MetricsServer(_REGISTRY, port, host)
        log.info("metrics scrape endpoint on %s:%d", host, _http.port)
    except OSError as exc:
        log.warning("metrics endpoint not started on port %d: %s",
                    port, exc)
        _http = None
    return _http


def stop_serving() -> None:
    global _http, _serve_checked
    if _http is not None:
        _http.close()
        _http = None
    _serve_checked = False
