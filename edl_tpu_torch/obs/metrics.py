"""Fixed-bucket histogram, counter and stats-source registry (trimmed
copy of ``edl_tpu.obs.metrics``: what the teacher server and the comm
train step call).

Fixed edges, not a reservoir: two cumulative snapshots difference
exactly into a windowed histogram, and quantiles never drift under load.
A subsystem's ``stats()`` dict registers as a source; the registry reads
it at collect time, never while holding its own lock.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import time
from typing import Any, Callable, Iterable

from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.obs.metrics")

# The canonical fixed log-bucket ladder (ms), the JAX package's.
LOG_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                  500.0, 1000.0, 2500.0, 5000.0, 10000.0)

_INF = float("inf")


class Histogram:
    """Fixed-bucket cumulative histogram.

    ``edges`` are upper bounds; observations above the last edge land in
    the open-ended ``inf`` bucket. Snapshots are sparse ``{upper_edge:
    count}`` dicts (keys may arrive as strings off JSON; :meth:`quantile`
    accepts both).
    """

    __slots__ = ("edges", "_lock", "_counts")

    def __init__(self, edges: Iterable[float] = LOG_BUCKETS_MS):
        self.edges = tuple(sorted(float(e) for e in edges))
        if not self.edges:
            raise ValueError("histogram needs at least one bucket edge")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.edges) + 1)   # +1 = inf bucket

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1

    def snapshot(self) -> dict[float, int]:
        """Sparse cumulative ``{upper_edge: count}`` (inf = overflow)."""
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
        """q-quantile of a sparse ``{upper_edge: count}`` snapshot.
        Answers the bucket's UPPER edge — conservative: a p95 read from
        this never under-reports. None when empty."""
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


class Counter:
    """Monotonic cumulative count. Thread-safe; the lock is a leaf."""

    __slots__ = ("name", "help", "_lock", "_v")

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


class Registry:
    """Per-process aggregator of named counters and ``stats() -> dict``
    sources."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict[int, tuple[str, Callable[[], dict | None]]] = {}
        self._counters: dict[str, Counter] = {}
        self._ids = itertools.count(1)

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        """The counter named ``name``, created on first use."""
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, help)
            return c

    def register_stats(self, kind: str,
                       fn: Callable[[], dict | None]) -> int:
        """Adopt a ``stats() -> dict`` surface; returns an unregister
        handle."""
        handle = next(self._ids)
        with self._lock:
            self._sources[handle] = (kind, fn)
        return handle

    def unregister(self, handle: int) -> None:
        with self._lock:
            self._sources.pop(handle, None)

    def snapshot(self) -> dict[str, Any]:
        """``{"ts", "sources": {"kind/iid": stats}}``. Callbacks run
        WITHOUT the registry lock; a throwing source is skipped."""
        with self._lock:
            sources = sorted(self._sources.items())
        out: dict[str, Any] = {"ts": time.time(), "sources": {}}
        seen: dict[str, int] = {}
        for _, (kind, fn) in sources:
            iid = seen.get(kind, 0)
            seen[kind] = iid + 1
            try:
                stats = fn()
            except Exception as exc:  # noqa: BLE001 — a dying subsystem
                # must not take the scrape surface down with it
                log.debug("stats source %s failed: %s", kind, exc)
                continue
            if isinstance(stats, dict):
                out["sources"][f"{kind}/{iid}"] = stats
        return out


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-wide registry."""
    return _REGISTRY


def register_stats(kind: str, fn: Callable[[], dict | None]) -> int:
    return _REGISTRY.register_stats(kind, fn)


def unregister(handle: int) -> None:
    _REGISTRY.unregister(handle)
