"""Causal spans across the wire seams, and their readers (port of
``edl_tpu.obs.trace``).

A sender attaches the span context current on its thread to a request
(the store wire's frames, a tensor frame's ``meta``) under the reserved
``"_tc"`` key (:func:`attach`); the receiving server pops it with
:func:`extract` and parents its span onto it, so a trace continues
across the hop, between the port and the JAX package in either
direction. :func:`span` makes a span current for its body.

Enablement: ``EDL_TPU_TRACE`` — unset/0 = off (a span is one attribute
read and an ``if``), ``1`` = on with the sink directory ``./edl_trace``,
any other value = on with that value as the sink directory. Finished
spans append to ``spans-<pid>.jsonl`` there (wall-clock timestamps, so
files from different processes merge) and to a bounded in-process ring
(:func:`finished`).

The readers merge a sink directory's files (:func:`load_spans`) into
per-trace trees (:func:`group_traces`, :func:`span_tree`), split each
resize trace into its phases (:func:`resize_phase_summary` over
:data:`RESIZE_PHASES`) and export Chrome-trace JSON (:func:`to_chrome`);
``python -m edl_tpu_torch.obs trace <dir>`` is their CLI. They read the
JAX package's span files as well, and give its readers' answers.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any

from edl_tpu_torch.utils import config

DEFAULT_DIR = "edl_trace"
RING_CAP = 4096

_tls = threading.local()
_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=RING_CAP)
_file = None          # guarded-by: _lock
_file_pid = None      # guarded-by: _lock (fork detection)
_cached: tuple[bool, str | None] | None = None


def _setting() -> tuple[bool, str | None]:
    """(enabled, sink_dir) — parsed once per process; tests reset via
    `reconfigure()`."""
    global _cached
    if _cached is None:
        raw = (config.env_str("EDL_TPU_TRACE") or "").strip()
        if not raw or raw.lower() in ("0", "false", "no", "off"):
            _cached = (False, None)
        elif raw.lower() in ("1", "true", "yes", "on"):
            _cached = (True, DEFAULT_DIR)
        else:
            _cached = (True, raw)
    return _cached


def reconfigure() -> None:
    """Re-read EDL_TPU_TRACE and drop the sink file handle and ring."""
    global _cached, _file, _file_pid
    with _lock:
        _cached = None
        if _file is not None:
            try:
                _file.close()
            except OSError:
                pass
        _file = None
        _file_pid = None
        _ring.clear()


def enabled() -> bool:
    return _setting()[0]


def sink_dir() -> str | None:
    return _setting()[1]


def _new_id() -> str:
    return os.urandom(8).hex()


def current() -> tuple[str, str] | None:
    """The active ``(trace_id, span_id)`` on this thread, or None."""
    return getattr(_tls, "ctx", None)


def _emit(record: dict) -> None:
    global _file, _file_pid
    _ring.append(record)
    directory = sink_dir()
    if directory is None:
        return
    line = json.dumps(record, separators=(",", ":"), default=str)
    with _lock:
        if _file is None or _file_pid != os.getpid():
            try:
                os.makedirs(directory, exist_ok=True)
                _file = open(os.path.join(
                    directory, f"spans-{os.getpid()}.jsonl"), "a")
                _file_pid = os.getpid()
            except OSError:
                return
        try:
            _file.write(line + "\n")
            _file.flush()
        except (OSError, ValueError):
            pass


class Span:
    """A started span; ``end()`` stamps the duration and emits it."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0",
                 "attrs", "_done")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str | None, attrs: dict | None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.time()
        self.attrs = dict(attrs or {})
        self._done = False

    @property
    def context(self) -> tuple[str, str]:
        return (self.trace_id, self.span_id)

    def end(self, **attrs: Any) -> None:
        if self._done:
            return
        self._done = True
        self.attrs.update(attrs)
        _emit({"tid": self.trace_id, "sid": self.span_id,
               "parent": self.parent_id, "name": self.name,
               "pid": os.getpid(), "t0": round(self.t0, 6),
               "dur": round(time.time() - self.t0, 6),
               "attrs": self.attrs})


def start_span(name: str, parent: tuple[str, str] | None = None,
               attrs: dict | None = None) -> Span | None:
    """Begin a span (None when tracing is off), a child of ``parent``,
    else of the thread's current span, else the root of a new trace.
    Does not alter the thread's current context: :func:`span` does."""
    if not enabled():
        return None
    ctx = parent if parent is not None else current()
    if ctx is not None:
        trace_id, parent_id = ctx
    else:
        trace_id, parent_id = _new_id(), None
    return Span(name, trace_id, _new_id(), parent_id, attrs)


@contextlib.contextmanager
def span(name: str, parent: tuple[str, str] | None = None,
         attrs: dict | None = None):
    """Scoped span: spans started inside the body (this thread, or remote
    through the wire seams) parent onto it. Yields the Span (None when
    tracing is off)."""
    if not enabled():
        yield None
        return
    s = start_span(name, parent=parent, attrs=attrs)
    prev = current()
    _tls.ctx = s.context
    try:
        yield s
    finally:
        _tls.ctx = prev
        s.end()


def instant(name: str, parent: tuple[str, str] | None = None,
            attrs: dict | None = None) -> None:
    """Zero-duration marker span (the 'first fresh util' tick)."""
    s = start_span(name, parent=parent, attrs=attrs)
    if s is not None:
        s.end()


def event(name: str, dur_s: float,
          parent: tuple[str, str] | None = None,
          attrs: dict | None = None) -> None:
    """Emit a finished span measured elsewhere (utils/timeline's path:
    the operation happened, only its duration is known). Parents onto
    the explicit, else the current context like any other span."""
    if not enabled():
        return
    ctx = parent if parent is not None else current()
    if ctx is not None:
        trace_id, parent_id = ctx
    else:
        trace_id, parent_id = _new_id(), None
    now = time.time()
    _emit({"tid": trace_id, "sid": _new_id(), "parent": parent_id,
           "name": name, "pid": os.getpid(),
           "t0": round(now - dur_s, 6), "dur": round(dur_s, 6),
           "attrs": dict(attrs or {})})


@contextlib.contextmanager
def adopt(ctx):
    """Make a remote context current for the body (no span of its own):
    spans opened inside parent onto the remote span. ``ctx`` may be
    None or malformed (straight off a wire frame): then a no-op."""
    ctx = parse_context(ctx)
    if ctx is None or not enabled():
        yield
        return
    prev = current()
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def parse_context(raw) -> tuple[str, str] | None:
    """Validate a wire-shaped context (list/tuple of two id strings) —
    garbled frames yield None, never an exception."""
    if (isinstance(raw, (list, tuple)) and len(raw) == 2
            and all(isinstance(x, str) and 0 < len(x) <= 64 for x in raw)):
        return (raw[0], raw[1])
    return None


def inject() -> list[str] | None:
    """The current context in wire shape (``["tid", "sid"]``), or None
    when tracing is off or no span is active."""
    ctx = current() if enabled() else None
    return [ctx[0], ctx[1]] if ctx is not None else None


def attach(d: dict) -> dict:
    """Copy-on-write attach of the current context to a wire dict under
    the reserved ``"_tc"`` key. Returns ``d`` untouched when there is
    nothing to add."""
    ctx = inject()
    if ctx is None or "_tc" in d:
        return d
    out = dict(d)
    out["_tc"] = ctx
    return out


def extract(d: dict) -> tuple[str, str] | None:
    """Pop the propagated context off a received wire dict; tolerant of
    absence and garbling."""
    if not isinstance(d, dict):
        return None
    return parse_context(d.pop("_tc", None))


def finished(prefix: str | None = None) -> list[dict]:
    """Snapshot of the in-process ring of finished spans (newest last),
    optionally filtered by name prefix."""
    spans = list(_ring)
    if prefix is not None:
        spans = [s for s in spans if s["name"].startswith(prefix)]
    return spans


def clear_ring() -> None:
    _ring.clear()


# -- merged-trace analysis (the CLI `python -m edl_tpu_torch.obs trace`
#    and chip_smoke's resize split read through these) --

def load_spans(directory: str) -> list[dict]:
    """Every span from every ``spans-*.jsonl`` in ``directory``
    (garbled lines skipped: a killed pod can tear its last write)."""
    out: list[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for fname in names:
        if not (fname.startswith("spans-") and fname.endswith(".jsonl")):
            continue
        try:
            with open(os.path.join(directory, fname)) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "tid" in rec:
                        out.append(rec)
        except OSError:
            continue
    return out


def group_traces(spans: list[dict]) -> dict[str, list[dict]]:
    """trace_id -> spans sorted by start time."""
    traces: dict[str, list[dict]] = {}
    for s in spans:
        traces.setdefault(s["tid"], []).append(s)
    for tid in traces:
        traces[tid].sort(key=lambda s: s.get("t0", 0.0))
    return traces


def span_tree(spans: list[dict]) -> list[tuple[dict, int]]:
    """Depth-first (span, depth) ordering of one trace's spans.
    Orphans (parent span lost with a killed process) surface at depth 0
    rather than disappearing."""
    by_id = {s["sid"]: s for s in spans}
    children: dict[str | None, list[dict]] = {}
    for s in spans:
        parent = s.get("parent")
        if parent is not None and parent not in by_id:
            parent = None
        children.setdefault(parent, []).append(s)
    for v in children.values():
        v.sort(key=lambda s: s.get("t0", 0.0))
    out: list[tuple[dict, int]] = []

    def walk(parent_id, depth):
        for s in children.get(parent_id, []):
            out.append((s, depth))
            walk(s["sid"], depth + 1)

    walk(None, 0)
    return out


# The resize phase vocabulary: span-name prefixes -> the phase they
# account to (the JAX package's, so both readers split a trace alike).
RESIZE_PHASES = (
    ("decision", ("scaler.decide", "resize.request")),
    ("actuation", ("resize.actuate",)),
    ("restore", ("resize.adopt", "resize.restore_peers")),
    ("first_fresh_util", ("resize.first_fresh_util",)),
)


def resize_phase_summary(spans: list[dict]) -> list[dict]:
    """Per-resize-trace phase breakdown: every trace containing a
    resize-family span becomes ``{trace_id, spans, t0, phases: {phase:
    seconds}, downtime_s}`` where downtime_s is the restore-phase span
    time (the measured survivor gap / peer-restore wall time)."""
    out = []
    for tid, tspans in sorted(group_traces(spans).items()):
        names = {s["name"] for s in tspans}
        if not any(n.startswith(("resize.", "scaler.decide"))
                   for n in names):
            continue
        phases: dict[str, float] = {}
        for phase, prefixes in RESIZE_PHASES:
            total = sum(s.get("dur", 0.0) for s in tspans
                        if s["name"].startswith(prefixes))
            if total or any(s["name"].startswith(prefixes)
                            for s in tspans):
                phases[phase] = round(total, 6)
        restore = [s for s in tspans
                   if s["name"].startswith(("resize.adopt",
                                            "resize.restore_peers"))]
        out.append({
            "trace_id": tid,
            "spans": len(tspans),
            "t0": min(s.get("t0", 0.0) for s in tspans),
            "phases": phases,
            "downtime_s": round(max((s.get("dur", 0.0) for s in restore),
                                    default=0.0), 6)})
    return out


def to_chrome(spans: list[dict]) -> dict:
    """Chrome-trace ("Trace Event Format") JSON — loadable in
    chrome://tracing and Perfetto. Complete ("X") events; each trace id
    gets a synthetic thread lane so concurrent resizes do not stack."""
    events = []
    lanes: dict[str, int] = {}
    for s in sorted(spans, key=lambda s: s.get("t0", 0.0)):
        lane = lanes.setdefault(s["tid"], len(lanes) + 1)
        events.append({
            "name": s["name"], "ph": "X", "cat": "edl",
            "ts": round(s.get("t0", 0.0) * 1e6, 1),
            "dur": max(round(s.get("dur", 0.0) * 1e6, 1), 1.0),
            "pid": s.get("pid", 0), "tid": lane,
            "args": dict(s.get("attrs") or {},
                         trace_id=s["tid"], span_id=s["sid"])})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
