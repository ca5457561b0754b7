"""Causal spans across the wire seams (trimmed copy of
``edl_tpu.obs.trace``: the in-band context both ways, the scoped span,
the span the teacher server opens per admission decision, and the
finished spans utils/timeline emits).

A sender attaches the span context current on its thread to a request
(the store wire's frames, a tensor frame's ``meta``) under the reserved
``"_tc"`` key (:func:`attach`); the receiving server pops it with
:func:`extract` and parents its span onto it, so a trace continues
across the hop, between the port and the JAX package in either
direction. :func:`span` makes a span current for its body.

Enablement: ``EDL_TPU_TRACE`` — unset/0 = off (a span is one attribute
read and an ``if``), ``1`` = on with the sink directory ``./edl_trace``,
any other value = on with that value as the sink directory. Finished
spans append to ``spans-<pid>.jsonl`` there and to a bounded in-process
ring (:func:`finished`).
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


def _new_id() -> str:
    return os.urandom(8).hex()


def current() -> tuple[str, str] | None:
    """The active ``(trace_id, span_id)`` on this thread, or None."""
    return getattr(_tls, "ctx", None)


def _emit(record: dict) -> None:
    global _file, _file_pid
    _ring.append(record)
    directory = _setting()[1]
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


def event(name: str, dur_s: float) -> None:
    """Emit a finished root span measured elsewhere (utils/timeline's
    path: the operation happened, only its duration is known)."""
    if not enabled():
        return
    now = time.time()
    _emit({"tid": _new_id(), "sid": _new_id(), "parent": None,
           "name": name, "pid": os.getpid(), "t0": round(now - dur_s, 6),
           "dur": round(dur_s, 6), "attrs": {}})


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
