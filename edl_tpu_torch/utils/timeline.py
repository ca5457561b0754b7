"""Env-gated per-stage host timeline and the device trace window (port of
``edl_tpu.utils.timeline``).

    tl = timeline("ckpt")            # nop unless profiling or tracing
    with tl.span("write"):
        ...
    tl.record("snapshot", t0)        # an explicit start time

Each op becomes a finished span in the port's span sink (``obs/trace``,
``EDL_TPU_TRACE``); with ``EDL_TPU_PROFILE=1`` it is also a
``timeline pid=... op ms`` line on stderr, buffered and flushed every 64
lines and at exit. Neither knob set: the nop, which costs nothing.

``DeviceTrace`` / ``device_trace`` are the device-side window: a
``torch.profiler`` trace of the CPU and, on a card, CUDA activity,
written as a Chrome trace (``trace-<pid>-<n>.json``) under ``logdir``.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import os
import sys
import threading
import time

from edl_tpu_torch.obs import trace as _trace
from edl_tpu_torch.utils import config


class _NopTimeline:
    __slots__ = ()
    enabled = False

    def span(self, op: str):
        return contextlib.nullcontext()

    def record(self, op: str, start: float) -> None:
        pass


_FLUSH_EVERY = 64
_buf_lock = threading.Lock()
_buf: list[str] = []         # guarded-by: _buf_lock
_atexit_armed = False        # guarded-by: _buf_lock


def _flush_stderr() -> None:
    with _buf_lock:
        lines, _buf[:] = list(_buf), []
    if lines:
        try:
            sys.stderr.write("\n".join(lines) + "\n")
            sys.stderr.flush()
        except (OSError, ValueError):
            pass


def _stderr_line(line: str) -> None:
    global _atexit_armed
    with _buf_lock:
        _buf.append(line)
        if not _atexit_armed:
            _atexit_armed = True
            atexit.register(_flush_stderr)
        flush = len(_buf) >= _FLUSH_EVERY
    if flush:
        _flush_stderr()


class _ObsTimeline:
    """Routes every op to the span sink and, when profiling, stderr."""

    __slots__ = ("name", "_stderr")
    enabled = True

    def __init__(self, name: str):
        self.name = name
        self._stderr = profiling_enabled()

    @contextlib.contextmanager
    def span(self, op: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(op, t0)

    def record(self, op: str, start: float) -> None:
        dur_s = time.monotonic() - start
        full = f"{self.name}.{op}"
        _trace.event(full, dur_s)
        if self._stderr:
            _stderr_line(f"timeline pid={os.getpid()} {full} "
                         f"{dur_s * 1e3:.3f}ms")


def profiling_enabled() -> bool:
    return config.env_flag("EDL_TPU_PROFILE", False)


def timeline(name: str):
    """The nop unless EDL_TPU_PROFILE=1 or EDL_TPU_TRACE is on."""
    if profiling_enabled() or _trace.enabled():
        return _ObsTimeline(name)
    return _NopTimeline()


_trace_ids = itertools.count()


class DeviceTrace:
    """A ``torch.profiler`` window: ``start()``, then ``stop()`` writes
    the Chrome trace under ``logdir`` and returns its path."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> str:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()   # the window's queued kernels
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace-{os.getpid()}-"
                                         f"{next(_trace_ids)}.json")
        prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace around a code region (the device-side
    counterpart of the reference's --profile window)."""
    window = DeviceTrace(logdir)
    window.start()
    try:
        yield window
    finally:
        window.stop()
