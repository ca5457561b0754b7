"""Flight recorder: an always-on bounded ring of structured events
(copy of ``edl_tpu.obs.recorder``).

Every process keeps the last N notable control-plane events (store
failovers, host-lease expiries) in a fixed-size ring
(``EDL_TPU_FLIGHT_RECORDER_N``, default 256; 0 turns recording off).
Recording is a deque append under a leaf lock, cheap enough to leave on:
when a process dies, the ring holds the minutes before the crash.

Dump paths: an excepthook chain on a crash and ``SIGUSR2`` on demand
(``install_dump_handlers``), or ``dump_to(dir)`` explicitly.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any

from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.obs.recorder")

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Bounded ring of ``{ts, kind, **fields}`` events."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = config.env_int("EDL_TPU_FLIGHT_RECORDER_N",
                                      DEFAULT_CAPACITY)
        self.capacity = max(0, int(capacity))
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity or 1)       # guarded-by: _lock
        self._total = 0                      # guarded-by: _lock

    def record(self, kind: str, **fields: Any) -> None:
        if self.capacity <= 0:
            return
        event = {"ts": round(time.time(), 6), "kind": str(kind)}
        event.update(fields)
        with self._lock:
            self._ring.append(event)
            self._total += 1

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            events = list(self._ring)
        if kind is not None:
            events = [e for e in events if e.get("kind") == kind]
        return events

    @property
    def dropped(self) -> int:
        """Events that aged out of the ring (recorded - retained)."""
        with self._lock:
            return self._total - len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._total = 0

    def to_dict(self, reason: str = "dump") -> dict:
        with self._lock:
            events = list(self._ring)
            total = self._total
        return {"pid": os.getpid(), "dumped_at": round(time.time(), 6),
                "reason": reason, "capacity": self.capacity,
                "recorded_total": total,
                "dropped": total - len(events), "events": events}

    def dump(self, path: str, reason: str = "dump") -> str | None:
        """Write the ring as JSON; best-effort (a dump must never turn
        a crash into a different crash). Returns the path or None."""
        try:
            directory = os.path.dirname(path)
            if directory:
                os.makedirs(directory, exist_ok=True)
            doc = self.to_dict(reason)
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(doc, fh, sort_keys=True, default=str)
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 — dumping is best-effort
            return None


_GLOBAL = FlightRecorder()


def recorder() -> FlightRecorder:
    return _GLOBAL


def record(kind: str, **fields: Any) -> None:
    """Record into the process-global ring (the one the dump hooks
    write)."""
    _GLOBAL.record(kind, **fields)


def dump_to(directory: str, tag: str | None = None,
            reason: str = "dump") -> str | None:
    """Dump the global ring to ``<dir>/flight-<tag or pid>.json``."""
    name = f"flight-{tag or os.getpid()}.json"
    return _GLOBAL.dump(os.path.join(directory, name), reason=reason)


_hooks_installed = False
_hook_lock = threading.Lock()


def install_dump_handlers(directory: str, tag: str | None = None) -> None:
    """Crash + SIGUSR2 dump wiring (idempotent per process).

    - unhandled exception: dump ``flight-<tag>.json`` with the crash
      type recorded, then delegate to the previous excepthook;
    - SIGUSR2 (main thread only — signal API restriction): dump on
      demand without dying.
    """
    global _hooks_installed
    with _hook_lock:
        if _hooks_installed:
            return
        _hooks_installed = True
    prev_hook = sys.excepthook

    def _crash_hook(exc_type, exc, tb):
        record("crash", error=f"{exc_type.__name__}: {exc}")
        dump_to(directory, tag=tag, reason="crash")
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _crash_hook

    import signal as _signal

    def _usr2(signum, frame):  # noqa: ARG001 — signal signature
        path = dump_to(directory, tag=tag, reason="sigusr2")
        log.info("flight recorder dumped to %s", path)

    try:
        _signal.signal(_signal.SIGUSR2, _usr2)
    except (ValueError, AttributeError, OSError):
        # not the main thread / platform without SIGUSR2: crash-dump
        # wiring above still applies
        log.debug("SIGUSR2 dump handler not installed")
