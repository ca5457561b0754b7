"""Jittered exponential backoff, the one retry cadence of the store
client (copy of ``edl_tpu.utils.backoff``).

Fixed retry cadences synchronize: when a store dies, every client
retries on the same beat and the restarted store eats a thundering herd.
This schedule grows exponentially with full jitter (each delay drawn
uniformly from [base, current]) and resets on success. Deterministic
when constructed with a seeded ``rng``.
"""

from __future__ import annotations

import random
import threading


class Backoff:
    """One retry schedule: ``delay()`` returns the next jittered delay
    and advances the window; ``reset()`` on success; ``sleep(stop)``
    combines delay + interruptible wait.

    Not thread-safe by design — each retry loop owns its instance
    (sharing one schedule across threads would couple their cadences,
    which is the herd this class exists to break).
    """

    def __init__(self, base: float = 0.2, factor: float = 2.0,
                 max_delay: float = 5.0,
                 rng: random.Random | None = None):
        self.base = max(1e-3, base)
        self.factor = factor
        self.max_delay = max(self.base, max_delay)
        self._rng = rng or random.Random()
        self._current = self.base

    def delay(self) -> float:
        """Next delay: uniform over [base, current], then grow the
        window (full jitter — AWS-style decorrelation without the
        unbounded tail)."""
        d = self._rng.uniform(self.base, self._current)
        self._current = min(self.max_delay, self._current * self.factor)
        return d

    def reset(self) -> None:
        self._current = self.base

    def sleep(self, stop: threading.Event | None = None) -> bool:
        """Wait out the next delay; True means `stop` fired (caller
        should exit its retry loop, not retry again)."""
        d = self.delay()
        if stop is None:
            threading.Event().wait(d)
            return False
        return stop.wait(d)
