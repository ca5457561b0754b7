"""Distributed lock and leader election over the coordination store
(port of ``edl_tpu.coord.lock``).

The lock is ``put_if_absent(key, owner, lease)``: held exactly as long
as the lease is kept alive, and taken by whoever's ``put_if_absent``
wins after it expires, so a partitioned holder's claim stops mattering
once its lease runs out. `DistributedLock` is the mutex; `LeaderElection`
adds campaigning and an ``is_leader()`` check that callers consult
before privileged writes (leadership is a lease-backed hint: the holder
re-validates it). ``LeaderElection.close`` resigns and joins the
loss-watcher thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.coord.lock")


class EdlLockError(EdlError):
    pass


class _Hold:
    """One acquisition's private state (lease, liveness, keeper)."""

    __slots__ = ("lease", "last_renewal", "lost", "stop", "keeper")

    def __init__(self, lease: int, last_renewal: float):
        self.lease = lease
        self.last_renewal = last_renewal
        self.lost = threading.Event()
        self.stop = threading.Event()
        self.keeper: threading.Thread | None = None


class DistributedLock:
    """Lease-backed mutual exclusion on one store key.

    Args:
      store: coordination store (client or in-mem).
      key: lock key (namespace it, e.g. "/job/locks/master").
      owner: unique holder id (pod id); stored as the key's value so
        holders are observable and release is owner-checked.
      ttl: lease seconds; the keepalive thread refreshes at ttl/3. If the
        process dies, the lock frees itself after <= ttl.
    """

    def __init__(self, store: Store, key: str, owner: str, *,
                 ttl: float = 10.0):
        self.store = store
        self.key = key
        self.owner = owner
        self.ttl = ttl
        self._hold: _Hold | None = None

    # -- acquisition --------------------------------------------------------

    def try_acquire(self) -> bool:
        """One non-blocking attempt; True iff this owner now holds it."""
        cur = self.store.get(self.key)
        if cur is not None:
            return cur.value == self.owner and self.held()
        lease = self.store.lease_grant(self.ttl)
        if not self.store.put_if_absent(self.key, self.owner, lease):
            self.store.lease_revoke(lease)
            return False
        # Per-hold state object, captured by this hold's keeper thread: a
        # stale keeper from a previous hold (release() joins with a
        # timeout, so one can outlive release) mutates only ITS hold's
        # state, never the new acquisition's.
        hold = _Hold(lease=lease, last_renewal=time.monotonic())
        hold.keeper = threading.Thread(target=self._keepalive, args=(hold,),
                                       name=f"edl-lock-{self.key}",
                                       daemon=True)
        self._hold = hold
        hold.keeper.start()
        log.info("lock %s acquired by %s", self.key, self.owner)
        return True

    def acquire(self, timeout: float | None = None,
                poll: float = 0.2) -> bool:
        """Block (up to timeout) until acquired.

        Waiters subscribe to the lock key and wake on the holder's
        DELETE (release or lease expiry) instead of re-polling every
        `poll` seconds — handoff latency becomes event latency. The
        poll is kept as a TTL-derived fallback: with an in-process
        store and no sweeper thread, a dead holder's lease only expires
        on a store *call*, so a pure event wait could sleep forever.
        EDL_TPU_COORD_WATCH=0 restores the original fixed-poll loop.
        """
        from edl_tpu_torch.coord.store import try_watch
        deadline = None if timeout is None else time.monotonic() + timeout
        watch = None
        try:
            while True:
                if self.try_acquire():
                    return True
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    return False
                if watch is None:
                    watch = try_watch(self.store, self.key)
                if watch is not None:
                    # fallback re-poll at a TTL-derived interval (see
                    # docstring); the DELETE event wakes us early
                    wait = max(poll, min(5.0, self.ttl / 2.0))
                    if deadline is not None:
                        wait = min(wait, deadline - now)
                    watch.get(timeout=max(wait, 0.0))
                else:
                    wait = poll if deadline is None \
                        else min(poll, deadline - now)
                    time.sleep(max(wait, 0.0))
        finally:
            if watch is not None:
                watch.cancel()

    # -- hold state ---------------------------------------------------------

    def held(self) -> bool:
        """True while this owner's lease-backed claim is PROVABLY live.

        Fencing: the answer is bounded by the last confirmed renewal's
        age, not by "no failure observed" — a stalled keepalive (GC
        pause, scheduler starvation, crashed thread) flips this False
        within ttl even though no loss event arrived, because by then the
        server may have expired the lease and elected someone else.
        Consult before every privileged action.
        """
        hold = self._hold
        return (hold is not None and not hold.lost.is_set()
                and time.monotonic() - hold.last_renewal < self.ttl)

    def _keepalive(self, hold: "_Hold") -> None:
        interval = max(0.05, self.ttl / 3.0)
        while not hold.stop.wait(interval):
            try:
                ok = self.store.lease_keepalive(hold.lease)
            except (EdlError, ConnectionError):
                ok = False
            if not ok:
                log.warning("lock %s: lease lost (owner %s)", self.key,
                            self.owner)
                hold.lost.set()
                return
            hold.last_renewal = time.monotonic()

    # -- release ------------------------------------------------------------

    def abandon(self) -> None:
        """Crash simulation: stop the keepalive WITHOUT
        revoking the lease, so the lock frees itself only when the TTL
        runs out — exactly what a killed holder's lock does. The hold
        is forgotten locally; a later try_acquire campaigns fresh."""
        hold, self._hold = self._hold, None
        if hold is None:
            return
        hold.stop.set()
        if hold.keeper is not None:
            hold.keeper.join(timeout=2)

    def release(self) -> None:
        hold, self._hold = self._hold, None
        if hold is None:
            return
        hold.stop.set()
        hold.keeper.join(timeout=2)
        if not hold.lost.is_set():
            # revoking OUR lease deletes only the key version attached to
            # it (etcd semantics) — a successor's lock, attached to its
            # own lease, is untouched, so this is inherently owner-checked
            try:
                self.store.lease_revoke(hold.lease)
            except (EdlError, ConnectionError):
                pass

    def __enter__(self) -> "DistributedLock":
        if not self.acquire():
            raise EdlLockError(f"could not acquire {self.key}")
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class LeaderElection:
    """Campaign for a leadership key; observe the current leader.

    Usage:
        election = LeaderElection(store, "/job/leader", pod_id)
        election.campaign()              # blocks until leader
        while election.is_leader():
            ... serve as master ...
    Followers call `leader()` to find who to talk to, and may pass
    `on_lost` to be notified when their own leadership lapses.
    """

    def __init__(self, store: Store, key: str, owner: str, *,
                 ttl: float = 10.0,
                 on_lost: Callable[[], None] | None = None):
        self.lock = DistributedLock(store, key, owner, ttl=ttl)
        self.store = store
        self.key = key
        self.owner = owner
        self._on_lost = on_lost
        self._watcher: threading.Thread | None = None

    def campaign(self, timeout: float | None = None) -> bool:
        ok = self.lock.acquire(timeout=timeout)
        if ok and self._on_lost is not None:
            self._watcher = threading.Thread(target=self._watch_lost,
                                             daemon=True)
            self._watcher.start()
        return ok

    def _watch_lost(self) -> None:
        # Poll held() rather than waiting on the loss event alone: a
        # stalled keepalive loses the lease without ever signalling. The
        # hold object is captured so a later re-campaign's new hold gets
        # its own watcher.
        hold = self.lock._hold
        if hold is None:
            return
        poll = max(0.05, self.lock.ttl / 4.0)
        while not hold.stop.wait(poll):
            if not self.lock.held() or self.lock._hold is not hold:
                if self._on_lost is not None and not hold.stop.is_set():
                    self._on_lost()
                return

    def is_leader(self) -> bool:
        return self.lock.held()

    def leader(self) -> str | None:
        rec = self.store.get(self.key)
        return rec.value if rec is not None else None

    def resign(self) -> None:
        self.lock.release()

    def close(self) -> None:
        """Teardown: resign (release joins the keepalive thread) and
        join the loss watcher. `resign` alone leaves the watcher to
        notice `hold.stop` within its poll period; close is the
        deterministic variant an owner's shutdown path wants."""
        watcher, self._watcher = self._watcher, None
        self.resign()
        if watcher is not None:
            watcher.join(timeout=2.0)
