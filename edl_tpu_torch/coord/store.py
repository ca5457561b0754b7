"""Coordination store: keys + leases + revisions + event history (copy
of ``edl_tpu.coord.store``).

This is the elastic job's membership substrate: TTL leases, watches and
put-if-absent rank claims. ``InMemStore`` is the engine, served over TCP
by the port's ``coord/server.py`` and used in-process by tests; the
``StoreClient`` (``coord/client.py``) speaks the same API over the wire
to that server, the JAX package's, or its C++ daemon.

Semantics:

- Global monotonically increasing **revision**; every mutation gets one.
- **Leases**: ``lease_grant(ttl)`` returns an id; keys put with a lease are
  deleted (with DELETE events) when the lease expires; ``lease_keepalive``
  refreshes the deadline. Expiry is checked lazily on every public call and
  by the server's sweeper thread.
- **Events**: bounded history of PUT/DELETE, queryable by
  ``events_since(revision, prefix)``; if the window was compacted the caller
  gets ``compacted=True`` and must fall back to a full ``get_prefix``.
- **Watches**: ``watch(prefix, start_revision)`` subscribes to the same
  PUT/DELETE stream as a push feed: per-watcher bounded queue, lease-expiry
  DELETEs included, compaction/overflow signalled as a ``compacted`` batch so
  the consumer resyncs via ``get_prefix``. ``EDL_TPU_COORD_WATCH=0``
  disables watches everywhere, and where a store gives no watch either
  (``try_watch`` returns None) every consumer falls back to its polling
  loop.
- **CAS**: ``put_if_absent`` is the rank-claim primitive.

The replicated store (``coord/replication.py``) drives the engine through
its replication hooks: passive followers (no local lease expiry),
commit-gated watch fan-out (``set_fanout_gate``/``release_fanout``), raw
apply at the leader's revisions, and full or delta snapshots.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field

from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.exceptions import EdlLeaseExpired


@dataclass(frozen=True)
class Record:
    key: str
    value: str
    revision: int
    lease: int = 0


@dataclass(frozen=True)
class Event:
    type: str  # "PUT" | "DELETE"
    key: str
    value: str
    revision: int


@dataclass
class _Lease:
    id: int
    ttl: float
    deadline: float
    keys: set[str] = field(default_factory=set)


@dataclass(frozen=True)
class WatchBatch:
    """One watch delivery: events (revision-ordered), the resume anchor
    `revision` (resume a new watch from here to miss nothing), and the
    `compacted` flag — True means events were lost (history compaction
    or watcher-queue overflow) and the consumer MUST resync with a full
    ``get_prefix`` before trusting incremental state again."""
    events: tuple[Event, ...]
    revision: int
    compacted: bool = False


def watch_resync_interval(default: float = 30.0) -> float:
    """How often event-driven consumers still run their full-poll resync
    safety net (EDL_TPU_WATCH_RESYNC_S). The net catches what events
    cannot promise: missed wakeups, redis TTL expiry (no event), and
    user-callback failures."""
    return max(0.1, config.env_float("EDL_TPU_WATCH_RESYNC_S", default))


def watch_enabled() -> bool:
    """The EDL_TPU_COORD_WATCH=0 escape hatch: restores pure polling in
    every converted consumer (read per call so tests can flip it)."""
    return config.env_flag("EDL_TPU_COORD_WATCH", True)


def try_watch(store: "Store", prefix: str = "", start_revision: int | None
              = None) -> "Watch | None":
    """A watch on `store`, or None when watches are disabled
    (EDL_TPU_COORD_WATCH=0), unsupported by this store flavor, or the
    subscribe itself fails — callers treat None as 'keep polling'."""
    if not watch_enabled():
        return None
    try:
        return store.watch(prefix, start_revision=start_revision)
    except Exception:  # noqa: BLE001 — unsupported flavor / transient
        return None


class Watch:
    """Handle for one watch stream (InMemStore, StoreClient and
    RedisStore each implement this shape).

    - ``get(timeout)`` -> next WatchBatch, or None on timeout/cancel.
    - ``progress_revision()`` -> the resume anchor when the queue is
      drained (None while batches are pending), used for heartbeats.
    - ``cancel()`` unsubscribes and wakes any blocked ``get``.
    """

    prefix: str = ""
    created_revision: int = 0
    # False when the flavor cannot deliver lease/TTL-expiry DELETEs
    # (redis pub/sub): consumers then keep their original poll cadence
    # for the resync net instead of the slow watch-mode cadence.
    expiry_events: bool = True

    def get(self, timeout: float | None = None) -> WatchBatch | None:
        raise NotImplementedError

    def progress_revision(self) -> int | None:
        raise NotImplementedError

    def cancel(self) -> None:
        raise NotImplementedError

    @property
    def cancelled(self) -> bool:
        raise NotImplementedError

    def __enter__(self) -> "Watch":
        return self

    def __exit__(self, *exc) -> None:
        self.cancel()


class InMemWatch(Watch):
    """In-process watch: bounded per-watcher queue fed under the store
    lock by ``_emit``. Overflow collapses the queue into one compacted
    batch rather than blocking the store or growing without bound."""

    def __init__(self, store: "InMemStore", prefix: str, max_pending: int):
        self._store = store
        self.prefix = prefix
        self._max = max_pending
        # Resume fence: events at or below this revision are already in
        # the subscriber's hands (its start_revision) and must never be
        # re-delivered — including by a commit-gate release of entries
        # that were applied-but-unreleased when the watcher resumed.
        self.min_revision = 0
        self._cond = threading.Condition()
        self._queue: deque[WatchBatch] = deque()  # guarded-by: _cond
        self._pending_events = 0                  # guarded-by: _cond
        self._cancelled = False                   # guarded-by: _cond

    # -- producer side (store lock held) ------------------------------------

    def _push(self, ev: Event) -> None:
        self._push_events((ev,))

    def _push_events(self, evs: tuple[Event, ...]) -> None:
        """Range-batched delivery: one WatchBatch — one revision header
        on the wire — carrying every event of a multi-key mutation
        (lease-expiry sweep, delete_prefix, a commit-gate release)
        instead of one batch per event."""
        with self._cond:
            if self._cancelled or not evs:
                return
            if self._pending_events + len(evs) > self._max:
                # lagging consumer: drop everything, force a resync
                self._queue.clear()
                self._pending_events = 0
                self._queue.append(WatchBatch((), evs[-1].revision, True))
            else:
                self._pending_events += len(evs)
                self._queue.append(WatchBatch(tuple(evs), evs[-1].revision))
            self._cond.notify_all()

    def _push_compacted(self, revision: int) -> None:
        with self._cond:
            if self._cancelled:
                return
            self._queue.append(WatchBatch((), revision, True))
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------

    def get(self, timeout: float | None = None) -> WatchBatch | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._queue and not self._cancelled:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            if self._queue:
                batch = self._queue.popleft()
                self._pending_events -= len(batch.events)
                return batch
            return None

    def progress_revision(self) -> int | None:
        # Atomic with _emit (both take the store lock): a None answer
        # means a batch is pending; a revision answer means every event
        # <= that revision in this prefix has already been delivered —
        # safe to advertise as the client's resume anchor.
        with self._store._lock:
            with self._cond:
                if self._queue or self._cancelled:
                    return None
                return self._store._visible_revision_locked()

    def cancel(self) -> None:
        self._store._unwatch(self)
        with self._cond:
            self._cancelled = True
            self._cond.notify_all()

    @property
    def cancelled(self) -> bool:
        with self._cond:
            return self._cancelled


class Store:
    """Abstract store API (implemented by InMemStore and StoreClient)."""

    def put(self, key: str, value: str, lease: int = 0) -> int:
        raise NotImplementedError

    def get(self, key: str) -> Record | None:
        raise NotImplementedError

    def get_prefix(self, prefix: str) -> tuple[list[Record], int]:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> int:
        raise NotImplementedError

    def put_if_absent(self, key: str, value: str, lease: int = 0) -> bool:
        raise NotImplementedError

    def compare_and_swap(self, key: str, expect: str | None, value: str,
                         lease: int = 0) -> bool:
        raise NotImplementedError

    def lease_grant(self, ttl: float) -> int:
        raise NotImplementedError

    def lease_keepalive(self, lease: int) -> bool:
        raise NotImplementedError

    def lease_revoke(self, lease: int) -> bool:
        raise NotImplementedError

    def events_since(self, revision: int, prefix: str = ""
                     ) -> tuple[list[Event], int, bool]:
        """Return (events, current_revision, compacted)."""
        raise NotImplementedError

    def watch(self, prefix: str = "", start_revision: int | None = None
              ) -> "Watch":
        """Subscribe to PUT/DELETE events under `prefix` as a push
        stream. ``start_revision`` replays history after that revision
        first (compacted batch when the window no longer covers it);
        None starts from now. Flavors without watches raise — use
        ``try_watch`` to fall back to polling."""
        raise NotImplementedError


_MAX_EVENTS = 4096
_MAX_WATCH_PENDING = 4096
# ttl given to a lease resurrected from replicated records alone (its
# grant entry predates the follower's catch-up window)
_DEFAULT_LEASE_TTL = 10.0


class InMemStore(Store):
    """Single-process store engine. Thread-safe; time injectable for tests."""

    def __init__(self, clock=time.monotonic, max_events: int = _MAX_EVENTS):
        self._clock = clock
        self._lock = threading.RLock()
        self._data: dict[str, Record] = {}    # guarded-by: _lock
        self._leases: dict[int, _Lease] = {}  # guarded-by: _lock
        self._revision = 0                    # guarded-by: _lock
        self._next_lease = 1                  # guarded-by: _lock
        self._events: list[Event] = []        # guarded-by: _lock
        self._max_events = max_events
        # events older than this were compacted
        self._first_event_rev = 1             # guarded-by: _lock
        self._watchers: list[InMemWatch] = []  # guarded-by: _lock
        # public Store-API calls served (bench: poll- vs watch-mode
        # request volume); watch deliveries are pushes, not requests
        self.op_count = 0                     # guarded-by: _lock
        # Passive mode (replication followers): lease expiry is the
        # LEADER's decision, shipped here as replicated DELETE events —
        # a follower that also expired locally would double-delete with
        # revisions the leader never assigned.
        self._passive = False                 # guarded-by: _lock
        # watch fan-out accounting: event pushes delivered to watcher
        # queues (the obs registry's view of the push plane)
        self._fanout_events = 0               # guarded-by: _lock
        self._expired_leases = 0              # guarded-by: _lock
        # Commit-gated watch fan-out (replicated stores only): when
        # gated, _emit buffers events instead of pushing them, and
        # release_fanout(commit_rev) delivers everything at or below
        # the majority-committed revision. Watchers therefore never
        # observe a doomed leader's uncommitted suffix — entries a
        # failover discards and whose revision numbers the next reign
        # reuses. Ungated stores
        # (the default) are unchanged: fan-out at apply time.
        self._gated = False                   # guarded-by: _lock
        self._gate_rev = 0                    # guarded-by: _lock
        self._pending_fanout: deque[Event] = deque()  # guarded-by: _lock
        # log-compaction + delta-snapshot accounting
        self._events_compacted = 0            # guarded-by: _lock
        self._delta_snapshots = 0             # guarded-by: _lock

    # -- internals ---------------------------------------------------------

    def _bump(self) -> int:  # holds-lock: _lock
        self._revision += 1
        return self._revision

    def _emit(self, ev: Event) -> None:  # holds-lock: _lock
        self._emit_many([ev])

    def _emit_many(self, evs: list[Event]) -> None:  # holds-lock: _lock
        """Append + fan out a multi-event mutation as ONE WatchBatch per
        watcher (range-batched event frames) instead of one per event —
        a host-lease expiry sweeping 40 pod registrations costs each
        watcher one queue append, not 40."""
        if not evs:
            return
        self._events.extend(evs)
        if len(self._events) > self._max_events:
            drop = len(self._events) - self._max_events
            self._first_event_rev = self._events[drop].revision
            del self._events[:drop]
        if self._gated:
            ready = [ev for ev in evs if ev.revision <= self._gate_rev]
            self._pending_fanout.extend(
                ev for ev in evs if ev.revision > self._gate_rev)
            if ready:
                self._fanout_push_many(ready)
            return
        self._fanout_push_many(evs)

    def _fanout_push(self, ev: Event) -> None:  # holds-lock: _lock
        self._fanout_push_many([ev])

    def _fanout_push_many(self, evs: list[Event]) -> None:  # holds-lock: _lock
        for watcher in self._watchers:
            fit = [ev for ev in evs
                   if ev.key.startswith(watcher.prefix)
                   and ev.revision > watcher.min_revision]
            if fit:
                watcher._push_events(tuple(fit))
                self._fanout_events += len(fit)

    def _expire(self) -> None:  # holds-lock: _lock
        if self._passive:
            return
        now = self._clock()
        dead = [l for l in self._leases.values() if l.deadline <= now]
        self._expired_leases += len(dead)
        for lease in dead:
            # one event batch per expired lease: every key the lease
            # carried (a whole host's pod registrations under lease
            # coalescing) sweeps in a single delivery
            evs = []
            for key in sorted(lease.keys):
                rec = self._data.pop(key, None)
                if rec is not None:
                    evs.append(Event("DELETE", key, rec.value, self._bump()))
            del self._leases[lease.id]
            self._emit_many(evs)

    def _check_lease(self, lease: int) -> None:  # holds-lock: _lock
        if lease and lease not in self._leases:
            raise EdlLeaseExpired(f"lease {lease} unknown or expired")

    def _detach(self, key: str, rec: Record) -> None:  # holds-lock: _lock
        if rec.lease and rec.lease in self._leases:
            self._leases[rec.lease].keys.discard(key)

    # -- Store API ---------------------------------------------------------

    def put(self, key: str, value: str, lease: int = 0) -> int:
        with self._lock:
            self.op_count += 1
            self._expire()
            self._check_lease(lease)
            old = self._data.get(key)
            if old is not None:
                self._detach(key, old)
            rev = self._bump()
            self._data[key] = Record(key, value, rev, lease)
            if lease:
                self._leases[lease].keys.add(key)
            self._emit(Event("PUT", key, value, rev))
            return rev

    def get(self, key: str) -> Record | None:
        with self._lock:
            self.op_count += 1
            self._expire()
            return self._data.get(key)

    def get_prefix(self, prefix: str) -> tuple[list[Record], int]:
        with self._lock:
            self.op_count += 1
            self._expire()
            recs = sorted(
                (r for k, r in self._data.items() if k.startswith(prefix)),
                key=lambda r: r.key,
            )
            return recs, self._revision

    def delete(self, key: str) -> bool:
        with self._lock:
            self.op_count += 1
            self._expire()
            rec = self._data.pop(key, None)
            if rec is None:
                return False
            self._detach(key, rec)
            self._emit(Event("DELETE", key, rec.value, self._bump()))
            return True

    def delete_prefix(self, prefix: str) -> int:
        with self._lock:
            self.op_count += 1
            self._expire()
            keys = [k for k in self._data if k.startswith(prefix)]
            evs = []
            for k in keys:
                rec = self._data.pop(k)
                self._detach(k, rec)
                evs.append(Event("DELETE", k, rec.value, self._bump()))
            self._emit_many(evs)
            return len(keys)

    def put_if_absent(self, key: str, value: str, lease: int = 0) -> bool:
        with self._lock:
            self.op_count += 1
            self._expire()
            if key in self._data:
                return False
            self._check_lease(lease)
            rev = self._bump()
            self._data[key] = Record(key, value, rev, lease)
            if lease:
                self._leases[lease].keys.add(key)
            self._emit(Event("PUT", key, value, rev))
            return True

    def compare_and_swap(self, key: str, expect: str | None, value: str,
                         lease: int = 0) -> bool:
        with self._lock:
            self.op_count += 1
            self._expire()
            cur = self._data.get(key)
            if expect is None:
                if cur is not None:
                    return False
            elif cur is None or cur.value != expect:
                return False
            self.put(key, value, lease)
            return True

    def lease_grant(self, ttl: float) -> int:
        with self._lock:
            self.op_count += 1
            self._expire()
            lease_id = self._next_lease
            self._next_lease += 1
            self._leases[lease_id] = _Lease(lease_id, ttl, self._clock() + ttl)
            return lease_id

    def lease_keepalive(self, lease: int) -> bool:
        with self._lock:
            self.op_count += 1
            self._expire()
            entry = self._leases.get(lease)
            if entry is None:
                return False
            entry.deadline = self._clock() + entry.ttl
            return True

    def lease_revoke(self, lease: int) -> bool:
        with self._lock:
            self.op_count += 1
            self._expire()
            entry = self._leases.pop(lease, None)
            if entry is None:
                return False
            evs = []
            for key in sorted(entry.keys):
                rec = self._data.pop(key, None)
                if rec is not None:
                    evs.append(Event("DELETE", key, rec.value, self._bump()))
            self._emit_many(evs)
            return True

    def events_since(self, revision: int, prefix: str = ""
                     ) -> tuple[list[Event], int, bool]:
        with self._lock:
            self.op_count += 1
            self._expire()
            if revision + 1 < self._first_event_rev:
                return [], self._revision, True
            evs = [e for e in self._events
                   if e.revision > revision and e.key.startswith(prefix)]
            return evs, self._revision, False

    @property
    def current_revision(self) -> int:
        with self._lock:
            return self._revision

    def sweep(self) -> None:
        """Expire due leases now (called by the server's sweeper thread).
        Not counted as a request: it is the server's own maintenance, and
        it is what turns lease expiry into DELETE events for watchers
        even when no client traffic arrives."""
        with self._lock:
            self._expire()

    # -- commit-gated fan-out (replicated stores) ----------------------------

    def set_fanout_gate(self, gated: bool) -> None:
        """Turn commit-gated watch delivery on/off. On enable, the gate
        starts at the current revision (everything already applied is
        considered committed — the replica plane enables the gate at
        construction, before any traffic). Disabling releases whatever
        is pending."""
        with self._lock:
            if self._gated == gated:
                return
            self._gated = gated
            self._gate_rev = self._revision
            if not gated:
                flush = list(self._pending_fanout)
                self._pending_fanout.clear()
                self._fanout_push_many(flush)

    @property
    def fanout_gated(self) -> bool:
        with self._lock:
            return self._gated

    def release_fanout(self, revision: int) -> None:
        """Deliver buffered events up to ``revision`` (the majority-
        committed revision, supplied by the replica plane). Idempotent;
        a revision ahead of the local log clamps to what exists."""
        with self._lock:
            if not self._gated:
                return
            revision = min(revision, self._revision)
            if revision <= self._gate_rev:
                return
            self._gate_rev = revision
            ready = []
            while self._pending_fanout \
                    and self._pending_fanout[0].revision <= revision:
                ready.append(self._pending_fanout.popleft())
            # one batch for the whole released range: a commit covering
            # N entries reaches each watcher as one frame, not N
            self._fanout_push_many(ready)

    def _visible_revision_locked(self) -> int:  # holds-lock: _lock
        """The revision watchers may use as a resume anchor: everything
        at or below it has been (or could have been) delivered. Gated
        stores answer the commit gate, not the raw apply point — an
        anchor past the gate could skip a reused revision after
        failover."""
        return self._gate_rev if self._gated else self._revision

    # -- watches -------------------------------------------------------------

    def watch(self, prefix: str = "", start_revision: int | None = None,
              max_pending: int = _MAX_WATCH_PENDING) -> InMemWatch:
        with self._lock:
            self._expire()
            watcher = InMemWatch(self, prefix, max_pending)
            watcher.created_revision = self._visible_revision_locked()
            if start_revision is not None:
                watcher.min_revision = start_revision
                if start_revision + 1 < self._first_event_rev:
                    watcher._push_compacted(self._visible_revision_locked())
                else:
                    # gated: replay only the committed prefix — the
                    # uncommitted tail is exactly _pending_fanout and
                    # will be pushed to this (now registered) watcher
                    # when the commit gate advances over it
                    horizon = self._gate_rev if self._gated \
                        else self._revision
                    replay = tuple(
                        ev for ev in self._events
                        if start_revision < ev.revision <= horizon
                        and ev.key.startswith(prefix))
                    watcher._push_events(replay)
            self._watchers.append(watcher)
            return watcher

    def _unwatch(self, watcher: InMemWatch) -> None:
        with self._lock:
            try:
                self._watchers.remove(watcher)
            except ValueError:
                pass  # already cancelled

    def watcher_count(self) -> int:
        with self._lock:
            return len(self._watchers)

    def stats(self) -> dict:
        """Engine counters as a dict view (what StoreServer registers
        into the per-process obs registry): request
        volume, watch fan-out, lease churn, history pressure."""
        with self._lock:
            return {"keys": len(self._data),
                    "revision": self._revision,
                    "ops": self.op_count,
                    "leases_live": len(self._leases),
                    "leases_expired": self._expired_leases,
                    "watchers": len(self._watchers),
                    "watch_fanout_events": self._fanout_events,
                    "events_buffered": len(self._events),
                    "events_compacted": self._events_compacted,
                    "delta_snapshots": self._delta_snapshots,
                    "fanout_gated": self._gated,
                    "fanout_pending": len(self._pending_fanout),
                    "passive": self._passive}

    def compact(self, revision: int, keep: int = 512) -> int:
        """Drop event history at or below ``revision``, always retaining
        the newest ``keep`` events as a resume cushion. Watchers resumed
        below the new floor get the normal ``compacted`` resync; the
        leader calls this once every peer's match revision has passed
        the compaction point, so healthy followers never pay it."""
        with self._lock:
            cut = 0
            limit = max(0, len(self._events) - max(0, keep))
            while cut < limit and self._events[cut].revision <= revision:
                cut += 1
            if cut:
                self._first_event_rev = self._events[cut].revision
                del self._events[:cut]
                self._events_compacted += cut
            return cut

    # -- replication raw-apply (coord/replication.py) ------------------------
    #
    # Followers mirror the leader's mutation log verbatim: the leader
    # assigned the revisions, so the apply path takes them as given
    # instead of minting new ones, never runs lease expiry (passive
    # mode), and still fans events out to local watchers — which is what
    # lets a follower serve reads and revision-resumable watch streams.

    def set_passive(self, passive: bool) -> None:
        """Follower mode on/off. Entering active (leader) mode rebuilds
        the lease->keys index from the records themselves (replicated
        PUTs carry the lease id) and restarts every lease's clock at
        now+ttl: the new leader cannot know how much TTL was left on the
        old leader's clock, so it gives every lease one full period —
        live owners keepalive long before that, dead owners expire one
        TTL late at worst (never early, which is the dangerous side)."""
        with self._lock:
            if self._passive == passive:
                return
            self._passive = passive
            if not passive:
                now = self._clock()
                for lease in self._leases.values():
                    lease.keys.clear()
                    lease.deadline = now + lease.ttl
                for key, rec in self._data.items():
                    if rec.lease:
                        entry = self._leases.get(rec.lease)
                        if entry is None:
                            # grant entry lost in catch-up (only its keys
                            # replicated): resurrect with a default ttl —
                            # the owner's keepalive re-arms it
                            entry = _Lease(rec.lease, _DEFAULT_LEASE_TTL,
                                           now + _DEFAULT_LEASE_TTL)
                            self._leases[rec.lease] = entry
                            self._next_lease = max(self._next_lease,
                                                   rec.lease + 1)
                        entry.keys.add(key)

    def apply_put(self, key: str, value: str, revision: int,
                  lease: int = 0) -> None:
        """Replicated PUT at the leader's revision (idempotent: a replay
        at or below the applied revision is a no-op)."""
        with self._lock:
            if revision <= self._revision:
                return
            old = self._data.get(key)
            if old is not None:
                self._detach(key, old)
            self._data[key] = Record(key, value, revision, lease)
            if lease:
                entry = self._leases.get(lease)
                if entry is None:
                    entry = _Lease(lease, _DEFAULT_LEASE_TTL,
                                   self._clock() + _DEFAULT_LEASE_TTL)
                    self._leases[lease] = entry
                self._next_lease = max(self._next_lease, lease + 1)
                entry.keys.add(key)
            self._revision = max(self._revision, revision)
            self._emit(Event("PUT", key, value, revision))

    def apply_delete(self, key: str, value: str, revision: int) -> None:
        """Replicated DELETE (lease expiry on the leader arrives here
        too — it is just a DELETE event in the log)."""
        with self._lock:
            if revision <= self._revision:
                return
            rec = self._data.pop(key, None)
            if rec is not None:
                self._detach(key, rec)
            self._revision = max(self._revision, revision)
            self._emit(Event("DELETE", key, value, revision))

    def apply_lease(self, lease_id: int, ttl: float) -> None:
        """Replicated lease grant/keepalive: (re)arm the follower-side
        deadline from ITS clock. Deadlines only matter after promotion
        (set_passive(False) re-bases them anyway); tracking them here
        keeps the table warm and the id counter monotonic."""
        with self._lock:
            entry = self._leases.get(lease_id)
            if entry is None:
                entry = _Lease(lease_id, ttl, 0.0)
                self._leases[lease_id] = entry
            entry.ttl = ttl
            entry.deadline = self._clock() + ttl
            self._next_lease = max(self._next_lease, lease_id + 1)

    def apply_lease_gone(self, lease_id: int) -> None:
        """Replicated revoke/expiry: the key DELETEs ride the event log
        separately; this only drops the table entry."""
        with self._lock:
            self._leases.pop(lease_id, None)

    def snapshot_state(self) -> dict:
        """Full-state document for follower catch-up when the event
        history no longer covers its revision (see install_snapshot)."""
        with self._lock:
            return {
                "revision": self._revision,
                "records": [[r.key, r.value, r.revision, r.lease]
                            for r in self._data.values()],
                "leases": [[l.id, l.ttl] for l in self._leases.values()],
            }

    def state_digest(self) -> dict:
        """Compact fingerprint of local state for delta-snapshot
        negotiation: per-key [key, revision, crc32(value)]. The value
        crc matters — a dirty ex-leader can hold the SAME revision
        number with a DIFFERENT value (uncommitted suffix, revisions
        reused by the next reign), so revision equality alone would
        silently keep divergent records."""
        with self._lock:
            return {
                "revision": self._revision,
                "keys": [[r.key, r.revision,
                          zlib.crc32(r.value.encode("utf-8"))]
                         for r in self._data.values()],
            }

    def snapshot_delta(self, digest: dict) -> dict:
        """Delta-compressed snapshot against a follower's digest: only
        records the follower lacks or holds divergently (``set``), plus
        keys it must drop (``del``). Leases ship in full — the table is
        tiny next to the keyspace. ``base`` records the digest size the
        delta was computed against (observability only)."""
        with self._lock:
            theirs = {row[0]: (int(row[1]), int(row[2]))
                      for row in digest.get("keys", ())}
            set_rows = []
            for key, rec in self._data.items():
                have = theirs.get(key)
                if have is None or have != (
                        rec.revision,
                        zlib.crc32(rec.value.encode("utf-8"))):
                    set_rows.append([rec.key, rec.value, rec.revision,
                                     rec.lease])
            del_keys = [k for k in theirs if k not in self._data]
            return {
                "revision": self._revision,
                "set": set_rows,
                "del": del_keys,
                "leases": [[l.id, l.ttl] for l in self._leases.values()],
                "base": len(theirs),
            }

    def install_snapshot_delta(self, doc: dict) -> None:
        """Apply a delta snapshot over current state. Same watcher
        contract as a full install: history before the snapshot
        revision is unknowable, so every local watcher gets a
        ``compacted`` resync batch."""
        with self._lock:
            for key in doc.get("del", ()):
                self._data.pop(key, None)
            for row in doc.get("set", ()):
                self._data[row[0]] = Record(row[0], row[1], row[2], row[3])
            self._leases = {}
            now = self._clock()
            for lease_id, ttl in doc.get("leases", ()):
                self._leases[lease_id] = _Lease(lease_id, ttl, now + ttl)
                self._next_lease = max(self._next_lease, lease_id + 1)
            # lease->keys index rebuilds on promotion (set_passive)
            # the leader's revision, even below ours: a revision past it
            # here is a discarded suffix, and keeping it would make the
            # leader's next writes at those numbers no-op replays
            self._revision = int(doc.get("revision", 0))
            self._events = []
            self._first_event_rev = self._revision + 1
            self._pending_fanout.clear()
            self._gate_rev = self._revision
            self._delta_snapshots += 1
            for watcher in self._watchers:
                watcher._push_compacted(self._revision)

    def install_snapshot(self, doc: dict) -> None:
        """Replace local state wholesale (lagging or divergent follower).
        Event history before the snapshot revision is gone by
        construction, so every local watcher gets an explicit
        ``compacted`` batch — the same resync contract as history
        compaction; a watch consumer cannot tell the difference and
        does not need to."""
        with self._lock:
            self._data = {r[0]: Record(r[0], r[1], r[2], r[3])
                          for r in doc.get("records", ())}
            self._leases = {}
            now = self._clock()
            for lease_id, ttl in doc.get("leases", ()):
                self._leases[lease_id] = _Lease(lease_id, ttl, now + ttl)
                self._next_lease = max(self._next_lease, lease_id + 1)
            # the leader's revision, even below ours (as in the delta
            # install above)
            self._revision = int(doc.get("revision", 0))
            self._events = []
            self._first_event_rev = self._revision + 1
            # a gated store's buffered-but-unreleased tail is exactly
            # the divergent suffix a snapshot rejoin discards: drop it
            # (watchers resync via the compacted batch below and never
            # see the doomed branch)
            self._pending_fanout.clear()
            self._gate_rev = self._revision
            for watcher in self._watchers:
                watcher._push_compacted(self._revision)
