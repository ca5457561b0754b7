"""Coordination store: keys + leases + revisions + event history (the
client-facing part of ``edl_tpu.coord.store``).

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
  the consumer resyncs via ``get_prefix``. Where a store gives no watch
  (``try_watch`` returns None) every consumer falls back to its polling
  loop.
- **CAS**: ``put_if_absent`` is the rank-claim primitive.

The replicated store's hooks (passive followers, commit-gated fan-out,
raw apply, snapshots) are not ported (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import threading
import time
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


def try_watch(store: "Store", prefix: str = "", start_revision: int | None
              = None) -> "Watch | None":
    """A watch on `store`, or None when this store flavor has none or the
    subscribe itself fails — callers treat None as 'keep polling'."""
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
        # re-delivered.
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
        (lease-expiry sweep, delete_prefix)
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
        # watch fan-out accounting: event pushes delivered to watcher
        # queues (the obs registry's view of the push plane)
        self._fanout_events = 0               # guarded-by: _lock
        self._expired_leases = 0              # guarded-by: _lock
        # log-compaction accounting
        self._events_compacted = 0            # guarded-by: _lock

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

    def _visible_revision_locked(self) -> int:  # holds-lock: _lock
        """The revision watchers may use as a resume anchor: everything
        at or below it has been (or could have been) delivered."""
        return self._revision

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
                    replay = tuple(
                        ev for ev in self._events
                        if ev.revision > start_revision
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
        into the per-process obs registry): request volume, watch
        fan-out, lease churn, history pressure."""
        with self._lock:
            return {"keys": len(self._data),
                    "revision": self._revision,
                    "ops": self.op_count,
                    "leases_live": len(self._leases),
                    "leases_expired": self._expired_leases,
                    "watchers": len(self._watchers),
                    "watch_fanout_events": self._fanout_events,
                    "events_buffered": len(self._events),
                    "events_compacted": self._events_compacted}

    def compact(self, revision: int, keep: int = 512) -> int:
        """Drop event history at or below ``revision``, always retaining
        the newest ``keep`` events as a resume cushion. Watchers resumed
        below the new floor get the normal ``compacted`` resync."""
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

