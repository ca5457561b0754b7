"""Redis-backed Store: the discovery flavor (copy of
``edl_tpu.coord.redis_store``).

The discovery stack is generic over the ``Store`` interface, so the
flavor is one class: ``RedisStore`` speaks RESP2 (``coord/resp.py``) to
a real redis, or the bundled ``MiniRedis``, and ``ServiceRegistry``,
``TeacherRegistrar``, ``DiscoveryServer`` and ``DistillReader`` run over
it unchanged. Select it anywhere a store endpoint is accepted with a
``redis://host:port`` URI (``connect_store``).

Mapping:
- records live at their key as JSON ``{"v": value, "r": revision}``;
  revisions come from ``INCR !edl:rev`` so `get_prefix` stays
  monotonic (redis has no native revisions);
- a lease is ``!edl:lease:{id}`` (PEXPIRE'd) + a member set
  ``!edl:lease:{id}:k``; a key bound to the lease is written with
  ``SET ... PX ttl`` in ONE command (no TTL-less window a crash could
  leave behind), keepalive re-arms everything, revoke deletes: the
  TTL-key semantics a registrar heartbeat relies on.
  The lease is validated BEFORE the key is written: a put against an
  expired lease must not resurrect the key (a dead teacher would stay
  routable forever);
- prefix reads use SCAN (cursor loop), not KEYS: the discovery server
  polls every tick and KEYS blocks a production redis on the whole
  keyspace;
- watches ride pub/sub: every mutation issued THROUGH this class also
  PUBLISHes a JSON event on ``!edl:events``, and ``watch(prefix)``
  subscribes on a dedicated connection. Pub/sub is fire-and-forget (no
  revision history, no replay), so the contract is weaker than the
  edl store's: a (re)connect and any requested ``start_revision``
  surface as an explicit ``compacted`` batch (consumer resyncs via
  ``get_prefix``), and TTL expiry emits NO event (redis expires keys
  silently), which is exactly why every event consumer keeps its
  poll-resync safety net.
- scope: the redis flavor serves the DISCOVERY/DISTILL pillar.
  `compare_and_swap` is GET-compare-SET, correct only for single-writer
  keys (a Registration reclaiming its own key), which is all the
  discovery stack needs; CONTENDED cas (DistributedLock, task master,
  rank claims) and `events_since` history reads stay on the edl store.
  Out-of-scope methods raise EdlRedisError, a subclass of EdlStoreError,
  so the registry's bounded-retry paths treat it as a store failure
  rather than dying.

A record written by this class is read back by the JAX package's
``RedisStore`` and the reverse: the keys, the JSON and the lease layout
are the same. Stdlib only: no torch, jax or numpy.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque

from edl_tpu_torch.coord.resp import (RespClient, RespError, encode_command,
                                read_reply)
from edl_tpu_torch.coord.store import Event, Record, Store, Watch, WatchBatch
from edl_tpu_torch.utils.exceptions import EdlStoreError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.coord.redis_store")


class EdlRedisError(EdlStoreError):
    pass


_REV = "!edl:rev"
_LEASE_ID = "!edl:lease:id"
_EVENTS_CHANNEL = "!edl:events"


def _lease_key(lease: int) -> str:
    return f"!edl:lease:{lease}"


def _glob_escape(s: str) -> str:
    out = []
    for ch in s:
        if ch in "*?[]\\":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


class RedisStore(Store):
    """Store subset over RESP (see module docstring for the mapping)."""

    def __init__(self, endpoint: str, timeout: float = 10.0):
        self._endpoint = endpoint
        self._timeout = timeout
        self._client = RespClient(endpoint, timeout=timeout)

    def _publish_event(self, type_: str, key: str, value: str,
                       revision: int) -> None:
        """Best-effort watch feed: a failed PUBLISH only delays watchers
        until their resync tick — it must never fail the mutation."""
        if key.startswith("!edl:"):
            return  # bookkeeping keys are not record data
        try:
            self._client.command(
                "PUBLISH", _EVENTS_CHANNEL,
                json.dumps({"type": type_, "key": key, "value": value,
                            "revision": revision}, sort_keys=True))
        except EdlStoreError as exc:
            log.debug("event publish failed for %s %s: %s", type_, key, exc)

    def close(self) -> None:
        self._client.close()

    def ping(self) -> bool:
        try:
            return self._client.command("PING") == "PONG"
        except Exception:  # noqa: BLE001 — liveness probe
            return False

    # -- kv ----------------------------------------------------------------

    def _bump(self) -> int:
        return int(self._client.command("INCR", _REV))

    def _lease_ttl_ms(self, lease: int) -> int:
        """The live lease's REMAINING ttl (PTTL), so a key written late
        in a lease window expires WITH the lease rather than up to one
        full TTL after it — a dead teacher must not linger routable.
        Raises if the lease expired (validated BEFORE any key write —
        see module docstring)."""
        remaining = int(self._client.command("PTTL", _lease_key(lease)))
        if remaining < 0:  # -2 no key, -1 no TTL (never set by us)
            from edl_tpu_torch.utils.exceptions import EdlLeaseExpired
            raise EdlLeaseExpired(f"lease {lease} unknown or expired")
        return max(1, remaining)

    def _detach(self, key: str, old_blob: str | None,
                new_lease: int) -> None:
        """SREM the key from a previous lease's member set when the
        binding changes — otherwise a stale lease's keepalive keeps
        re-arming (and its revoke deletes) a key it no longer owns
        (InMemStore._detach's semantics)."""
        rec = self._decode(key, old_blob)
        if rec is not None and rec.lease and rec.lease != new_lease:
            self._client.command("SREM", _lease_key(rec.lease) + ":k", key)

    def _set(self, key: str, value: str, lease: int,
             nx: bool) -> tuple[bool, int]:
        rev = self._bump()
        blob = json.dumps({"v": value, "r": rev, "l": lease})
        args = ["SET", key, blob]
        ttl_ms = 0
        if lease:
            ttl_ms = self._lease_ttl_ms(lease)  # validate first
            args += ["PX", str(ttl_ms)]  # atomic value+TTL
        if nx:
            args.append("NX")
        old = None if nx else self._client.command("GET", key)
        ok = self._client.command(*args)
        if ok is None:
            return False, rev
        self._detach(key, old, lease)
        if lease:
            members = _lease_key(lease) + ":k"
            self._client.command("SADD", members, key)
            self._client.command("PEXPIRE", members, ttl_ms)
        self._publish_event("PUT", key, value, rev)
        return True, rev

    def put(self, key: str, value: str, lease: int = 0) -> int:
        return self._set(key, value, lease, nx=False)[1]

    def put_if_absent(self, key: str, value: str, lease: int = 0) -> bool:
        return self._set(key, value, lease, nx=True)[0]

    def _decode(self, key: str, blob: str | None) -> Record | None:
        if blob is None:
            return None
        try:
            doc = json.loads(blob)
            # non-record values (the !edl: revision/lease bookkeeping
            # keys parse as bare ints) surface in whole-keyspace scans,
            # e.g. the Collector's store-health snapshot
            return Record(key=key, value=doc["v"], revision=int(doc["r"]),
                          lease=int(doc.get("l", 0)))
        except (json.JSONDecodeError, KeyError, ValueError, TypeError):
            return None

    def get(self, key: str) -> Record | None:
        return self._decode(key, self._client.command("GET", key))

    def _scan(self, pattern: str) -> list[str]:
        """Cursor-looped SCAN (KEYS blocks a production redis on the
        whole keyspace; the discovery server polls every tick)."""
        keys, cursor = [], "0"
        while True:
            reply = self._client.command("SCAN", cursor, "MATCH", pattern,
                                         "COUNT", "512")
            cursor, batch = reply[0], reply[1] or []
            keys.extend(batch)
            if cursor == "0":
                return keys

    def get_prefix(self, prefix: str) -> tuple[list[Record], int]:
        keys = self._scan(_glob_escape(prefix) + "*")
        # the !edl: bookkeeping namespace (revision/lease counters and
        # member sets) is not record data — InMemStore keeps its
        # equivalents out of the keyspace entirely, so whole-keyspace
        # scans (e.g. the Collector's store-health tick) must not
        # surface or MGET it here either
        if not prefix.startswith("!edl:"):
            keys = [k for k in keys if not k.startswith("!edl:")]
        recs = []
        if keys:
            blobs = self._client.command("MGET", *keys)
            for key, blob in zip(keys, blobs):
                rec = self._decode(key, blob)
                if rec is not None:
                    recs.append(rec)
        recs.sort(key=lambda r: r.key)
        rev = int(self._client.command("GET", _REV) or 0)
        return recs, rev

    def delete(self, key: str) -> bool:
        blob = self._client.command("GET", key)
        self._detach(key, blob, new_lease=0)
        deleted = int(self._client.command("DEL", key)) > 0
        if deleted:
            rec = self._decode(key, blob)
            self._publish_event("DELETE", key,
                                rec.value if rec is not None else "",
                                self._bump())
        return deleted

    def delete_prefix(self, prefix: str) -> int:
        keys = self._scan(_glob_escape(prefix) + "*")
        if not keys:
            return 0
        blobs = self._client.command("MGET", *keys)
        for key, blob in zip(keys, blobs):
            self._detach(key, blob, new_lease=0)
        count = int(self._client.command("DEL", *keys))
        for key, blob in zip(keys, blobs):
            rec = self._decode(key, blob)
            if rec is not None:
                self._publish_event("DELETE", key, rec.value, self._bump())
        return count

    # -- leases ------------------------------------------------------------

    def lease_grant(self, ttl: float) -> int:
        lease = int(self._client.command("INCR", _LEASE_ID))
        ttl_ms = max(1, int(ttl * 1000))
        self._client.command("SET", _lease_key(lease),
                             json.dumps({"ttl_ms": ttl_ms}),
                             "PX", str(ttl_ms))
        return lease

    def lease_keepalive(self, lease: int) -> bool:
        blob = self._client.command("GET", _lease_key(lease))
        if blob is None:
            return False  # expired: the registrar re-registers
        ttl_ms = int(json.loads(blob)["ttl_ms"])
        self._client.command("PEXPIRE", _lease_key(lease), ttl_ms)
        members = self._client.command(
            "SMEMBERS", _lease_key(lease) + ":k") or []
        self._client.command("PEXPIRE", _lease_key(lease) + ":k", ttl_ms)
        for key in members:
            self._client.command("PEXPIRE", key, ttl_ms)
        return True

    def lease_revoke(self, lease: int) -> bool:
        members = list(self._client.command(
            "SMEMBERS", _lease_key(lease) + ":k") or [])
        existed = self._client.command("GET", _lease_key(lease)) is not None
        blobs = self._client.command("MGET", *members) if members else []
        targets = members + [_lease_key(lease), _lease_key(lease) + ":k"]
        self._client.command("DEL", *targets)
        # explicit revoke emits DELETE events (InMemStore parity); TTL
        # EXPIRY still cannot — redis drops keys silently, which is why
        # watch consumers keep their resync net (module docstring)
        for key, blob in zip(members, blobs):
            rec = self._decode(key, blob)
            if rec is not None:
                self._publish_event("DELETE", key, rec.value, self._bump())
        return existed

    # -- cas: SINGLE-WRITER keys only ---------------------------------------

    def compare_and_swap(self, key: str, expect: str | None, value: str,
                         lease: int = 0) -> bool:
        """GET-compare-SET, NOT atomic across writers.

        Sufficient for the discovery pillar's use — `Registration`
        reclaiming ITS OWN key after a lease lapse (coord/registry.py),
        where this registrant is the only writer of the key. CONTENDED
        cas users (DistributedLock, task master, rank claims) must stay
        on the edl store: two racing writers can both pass the compare
        here. The JAX package draws the same line.
        """
        cur = self._client.command("GET", key)
        cur_value = None if cur is None else \
            (self._decode(key, cur).value
             if self._decode(key, cur) is not None else None)
        if cur_value != expect:
            return False
        if expect is None:
            return self.put_if_absent(key, value, lease)
        return self._set(key, value, lease, nx=False)[0]

    # -- watches (pub/sub) ---------------------------------------------------

    def watch(self, prefix: str = "", start_revision: int | None = None
              ) -> "RedisWatch":
        """Pub/sub watch (module docstring has the weakened contract:
        no replay, so resume requests and reconnects surface as
        ``compacted`` batches, and TTL expiry emits no event)."""
        return RedisWatch(self._endpoint, prefix,
                          start_revision=start_revision,
                          timeout=self._timeout)

    # -- out of the redis flavor's scope ------------------------------------

    def events_since(self, revision: int, prefix: str = ""):
        raise EdlRedisError(
            "event history reads are not served by the redis flavor; "
            "use watch() (pub/sub, no replay) or poll get_prefix")


class RedisWatch(Watch):
    """SUBSCRIBE-fed watch stream over a dedicated RESP connection.

    Messages are ``{"type", "key", "value", "revision"}`` JSON on the
    ``!edl:events`` channel, filtered by prefix client-side. Because
    pub/sub has no history, anything that may have dropped messages —
    an explicit ``start_revision`` (we cannot replay) and every
    (re)connect after the first — delivers a ``compacted`` batch so the
    consumer resyncs via ``get_prefix``.
    """

    expiry_events = False  # TTL expiry is silent in redis

    def __init__(self, endpoint: str, prefix: str, *,
                 start_revision: int | None = None, timeout: float = 10.0,
                 reconnect_backoff: float = 0.2):
        from edl_tpu_torch.utils.net import split_endpoint
        self._addr = split_endpoint(endpoint)
        self.prefix = prefix
        self._timeout = timeout
        self._backoff = reconnect_backoff
        self._cond = threading.Condition()
        self._queue: deque[WatchBatch] = deque()
        self._stop = threading.Event()
        self._sock: socket.socket | None = None
        self._last_rev = 0
        if start_revision is not None:
            # no replay over pub/sub: force an immediate resync
            self._queue.append(WatchBatch((), start_revision, True))
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"redis-watch-{prefix}")
        self._thread.start()

    def _run(self) -> None:
        first = True
        while not self._stop.is_set():
            rf = None
            try:
                sock = socket.create_connection(self._addr,
                                                timeout=self._timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(None)  # idle channels are legal
            except OSError:
                if self._stop.wait(max(self._backoff, 1.0)):
                    return
                continue
            with self._cond:
                if self._stop.is_set():
                    sock.close()
                    return
                self._sock = sock
            try:
                sock.sendall(encode_command(("SUBSCRIBE", _EVENTS_CHANNEL)))
                rf = sock.makefile("rb")
                read_reply(rf)  # ["subscribe", channel, 1]
                if not first:
                    # the gap had no feed: events may be lost
                    self._push(WatchBatch((), self._last_rev, True))
                first = False
                while True:
                    msg = read_reply(rf)
                    if not (isinstance(msg, list) and len(msg) == 3
                            and msg[0] == "message"):
                        continue
                    try:
                        doc = json.loads(msg[2])
                        ev = Event(doc["type"], doc["key"], doc["value"],
                                   int(doc["revision"]))
                    except (json.JSONDecodeError, KeyError, TypeError,
                            ValueError):
                        continue
                    self._last_rev = max(self._last_rev, ev.revision)
                    if ev.key.startswith(self.prefix):
                        self._push(WatchBatch((ev,), ev.revision))
            except (RespError, OSError):
                pass
            finally:
                with self._cond:
                    self._sock = None
                if rf is not None:
                    try:
                        rf.close()
                    except OSError:
                        pass
                try:
                    sock.close()
                except OSError:
                    pass
            self._stop.wait(self._backoff)

    def _push(self, batch: WatchBatch) -> None:
        with self._cond:
            self._queue.append(batch)
            self._cond.notify_all()

    def get(self, timeout: float | None = None) -> WatchBatch | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._queue and not self._stop.is_set():
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            if self._queue:
                return self._queue.popleft()
            return None

    def progress_revision(self) -> int | None:
        with self._cond:
            if self._queue:
                return None
            return self._last_rev

    def cancel(self) -> None:
        self._stop.set()
        with self._cond:
            sock = self._sock
            self._sock = None
            self._cond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=2.0)

    @property
    def cancelled(self) -> bool:
        return self._stop.is_set()


def connect_store(endpoint: str, timeout: float = 10.0) -> Store:
    """Store from an endpoint string — every consumer's connection path.

    - ``redis://host:port`` -> RedisStore (discovery flavor);
    - ``h0:p,h1:p,h2:p`` -> StoreClient over the replica list
      (transparent leader failover within the group);
    - ``g0=h0:p,h1:p;g1=h2:p,...`` (or a flat list with
      ``EDL_TPU_STORE_SHARDS`` > 1) -> ShardedStoreClient routing
      registry prefixes across replica groups.
    """
    if endpoint.startswith("redis://"):
        return RedisStore(endpoint[len("redis://"):], timeout=timeout)
    from edl_tpu_torch.utils import config
    if ";" in endpoint or config.env_int("EDL_TPU_STORE_SHARDS", 1) > 1:
        from edl_tpu_torch.coord.replication import ShardedStoreClient
        return ShardedStoreClient(endpoint, timeout=timeout)
    from edl_tpu_torch.coord.client import StoreClient
    return StoreClient(endpoint, timeout=timeout)
