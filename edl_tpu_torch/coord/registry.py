"""Service registry on top of the coordination store (trimmed copy of
``edl_tpu.coord.registry``, over the port's store and LeaseKeeper).

Key convention (same spirit as the reference's
``/{root}/{service}/nodes/{server}`` with TTL leases,
discovery/etcd_client.py:181-196 and distill/redis/redis_store.py:38-45):

    /{root}/{service}/nodes/{server}  ->  JSON {"server": ..., "info": ...}

Pieces:

- ``ServiceRegistry.get_service[_with_revision]`` — snapshot reads
  (reference discovery/etcd_client.py:89-113).
- ``Registration`` — ephemeral registration: lease + keepalive thread +
  bounded re-register after expiry (reference discovery/register.py:41-77:
  refresh every ttl/6, re-register after expiry, bounded retries).
- ``ServiceWatcher`` — fires deduplicated add/remove/update callbacks
  from the store's watch stream (reference discovery/etcd_client.py:
  115-149 did this over etcd watches); the original poll loop is
  demoted to a slow resync safety net, and remains the primary path
  when watches are unavailable (redis TTL expiry emits no event) or
  disabled (EDL_TPU_COORD_WATCH=0).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass

from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.coord.client import LeaseKeeper
from edl_tpu_torch.utils import unique_name
from edl_tpu_torch.utils.exceptions import EdlRegisterError, EdlStoreError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.coord.registry")


@dataclass(frozen=True)
class ServerMeta:
    server: str   # "host:port"
    info: str     # opaque utilization/meta string
    revision: int = 0


class Registration:
    """Live ephemeral registration of one server under one service.

    Each Registration instance carries a unique ``token`` stored in the key's
    value. Re-registration after lease loss only reclaims the key if it is
    absent or still carries *our* token — a replacement process that
    legitimately re-claimed the same server identity is never stolen from.
    """

    def __init__(self, registry: "ServiceRegistry", service: str, server: str,
                 info: str, ttl: float, max_reregister: int = 45):
        self._registry = registry
        self.service = service
        self.server = server
        self.info = info
        self.ttl = ttl
        self.token = unique_name.client_id()
        self._max_reregister = max_reregister
        self._keeper: LeaseKeeper | None = None
        self._stopped = threading.Event()
        # Serializes _register/_on_lost/stop so a concurrent stop() cannot
        # leave a freshly created keeper running.
        self._lock = threading.Lock()
        with self._lock:
            self._register(initial=True)

    @property
    def key(self) -> str:
        return self._registry.node_key(self.service, self.server)

    def _value(self) -> str:
        return json.dumps({"server": self.server, "info": self.info,
                           "token": self.token})

    def _register(self, initial: bool) -> None:
        """Claim the key. Caller holds self._lock."""
        store = self._registry.store
        lease = store.lease_grant(self.ttl)
        if not store.put_if_absent(self.key, self._value(), lease):
            cur = store.get(self.key)
            owned = False
            if cur is not None:
                try:
                    owned = json.loads(cur.value).get("token") == self.token
                except json.JSONDecodeError:
                    pass
            if not (owned and not initial
                    and store.compare_and_swap(self.key, cur.value,
                                               self._value(), lease)):
                store.lease_revoke(lease)
                raise EdlRegisterError(
                    f"{self.key} already registered by another server")
        keeper = LeaseKeeper(
            store, lease, interval=max(self.ttl / 6.0, 0.05),
            on_lost=self._on_lost)
        if self._stopped.is_set():
            # stop() ran while we were registering — undo immediately.
            store.lease_revoke(lease)
            return
        self._keeper = keeper
        keeper.start()

    def _on_lost(self) -> None:
        for attempt in range(self._max_reregister):
            if self._stopped.is_set():
                return
            try:
                with self._lock:
                    if self._stopped.is_set():
                        return
                    self._register(initial=False)
                log.info("re-registered %s after lease loss (attempt %d)",
                         self.key, attempt + 1)
                return
            except (EdlStoreError, EdlRegisterError) as exc:
                log.warning("re-register %s failed: %s", self.key, exc)
                self._stopped.wait(0.5)
        log.error("giving up re-registering %s", self.key)

    def update_info(self, info: str) -> None:
        with self._lock:
            self.info = info
            if self._keeper is not None:
                self._registry.store.put(self.key, self._value(),
                                         self._keeper.lease)

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            if self._keeper is not None:
                self._keeper.stop(revoke=True)
                self._keeper = None


class ServiceWatcher:
    """Membership watcher: event-driven callbacks + poll-resync net.

    When the store serves watches, add/remove/update callbacks fire at
    event latency (PUT/DELETE on the service prefix, including
    lease-expiry DELETEs) and the full ``get_prefix`` diff only runs
    every ``resync_interval`` as a safety net (or immediately after a
    compacted batch or a throwing callback). Without watches
    (EDL_TPU_COORD_WATCH=0, redis flavor outage) the original
    ``interval`` poll loop is the whole mechanism.
    """

    def __init__(self, registry: "ServiceRegistry", service: str,
                 on_add=None, on_remove=None, on_update=None,
                 interval: float = 1.0, resync_interval: float | None = None):
        self._registry = registry
        self._service = service
        self._on_add = on_add
        self._on_remove = on_remove
        self._on_update = on_update
        self._interval = interval
        self._resync_interval = resync_interval
        self._stop = threading.Event()
        self._known: dict[str, ServerMeta] = {}
        self._watch = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"watch-{service}")

    def start(self) -> "ServiceWatcher":
        # Subscribe BEFORE the initial sync: events that land while the
        # snapshot is read are buffered and deduplicated afterwards
        # (same info + revision -> no second callback), so there is no
        # blind window between snapshot and stream.
        from edl_tpu_torch.coord.store import try_watch
        self._watch = try_watch(
            self._registry.store,
            self._registry.service_prefix(self._service))
        # Initial sync is best-effort: a transient store error here must not
        # leave the caller holding a watcher whose thread never started —
        # the loop will converge on the next event/tick.
        self._safe_sync()
        self._thread.start()
        return self

    def _sync(self) -> None:
        metas = self._registry.get_service(self._service)
        now = {m.server: m for m in metas}
        # _known is updated only AFTER a callback succeeds: if a consumer
        # callback throws (e.g. while splicing a hash ring), the event is
        # re-delivered on the next poll instead of being lost forever.
        for server in list(self._known):
            if server not in now:
                meta = self._known[server]
                if self._on_remove:
                    self._on_remove(meta)
                self._known.pop(server, None)
        for server, meta in now.items():
            old = self._known.get(server)
            if old is None:
                if self._on_add:
                    self._on_add(meta)
                self._known[server] = meta
            elif old.info != meta.info or old.revision != meta.revision:
                if self._on_update:
                    self._on_update(meta)
                self._known[server] = meta

    def _safe_sync(self) -> None:
        try:
            self._sync()
        except Exception as exc:
            # Never let a poll error or a throwing user callback kill the
            # watch thread — a silently-dead watcher means a permanently
            # stale membership view.
            log.warning("watch %s poll failed: %s: %s", self._service,
                        type(exc).__name__, exc)

    def _apply_events(self, events) -> None:
        """Incremental `_sync`: one event, one callback. `_known` is
        only updated after the callback returns, so a throwing consumer
        gets the event redelivered by the resync diff (same contract as
        the poll path)."""
        prefix = self._registry.service_prefix(self._service)
        for ev in events:
            server = ev.key[len(prefix):]
            try:
                if ev.type == "DELETE":
                    meta = self._known.get(server)
                    if meta is None:
                        continue
                    if self._on_remove:
                        self._on_remove(meta)
                    self._known.pop(server, None)
                    continue
                try:
                    doc = json.loads(ev.value)
                    meta = ServerMeta(doc["server"], doc.get("info", ""),
                                      ev.revision)
                except (json.JSONDecodeError, KeyError, TypeError):
                    # same skip rule as get_service: a malformed value
                    # must not fabricate membership the resync diff
                    # would then "remove"
                    log.warning("malformed registry value at %s", ev.key)
                    continue
                old = self._known.get(server)
                if old is None:
                    if self._on_add:
                        self._on_add(meta)
                    self._known[server] = meta
                elif old.info != meta.info or old.revision != meta.revision:
                    if self._on_update:
                        self._on_update(meta)
                    self._known[server] = meta
            except Exception as exc:  # noqa: BLE001 — user callback threw
                log.warning("watch %s callback failed on %s %s: %s",
                            self._service, ev.type, ev.key, exc)
                self._safe_sync()  # redeliver via the snapshot diff

    def _run(self) -> None:
        if self._watch is None:
            while not self._stop.wait(self._interval):
                self._safe_sync()
            return
        from edl_tpu_torch.coord.store import watch_resync_interval
        if self._resync_interval is not None:
            resync = self._resync_interval
        elif not self._watch.expiry_events:
            # redis pub/sub can't push TTL-expiry DELETEs: dead-server
            # removal still rides the poll, so keep the poll cadence
            resync = self._interval
        else:
            resync = watch_resync_interval(
                default=max(self._interval * 10, 30.0))
        next_resync = time.monotonic() + resync
        while not self._stop.is_set():
            batch = self._watch.get(
                timeout=max(0.0, next_resync - time.monotonic()))
            if self._stop.is_set():
                return
            if batch is None:  # resync safety net tick
                self._safe_sync()
                next_resync = time.monotonic() + resync
            elif batch.compacted:
                self._safe_sync()
            else:
                self._apply_events(batch.events)

    def servers(self) -> list[ServerMeta]:
        return sorted(self._known.values(), key=lambda m: m.server)

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.cancel()
        self._thread.join(timeout=2.0)


class ServiceRegistry:
    def __init__(self, store: Store, root: str = "edl"):
        self.store = store
        self.root = root.strip("/")

    def service_prefix(self, service: str) -> str:
        return f"/{self.root}/{service}/nodes/"

    def node_key(self, service: str, server: str) -> str:
        return self.service_prefix(service) + server

    # -- reads -------------------------------------------------------------

    def get_service(self, service: str) -> list[ServerMeta]:
        return self.get_service_with_revision(service)[0]

    def get_service_with_revision(self, service: str
                                  ) -> tuple[list[ServerMeta], int]:
        recs, rev = self.store.get_prefix(self.service_prefix(service))
        metas = []
        for rec in recs:
            try:
                doc = json.loads(rec.value)
                metas.append(ServerMeta(doc["server"], doc.get("info", ""),
                                        rec.revision))
            except (json.JSONDecodeError, KeyError):
                log.warning("malformed registry value at %s", rec.key)
        return metas, rev

    # -- writes ------------------------------------------------------------

    def register(self, service: str, server: str, info: str = "",
                 ttl: float = 10.0) -> Registration:
        return Registration(self, service, server, info, ttl)

    def register_permanent(self, service: str, server: str,
                           info: str = "") -> None:
        value = json.dumps({"server": server, "info": info})
        self.store.put(self.node_key(service, server), value)

    def deregister(self, service: str, server: str) -> bool:
        return self.store.delete(self.node_key(service, server))

    # -- watch -------------------------------------------------------------

    def watch_service(self, service: str, on_add=None, on_remove=None,
                      on_update=None, interval: float = 1.0,
                      resync_interval: float | None = None) -> ServiceWatcher:
        return ServiceWatcher(self, service, on_add, on_remove, on_update,
                              interval, resync_interval).start()
