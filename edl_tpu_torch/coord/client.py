"""Blocking store client speaking the framed-JSON protocol (trimmed copy
of ``edl_tpu.coord.client``: ``StoreClient``, ``ClientWatch``,
``LeaseKeeper``, ``HostLeaseCoalescer`` and ``host_coalescer``).

Implements the same ``Store`` API as ``InMemStore`` so the launcher's
code is backend-agnostic (in-process for tests, TCP for real jobs). The
``endpoint`` argument accepts a comma-joined list ("h0:p,h1:p"): the
client talks to one endpoint at a time, and transport errors rotate to
the next under a jittered exponential ``Backoff``. A replicated store's
``not_leader`` and ``redirect`` refusals, and watch streams through a
relay tier (``EDL_TPU_RELAY_ENDPOINTS``), are not ported: they raise
``EdlStoreError`` naming ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

import socket
import threading
import time

from collections import deque

from edl_tpu_torch.coord import wire
from edl_tpu_torch.coord.store import Event, Record, Store, Watch, \
    WatchBatch
from edl_tpu_torch.obs import metrics
from edl_tpu_torch.obs import recorder as flight
from edl_tpu_torch.utils import config, exceptions
from edl_tpu_torch.utils.backoff import Backoff
from edl_tpu_torch.utils.exceptions import EdlStoreError
from edl_tpu_torch.utils.logging import get_logger
from edl_tpu_torch.utils.net import split_endpoint

log = get_logger("edl_tpu_torch.coord.client")


def _unported(what: str) -> EdlStoreError:
    return EdlStoreError(f"{what} is not ported yet (ROADMAP Queue 1 "
                         "item 17)")


def _typed_error(message: str) -> EdlStoreError:
    """Re-hydrate server-side typed errors: the server serializes them as
    '<TypeName>: <msg>' (coord/server.py), and callers distinguish e.g.
    EdlLeaseExpired from generic store failures: the subtype must survive
    the wire, not only in-process stores."""
    name, _, rest = message.partition(":")
    cls = getattr(exceptions, name.strip(), None)
    if isinstance(cls, type) and issubclass(cls, EdlStoreError):
        return cls(rest.strip() or message)
    return EdlStoreError(message)


class StoreClient(Store):
    def __init__(self, endpoint: str, timeout: float = 5.0,
                 connect_retries: int = 30, retry_interval: float = 0.3):
        eps = [e for e in (p.strip() for p in endpoint.split(",")) if e]
        if not eps:
            raise EdlStoreError("empty store endpoint list")
        self._endpoint = ",".join(eps)  # display / compat
        self._timeout = timeout
        self._connect_retries = connect_retries
        self._retry_interval = retry_interval
        # endpoint-order state has its own small lock so the watch
        # reader thread can pick a dial target while a request holds
        # the main op lock
        self._ep_lock = threading.Lock()
        self._endpoints = eps          # guarded-by: _ep_lock
        self._cursor = 0               # guarded-by: _ep_lock
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None  # guarded-by: _lock

    # -- connection management --------------------------------------------

    def _candidates(self) -> list[str]:
        """Dial order: the endpoint list rotated so the most recently
        working endpoint leads."""
        with self._ep_lock:
            return self._endpoints[self._cursor:] \
                + self._endpoints[:self._cursor]

    def _note_connected(self, endpoint: str) -> None:
        with self._ep_lock:
            if endpoint in self._endpoints:
                self._cursor = self._endpoints.index(endpoint)

    def _rotate(self) -> None:
        with self._ep_lock:
            self._cursor = (self._cursor + 1) % len(self._endpoints)

    def _connect_once(self) -> socket.socket:
        """ONE pass over the candidate endpoints, no internal retry
        loop. Callers that own a reconnect cadence (ClientWatch's
        growing jittered backoff) use this so a dead server is dialed
        once per backoff step, not ``connect_retries`` rounds per step."""
        last: Exception | None = None
        for ep in self._candidates():
            try:
                sock = socket.create_connection(
                    split_endpoint(ep), timeout=self._timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._note_connected(ep)
                return sock
            except OSError as exc:
                last = exc
        raise EdlStoreError(
            f"cannot connect to store at {self._endpoint}: {last}")

    def _connect(self) -> socket.socket:
        last: EdlStoreError | None = None
        backoff = Backoff(base=self._retry_interval,
                          max_delay=self._retry_interval * 2)
        for _ in range(self._connect_retries):
            try:
                return self._connect_once()
            except EdlStoreError as exc:
                last = exc
            backoff.sleep()
        raise last if last is not None else EdlStoreError(
            f"cannot connect to store at {self._endpoint}")

    # Ops safe to re-send after a connection error. Mutating-but-idempotent
    # ops (put/delete) are included: re-applying them yields the same state.
    # put_if_absent / cas are NOT: the first send may have been applied with
    # the response lost, and a blind resend would report the wrong outcome
    # (e.g. a rank claim that succeeded looking lost). Those surface an
    # EdlStoreError and the caller decides (e.g. read back ownership).
    _RETRYABLE = frozenset({
        "get", "get_prefix", "events_since", "ping", "lease_keepalive",
        "put", "delete", "delete_prefix", "lease_revoke", "lease_grant",
    })

    def _call(self, **req) -> dict:
        retryable = req.get("op") in self._RETRYABLE
        with self._lock:
            transport_errors = 0
            while True:
                if self._sock is None:
                    self._sock = self._connect()
                try:
                    wire.send_msg(self._sock, req)
                    resp = wire.recv_msg(self._sock)
                except (OSError, wire.WireError) as exc:
                    self._drop_sock()
                    transport_errors += 1
                    if transport_errors >= (2 if retryable else 1):
                        raise EdlStoreError(
                            f"store rpc {req.get('op')} failed: {exc}"
                        ) from exc
                    self._rotate()
                    continue
                if resp.get("ok"):
                    return resp
                if resp.get("redirect") or resp.get("not_leader"):
                    # a replicated store's refusal: not applied, and the
                    # routing it asks for is item 17's
                    self._drop_sock()
                    flight.record("store_refusal", op=req.get("op"),
                                  hint=resp.get("leader"))
                    raise _unported(
                        f"store rpc {req.get('op')}: following a "
                        "replicated store's "
                        + ("redirect" if resp.get("redirect")
                           else "not_leader") + " refusal")
                raise _typed_error(resp.get("error", "unknown store error"))

    def _drop_sock(self) -> None:  # holds-lock: _lock
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop_sock()

    # -- Store API ---------------------------------------------------------

    def put(self, key: str, value: str, lease: int = 0) -> int:
        return self._call(op="put", key=key, value=value, lease=lease)["revision"]

    def get(self, key: str) -> Record | None:
        rec = self._call(op="get", key=key)["record"]
        return None if rec is None else Record(*rec)

    def get_prefix(self, prefix: str) -> tuple[list[Record], int]:
        resp = self._call(op="get_prefix", prefix=prefix)
        return [Record(*r) for r in resp["records"]], resp["revision"]

    def delete(self, key: str) -> bool:
        return self._call(op="delete", key=key)["deleted"]

    def delete_prefix(self, prefix: str) -> int:
        return self._call(op="delete_prefix", prefix=prefix)["count"]

    def put_if_absent(self, key: str, value: str, lease: int = 0) -> bool:
        return self._call(op="put_if_absent", key=key, value=value, lease=lease)["won"]

    def compare_and_swap(self, key: str, expect: str | None, value: str,
                         lease: int = 0) -> bool:
        return self._call(op="cas", key=key, expect=expect, value=value,
                          lease=lease)["won"]

    def lease_grant(self, ttl: float) -> int:
        return self._call(op="lease_grant", ttl=ttl)["lease"]

    def lease_keepalive(self, lease: int) -> bool:
        return self._call(op="lease_keepalive", lease=lease)["alive"]

    def lease_revoke(self, lease: int) -> bool:
        return self._call(op="lease_revoke", lease=lease)["revoked"]

    def events_since(self, revision: int, prefix: str = ""
                     ) -> tuple[list[Event], int, bool]:
        resp = self._call(op="events_since", revision=revision, prefix=prefix)
        return ([Event(*e) for e in resp["events"]], resp["revision"],
                resp["compacted"])

    def watch(self, prefix: str = "", start_revision: int | None = None,
              heartbeat: float = 2.0) -> "ClientWatch":
        """Long-lived watch stream on its own connection (the main
        socket stays strict request/response). Reconnects on any error
        and resumes from the last delivered revision, so events are
        delivered exactly once across server restarts — unless the
        server compacted past the resume point, in which case the
        consumer receives an explicit ``compacted`` batch. Watching
        through a relay tier (``EDL_TPU_RELAY_ENDPOINTS``) is refused."""
        if config.env_str("EDL_TPU_RELAY_ENDPOINTS", ""):
            raise _unported("EDL_TPU_RELAY_ENDPOINTS (watch streams "
                            "through a relay tier)")
        return ClientWatch(self, prefix, start_revision,
                           heartbeat=heartbeat)

    def ping(self) -> bool:
        try:
            self._call(op="ping")
            return True
        except EdlStoreError:
            return False

    def status(self) -> dict:
        """Role/term/leader/revision of the endpoint currently talked
        to."""
        return self._call(op="status")


class ClientWatch(Watch):
    """Client half of a watch stream: dedicated socket + reader thread.

    The reader pushes event/compacted batches into a local queue
    (heartbeat frames only advance the resume anchor). On any transport
    error it reconnects and re-subscribes from ``last seen revision``,
    which the server replays from its bounded event history — exactly
    once unless compacted, which is surfaced as a compacted batch. A
    reconnect therefore never silently loses or duplicates events.
    """

    def __init__(self, client: "StoreClient", prefix: str,
                 start_revision: int | None, *, heartbeat: float = 2.0,
                 reconnect_backoff: float = 0.2):
        self._client = client
        self.prefix = prefix
        self._heartbeat = heartbeat
        # shared jittered-exponential schedule (utils/backoff.py): a
        # fleet of watchers re-attaching after a leader kill must not
        # re-dial in lockstep
        self._backoff = Backoff(base=reconnect_backoff,
                                max_delay=max(1.0, reconnect_backoff * 10))
        self._last_rev = start_revision  # None until the first ack
        self.created_revision = start_revision or 0
        self._cond = threading.Condition()
        self._queue: deque[WatchBatch] = deque()  # guarded-by: _cond
        self._stop = threading.Event()
        self._sock: socket.socket | None = None   # guarded-by: _cond
        self._ready = threading.Event()   # first ack received
        self._rejected: str | None = None  # server refused the op
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"store-watch-{prefix}")
        self._thread.start()
        # Block until the subscription is established so "events after
        # watch() returned" is a real guarantee, not a race. A server
        # that REJECTS the op (no watch support) raises — try_watch
        # falls back to polling; a merely unreachable server keeps
        # retrying in the background instead.
        self._ready.wait(timeout=client._timeout)
        if self._rejected is not None:
            self.cancel()
            raise EdlStoreError(f"watch rejected: {self._rejected}")

    # -- reader thread -------------------------------------------------------

    def _run(self) -> None:
        first = True
        while not self._stop.is_set():
            try:
                # _connect_once, not _connect: the jittered backoff at
                # the bottom of THIS loop owns the retry cadence
                sock = self._client._connect_once()
            except EdlStoreError:
                if self._backoff.sleep(self._stop):
                    return
                continue
            with self._cond:
                if self._stop.is_set():
                    sock.close()
                    return
                self._sock = sock
            try:
                wire.send_msg(sock, {"op": "watch", "prefix": self.prefix,
                                     "start_revision": self._last_rev,
                                     "heartbeat": self._heartbeat})
                # heartbeats bound the silence: a server that stops
                # sending for several heartbeat periods is dead
                sock.settimeout(max(1.0, self._heartbeat * 5))
                ack = wire.recv_msg(sock)
                if not (ack.get("ok") and ack.get("watching")):
                    # an explicit refusal is permanent (op unsupported,
                    # or a replicated store's routing, item 17): surface
                    # it instead of reconnect-looping forever
                    self._rejected = str(ack.get("error", ack))
                    self._ready.set()
                    return
                self._backoff.reset()
                if self._last_rev is None:
                    self._last_rev = int(ack["revision"])
                    self.created_revision = self._last_rev
                self._ready.set()
                if not first:
                    log.info("watch %r resumed from revision %d",
                             self.prefix, self._last_rev)
                first = False
                while True:
                    msg = wire.recv_msg(sock)
                    events = tuple(Event(*e) for e in msg.get("events", ()))
                    revision = int(msg["revision"])
                    compacted = bool(msg.get("compacted"))
                    self._last_rev = revision
                    if events or compacted:
                        self._push(WatchBatch(events, revision, compacted))
            except (OSError, wire.WireError, KeyError, TypeError,
                    ValueError) as exc:
                if not self._stop.is_set():
                    log.debug("watch %r stream error (%s); reconnecting",
                              self.prefix, exc)
            finally:
                with self._cond:
                    self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass
            if self._backoff.sleep(self._stop):
                return

    def _push(self, batch: WatchBatch) -> None:
        with self._cond:
            self._queue.append(batch)
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------

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
            # shutdown, not just close: close alone does not wake a recv
            # blocked on another thread, which would then sit until the
            # next heartbeat (the join below would wait out its timeout)
            for end in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    end()
                except OSError:
                    pass
        self._thread.join(timeout=2.0)

    @property
    def cancelled(self) -> bool:
        return self._stop.is_set()


class LeaseKeeper:
    """Background thread refreshing a lease; ``on_lost`` fires once when
    a keepalive finds the lease gone."""

    def __init__(self, store: Store, lease: int, interval: float,
                 on_lost=None):
        self.store = store
        self.lease = lease
        self.interval = interval
        self.on_lost = on_lost
        self.lost = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"lease-keeper-{lease}")

    def start(self) -> "LeaseKeeper":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                alive = self.store.lease_keepalive(self.lease)
            except EdlStoreError as exc:
                log.warning("lease %d keepalive error: %s", self.lease, exc)
                continue
            if not alive:
                log.error("lease %d lost", self.lease)
                self.lost.set()
                if self.on_lost is not None:
                    self.on_lost()
                return

    def stop(self, revoke: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        if revoke and not self.lost.is_set():
            try:
                self.store.lease_revoke(self.lease)
            except EdlStoreError:
                pass


class HostLeaseCoalescer:
    """One host-scoped lease carrying ALL of the host's pod
    registrations, refreshed by a single keepalive write per interval.

    40 pods per host means 40x fewer keepalive writes hitting the store
    than per-pod leases. The TTL contract is unchanged:
    each keepalive re-arms deadline = now + ttl, never further, so
    coalescing reduces WRITE volume, not failure-detection latency.
    If the host lease expires, the store sweeps every attached
    registration in one event batch (store._expire emits per-lease
    batches) and each pod's ``on_lost`` callback fires here.

    - ``attach(key, on_lost)`` -> lease id to put the key under.
    - ``detach(key, delete=True)`` -> per-pod revoke: deletes only that
      key; siblings on the shared lease are untouched. The host lease
      itself is revoked when the last key detaches.
    """

    def __init__(self, store: Store, host_id: str, ttl: float = 10.0,
                 interval: float | None = None):
        self.store = store
        self.host_id = host_id
        self.ttl = ttl
        self.interval = interval if interval is not None \
            else max(0.05, ttl / 6.0)
        self._lock = threading.RLock()
        self._lease = 0                 # guarded-by: _lock
        self._attached: dict[str, object] = {}  # key -> on_lost|None
        self._stop = threading.Event()  # replaced per lease generation
        self.keepalives_sent = 0        # guarded-by: _lock
        self.leases_lost = 0            # guarded-by: _lock
        self.closed = False             # guarded-by: _lock
        self._obs = metrics.register_stats("lease_coalescer", self.stats)

    def lease(self) -> int:
        """The host lease id (granted + keepalive thread started on
        first use; re-granted after a loss)."""
        with self._lock:
            if self.closed:
                raise EdlStoreError(
                    f"lease coalescer for {self.host_id} is closed")
            if self._lease == 0:
                self._lease = self.store.lease_grant(self.ttl)
                self._stop = threading.Event()
                threading.Thread(
                    target=self._run, args=(self._lease, self._stop),
                    daemon=True,
                    name=f"host-lease-{self.host_id}").start()
            return self._lease

    def attach(self, key: str, on_lost=None) -> int:
        with self._lock:
            lease = self.lease()
            self._attached[key] = on_lost
            return lease

    def detach(self, key: str, delete: bool = False) -> None:
        with self._lock:
            self._attached.pop(key, None)
            empty = not self._attached and self._lease
        if delete:
            try:
                self.store.delete(key)
            except EdlStoreError:
                log.warning("coalescer detach: delete %r failed", key)
        if empty:
            self._retire()

    def _retire(self) -> None:
        with self._lock:
            if self._attached or not self._lease:
                return
            lease, self._lease = self._lease, 0
            self._stop.set()
        try:
            self.store.lease_revoke(lease)
        except EdlStoreError:
            pass  # ttl expiry collects it

    def _run(self, lease: int, stop: threading.Event) -> None:
        while not stop.wait(self.interval):
            try:
                alive = self.store.lease_keepalive(lease)
            except EdlStoreError as exc:
                log.warning("host lease %d keepalive error: %s", lease, exc)
                continue
            with self._lock:
                self.keepalives_sent += 1
            if not alive:
                if not stop.is_set():
                    self._on_host_lost(lease)
                return

    def _on_host_lost(self, lease: int) -> None:
        with self._lock:
            if self._lease != lease:
                return  # already retired / re-granted
            self._lease = 0
            attached = dict(self._attached)
            self._attached.clear()
            self.leases_lost += 1
        flight.record("lease_host_expire", host=self.host_id,
                      lease=lease, keys=len(attached))
        log.error("host lease %d (%s) lost: %d registrations swept",
                  lease, self.host_id, len(attached))
        for key, cb in attached.items():
            if cb is not None:
                try:
                    cb()
                except Exception:  # noqa: BLE001 — observer callbacks
                    log.exception("on_lost callback for %r failed", key)

    def stats(self) -> dict:
        with self._lock:
            return {"host": self.host_id,
                    "lease_batch_size": len(self._attached),
                    "keepalives_sent": self.keepalives_sent,
                    "leases_lost": self.leases_lost,
                    "active": 1 if self._lease else 0}

    def close(self, revoke: bool = True) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            self._attached.clear()
            lease, self._lease = self._lease, 0
            self._stop.set()
        if revoke and lease:
            try:
                self.store.lease_revoke(lease)
            except EdlStoreError:
                pass
        metrics.unregister(self._obs)


_coalescers: dict[tuple[int, str], HostLeaseCoalescer] = {}
_coalescer_lock = threading.Lock()


def host_coalescer(store: Store, host_id: str,
                   ttl: float = 10.0) -> HostLeaseCoalescer:
    """Process-wide coalescer per (store, host): every PodRegister on
    the host shares one lease + one keepalive thread."""
    with _coalescer_lock:
        key = (id(store), host_id)
        co = _coalescers.get(key)
        if co is None or co.closed:
            co = HostLeaseCoalescer(store, host_id, ttl)
            _coalescers[key] = co
        return co
