"""Discovery/balancer daemon: assigns teacher servers to distill clients
(copy of ``edl_tpu.distill.discovery_server``; it imports neither torch
nor numpy, so the daemon starts without the ML stack).

Capability of the reference's DiscoveryServicer + BalanceTable
(distill/discovery_server.py:28-100, distill/balance_table.py:331-613):

- students ``register`` under a service name and ``heartbeat`` every couple
  of seconds; responses carry their assigned teacher list as a versioned
  delta (servers included only when the client's version is stale);
- teacher membership comes from the coordination-store registry (written by
  ``edl_tpu_torch.distill.registrar``); a tick thread re-reads it,
  expires silent clients, and rebalances;
- multiple discovery replicas register themselves under ``__balance__`` and
  shard service names over a consistent-hash ring: a request for a service
  owned by another replica gets ``REDIRECT`` + the owner endpoint
  (balance_table.py:363-433 REDIRECT sharding).

Wire: the store's framed-JSON protocol (coord/wire.py). Statuses: OK,
ALREADY_REGISTER, UNREGISTERED, REDIRECT (reference enum
protos/distill_discovery.proto:21-51).

CLI:
    python -m edl_tpu_torch.distill.discovery_server --store 127.0.0.1:2379 \
        --port 23800
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import threading
import time

from edl_tpu_torch.coord import wire
from edl_tpu_torch.coord.redis_store import connect_store
from edl_tpu_torch.coord.consistent_hash import ConsistentHash
from edl_tpu_torch.coord.registry import Registration, ServiceRegistry
from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.distill.balance import ServiceBalance
from edl_tpu_torch.utils import net
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.distill.discovery_server")

BALANCE_SERVICE = "__balance__"
DISTILL_ROOT = "edl_distill"


class BalanceTable:
    """All per-service assignment state of one discovery replica."""

    def __init__(self, store: Store, endpoint: str, *,
                 root: str = DISTILL_ROOT, client_ttl: float = 6.0,
                 clock=time.monotonic):
        self.registry = ServiceRegistry(store, root=root)
        self.endpoint = endpoint
        self.client_ttl = client_ttl
        self._clock = clock
        self._lock = threading.RLock()
        self._services: dict[str, ServiceBalance] = {}
        self._ring = ConsistentHash()

    # -- ownership (REDIRECT sharding) -------------------------------------

    def refresh_ring(self) -> None:
        metas = self.registry.get_service(BALANCE_SERVICE)
        nodes = [m.server for m in metas]
        with self._lock:
            # Always include ourselves: a replica must not redirect away
            # requests just because its own registration hasn't landed yet.
            if self.endpoint not in nodes:
                nodes.append(self.endpoint)
            self._ring.set_nodes(nodes)

    def owner_of(self, service: str) -> str:
        with self._lock:
            return self._ring.lookup(service) or self.endpoint

    def _redirect(self, service: str) -> dict | None:
        owner = self.owner_of(service)
        if owner != self.endpoint:
            return {"ok": True, "status": "REDIRECT", "leader": owner}
        return None

    # -- client RPCs --------------------------------------------------------

    def _apply_registry(self, svc: ServiceBalance, metas) -> None:
        """Install a registry snapshot: servers AND busy scores, then
        rebalance — one helper so register() and tick() cannot drift.
        The busy tie-break must be live from the FIRST assignment:
        phase-1 keep preserves whatever links a rebalance creates, so a
        util-blind initial fill would freeze name-order links past
        every later tick."""
        svc.set_servers([m.server for m in metas])
        svc.set_utilization(*self._busy_scores(metas))
        svc.rebalance()

    def register(self, client_id: str, service: str) -> dict:
        redirect = self._redirect(service)
        if redirect is not None:
            return redirect
        with self._lock:
            # registry read INSIDE the lock: serialized against tick(),
            # so a stale snapshot can never overwrite a fresher one
            # (spurious teacher-drop + double version bump otherwise)
            metas = self.registry.get_service(service)
            svc = self._services.setdefault(service, ServiceBalance(service))
            fresh = svc.add_client(client_id, self._clock())
            self._apply_registry(svc, metas)
            links = svc.get(client_id)
            status = "OK" if fresh else "ALREADY_REGISTER"
            log.info("client %s -> service %s (%s, %d teachers)", client_id,
                     service, status, len(links.servers))
            return {"ok": True, "status": status,
                    "servers": list(links.servers), "version": links.version}

    def heartbeat(self, client_id: str, service: str, version: int) -> dict:
        redirect = self._redirect(service)
        if redirect is not None:
            return redirect
        with self._lock:
            svc = self._services.get(service)
            if svc is None or not svc.touch(client_id, self._clock()):
                return {"ok": True, "status": "UNREGISTERED"}
            links = svc.get(client_id)
            if links.version != version:
                return {"ok": True, "status": "OK",
                        "servers": list(links.servers),
                        "version": links.version}
            return {"ok": True, "status": "OK"}

    def deregister(self, client_id: str, service: str) -> dict:
        with self._lock:
            svc = self._services.get(service)
            if svc is not None and svc.remove_client(client_id):
                svc.rebalance()
            return {"ok": True, "status": "OK"}

    # -- tick ---------------------------------------------------------------

    @staticmethod
    def _busy_scores(metas) -> tuple[dict[str, float], dict[str, int],
                                     dict[str, dict[str, int]]]:
        """Registrar-published busy fractions (`util`), intake backlogs
        (`queue_depth`) and their per-priority-class split
        (`queue_depth_by_class`) from the info JSON — the balancer's
        blended tie-break (balance.py invariant I6). Any field may be
        missing independently (old-format registrars)."""
        scores: dict[str, float] = {}
        depths: dict[str, int] = {}
        by_class: dict[str, dict[str, int]] = {}
        for m in metas:
            try:
                doc = json.loads(m.info)
            except (json.JSONDecodeError, TypeError):
                continue  # no/old-format info: neutral score
            if not isinstance(doc, dict):
                continue
            try:
                scores[m.server] = float(doc["util"])
            except (KeyError, TypeError, ValueError):
                pass
            try:
                depths[m.server] = int(doc["queue_depth"])
            except (KeyError, TypeError, ValueError):
                pass
            split = doc.get("queue_depth_by_class")
            if isinstance(split, dict):
                try:
                    by_class[m.server] = {str(c): int(n)
                                          for c, n in split.items()}
                except (TypeError, ValueError):
                    pass
        return scores, depths, by_class

    def tick(self) -> None:
        """Refresh teacher membership, expire silent clients, rebalance."""
        try:
            self.refresh_ring()
        except Exception as exc:
            log.warning("ring refresh failed: %s", exc)
        with self._lock:
            names = list(self._services)
        for name in names:
            with self._lock:
                svc = self._services.get(name)
                if svc is None:
                    continue
                try:
                    # read inside the lock (as register() does): the
                    # snapshot installed is never older than one a
                    # concurrent caller installed before us
                    metas = self.registry.get_service(name)
                except Exception as exc:
                    log.warning("teacher poll for %s failed: %s", name,
                                exc)
                    continue
                dead = svc.expire_clients(self._clock(), self.client_ttl)
                for cid in dead:
                    log.info("client %s expired from %s", cid, name)
                self._apply_registry(svc, metas)

    def stats(self) -> dict:
        with self._lock:
            names = list(self._services)
        # Teacher-reported utilization (registry `info`, published by the
        # registrar's stats loop) — the scheduler-facing performance view.
        info: dict[str, dict] = {}
        for name in names:
            try:
                info[name] = {m.server: m.info
                              for m in self.registry.get_service(name)}
            except Exception as exc:
                log.warning("utilization read for %s failed: %s", name, exc)
                info[name] = {}
        with self._lock:
            return {name: {"servers": list(svc.servers),
                           "clients": len(svc.clients),
                           "loads": svc.loads(),
                           "utilization": info.get(name, {})}
                    for name, svc in self._services.items()}


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        table: BalanceTable = self.server.table  # type: ignore[attr-defined]
        sock: socket.socket = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                req = wire.recv_msg(sock)
            except (wire.WireError, OSError):
                return
            try:
                resp = self._dispatch(table, req)
            except Exception as exc:
                resp = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
            try:
                wire.send_msg(sock, resp)
            except OSError:
                return

    @staticmethod
    def _dispatch(table: BalanceTable, req: dict) -> dict:
        op = req.get("op")
        if op == "register":
            return table.register(req["client"], req["service"])
        if op == "heartbeat":
            return table.heartbeat(req["client"], req["service"],
                                   int(req.get("version", -1)))
        if op == "deregister":
            return table.deregister(req["client"], req["service"])
        if op == "stats":
            return {"ok": True, "stats": table.stats()}
        if op == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


class _ThreadingServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class DiscoveryServer:
    """In-process handle for a discovery replica (server + tick thread +
    self-registration under __balance__)."""

    def __init__(self, store: Store, *, port: int = 0,
                 host: str = "0.0.0.0", advertise: str | None = None,
                 root: str = DISTILL_ROOT, client_ttl: float = 6.0,
                 tick_interval: float = 1.0, lease_ttl: float = 10.0):
        self._server = _ThreadingServer((host, port), _Handler)
        self.port = self._server.server_address[1]
        if advertise is None:
            # Loopback binds advertise loopback (local test topology);
            # everything else advertises the routable host IP.
            adv_host = host if host.startswith("127.") else net.host_ip()
            advertise = f"{adv_host}:{self.port}"
        self.endpoint = advertise
        self.table = BalanceTable(store, self.endpoint, root=root,
                                  client_ttl=client_ttl)
        self._server.table = self.table  # type: ignore[attr-defined]
        self._tick_interval = tick_interval
        self._lease_ttl = lease_ttl
        self._stop = threading.Event()
        self._registration: Registration | None = None

    def start(self) -> "DiscoveryServer":
        if self._registration is not None:   # idempotent (e.g. start() + with)
            return self
        self._registration = self.table.registry.register(
            BALANCE_SERVICE, self.endpoint, ttl=self._lease_ttl)
        self.table.refresh_ring()
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="discovery-serve").start()
        threading.Thread(target=self._ticker, daemon=True,
                         name="discovery-tick").start()
        log.info("discovery server %s up", self.endpoint)
        return self

    def _ticker(self) -> None:
        while not self._stop.wait(self._tick_interval):
            self.table.tick()

    def stop(self) -> None:
        self._stop.set()
        if self._registration is not None:
            self._registration.stop()
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.distill.discovery_server",
        description="Distill discovery/balancer daemon")
    parser.add_argument("--store", default="127.0.0.1:2379")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=23800)
    parser.add_argument("--advertise", default=None,
                        help="endpoint other hosts reach us at")
    parser.add_argument("--root", default=DISTILL_ROOT)
    parser.add_argument("--client-ttl", type=float, default=6.0)
    parser.add_argument("--tick-interval", type=float, default=1.0)
    args = parser.parse_args(argv)
    server = DiscoveryServer(
        connect_store(args.store), port=args.port, host=args.host,
        advertise=args.advertise, root=args.root,
        client_ttl=args.client_ttl, tick_interval=args.tick_interval)
    server.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
