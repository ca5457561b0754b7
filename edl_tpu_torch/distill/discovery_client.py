"""Student-side discovery client: register, heartbeat, cached teacher list
(copy of ``edl_tpu.distill.discovery_client``).

Capability of the reference's DiscoveryClient
(distill/discovery_client.py:47-253): registers with a discovery replica,
heartbeats on a background thread, follows REDIRECT to the shard owner,
re-registers after UNREGISTERED or connection loss, and caches the assigned
teacher list for lock-free reads by the distill pipeline.
"""

from __future__ import annotations

import socket
import threading

from edl_tpu_torch.coord import wire
from edl_tpu_torch.utils import net, unique_name
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.distill.discovery_client")


class EdlDiscoveryError(EdlError):
    pass


class DiscoveryClient:
    """One registration of this process under a distill service name.

    ``get_servers()`` is safe from any thread and never blocks on the
    network — it returns the last heartbeat's assignment.
    """

    def __init__(self, endpoints: str | list[str], service: str, *,
                 client_id: str | None = None, heartbeat_interval: float = 2.0,
                 timeout: float = 5.0, max_redirects: int = 8):
        if isinstance(endpoints, str):
            endpoints = [e for e in endpoints.split(",") if e]
        if not endpoints:
            raise EdlDiscoveryError("no discovery endpoints")
        self.endpoints = endpoints
        self.service = service
        self.client_id = client_id or unique_name.client_id()
        self.heartbeat_interval = heartbeat_interval
        self.timeout = timeout
        self.max_redirects = max_redirects

        self._sock: socket.socket | None = None
        self._connected_to: str | None = None
        self._servers: tuple[str, ...] = ()
        self._version = -1
        self._ready = threading.Event()   # set on first assignment (even ())
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- wire helpers -------------------------------------------------------

    def _dial(self, endpoint: str) -> socket.socket:
        host, port = net.split_endpoint(endpoint)
        sock = socket.create_connection((host, port), timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._connected_to = None

    def _call(self, **req) -> dict:
        if self._sock is None:
            raise EdlDiscoveryError("not connected")
        wire.send_msg(self._sock, req)
        resp = wire.recv_msg(self._sock)
        if not resp.get("ok"):
            raise EdlDiscoveryError(resp.get("error", "discovery error"))
        return resp

    # -- registration (with REDIRECT chasing) ------------------------------

    def _register_once(self, endpoint: str) -> dict:
        """Register at `endpoint`, following REDIRECTs. Leaves _sock
        connected to the shard owner on success."""
        target = endpoint
        for _ in range(self.max_redirects):
            self._close()
            self._sock = self._dial(target)
            self._connected_to = target
            resp = self._call(op="register", client=self.client_id,
                              service=self.service)
            status = resp.get("status")
            if status in ("OK", "ALREADY_REGISTER"):
                return resp
            if status == "REDIRECT":
                target = resp["leader"]
                log.info("redirected to shard owner %s", target)
                continue
            raise EdlDiscoveryError(f"register got status {status}")
        raise EdlDiscoveryError(
            f"redirect loop after {self.max_redirects} hops")

    def _register_any(self) -> dict:
        last: Exception | None = None
        for endpoint in self.endpoints:
            try:
                return self._register_once(endpoint)
            except (OSError, wire.WireError, EdlError) as exc:
                last = exc
                log.warning("register via %s failed: %s", endpoint, exc)
        self._close()
        raise EdlDiscoveryError(f"all discovery endpoints failed: {last}")

    def _install(self, resp: dict) -> None:
        if "servers" in resp:
            servers = tuple(resp["servers"])
            if servers != self._servers:
                log.info("teacher set -> %s (v%s)", list(servers),
                         resp.get("version"))
            self._servers = servers
            self._version = int(resp.get("version", -1))
            self._ready.set()

    # -- lifecycle ----------------------------------------------------------

    def start(self, timeout: float = 30.0) -> "DiscoveryClient":
        resp = self._register_any()
        self._install(resp)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"discovery-hb-{self.service}")
        self._thread.start()
        if not self._ready.wait(timeout):
            raise EdlDiscoveryError("no assignment within start timeout")
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            try:
                resp = self._call(op="heartbeat", client=self.client_id,
                                  service=self.service,
                                  version=self._version)
            except (OSError, wire.WireError, EdlError) as exc:
                log.warning("heartbeat failed (%s); re-registering", exc)
                self._reconnect()
                continue
            status = resp.get("status")
            if status == "OK":
                self._install(resp)
            elif status in ("UNREGISTERED", "REDIRECT"):
                log.info("heartbeat got %s; re-registering", status)
                self._reconnect()

    def _reconnect(self) -> None:
        if self._stop.is_set():
            return
        try:
            self._version = -1   # force a full assignment on re-register
            resp = self._register_any()
            self._install(resp)
        except EdlError as exc:
            log.warning("re-register failed: %s", exc)

    # -- reads --------------------------------------------------------------

    def get_servers(self) -> list[str]:
        return list(self._servers)

    def wait_for_servers(self, timeout: float = 60.0,
                         poll: float = 0.1) -> list[str]:
        """Block until the assignment is non-empty (teachers exist)."""
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._servers:
                return list(self._servers)
            if self._stop.wait(poll):
                break
        raise EdlDiscoveryError(
            f"no teachers assigned for {self.service} within {timeout}s")

    def stop(self) -> None:
        self._stop.set()
        joined = True
        if self._thread is not None:
            # The heartbeat RPC's socket timeout (5s) outlives this join:
            # if the thread is still mid-RPC, writing a deregister frame on
            # the same socket would interleave with it, so skip the
            # courtesy deregister and let the lease TTL clean us up.
            self._thread.join(timeout=6.0)
            joined = not self._thread.is_alive()
        try:
            if self._sock is not None and joined:
                self._call(op="deregister", client=self.client_id,
                           service=self.service)
        except (OSError, wire.WireError, EdlError):
            pass
        self._close()
