"""TCP store server: serves an InMemStore over the framed-JSON protocol
(copy of ``edl_tpu.coord.server`` without the replication plane).

One thread per connection + a lease-sweeper thread (so TTL expiry generates
DELETE events even with no traffic). The JAX package's clients and the
port's speak to it alike. CLI:

    python -m edl_tpu_torch.coord.server --port 2379
"""

from __future__ import annotations

import argparse
import socket
import socketserver
import threading

from edl_tpu_torch.coord import wire
from edl_tpu_torch.coord.store import InMemStore
from edl_tpu_torch.obs import metrics, trace
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.coord.server")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        store: InMemStore = self.server.store  # type: ignore[attr-defined]
        sock: socket.socket = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                req = wire.recv_msg(sock)
            except (wire.WireError, OSError):
                return
            # Trace seam: a request sent under an active span carries
            # its context ("_tc"); the op then executes as a child span
            # of the caller's.
            ctx = trace.extract(req)
            if req.get("op") == "watch":
                # long-lived: the connection becomes a push stream and
                # ends when the client disconnects or the server stops
                self._serve_watch(store, sock, req, self.server)
                return
            try:
                if ctx is not None:
                    with trace.span(f"store.{req.get('op')}", parent=ctx):
                        resp = self._dispatch(store, req)
                else:
                    resp = self._dispatch(store, req)
            except Exception as exc:  # surface the error to the client
                resp = {"ok": False,
                        "error": f"{type(exc).__name__}: {exc}"}
            try:
                wire.send_msg(sock, resp)
            except OSError:
                return

    @staticmethod
    def _serve_watch(store: InMemStore, sock: socket.socket,
                     req: dict, server) -> None:
        """The server half of the watch stream (wire.py protocol doc):
        ack, then event frames as they happen, with empty heartbeat
        frames advancing the client's resume anchor while idle — the
        heartbeat is also how a dead client is detected (its send
        fails) so the watcher never leaks."""
        try:
            heartbeat = float(req.get("heartbeat") or 2.0)
            watch = store.watch(req.get("prefix", ""),
                                start_revision=req.get("start_revision"))
        except Exception as exc:  # noqa: BLE001 — surface to the client
            try:
                wire.send_msg(sock, {"ok": False,
                                     "error": f"{type(exc).__name__}: {exc}"})
            except OSError:
                pass
            return
        # registered so StoreServer.stop() can close live streams: a
        # stopped server whose handler threads kept streaming would look
        # alive to clients and mask a restart (resume/compaction would
        # never trigger)
        with server.watch_lock:
            server.active_watches.add(watch)
        try:
            wire.send_msg(sock, {"ok": True, "watching": True,
                                 "revision": watch.created_revision})
            while True:
                batch = watch.get(timeout=heartbeat)
                if batch is None:
                    if watch.cancelled:
                        return
                    rev = watch.progress_revision()
                    if rev is None:
                        continue  # an event raced in: deliver it next loop
                    msg = {"ok": True, "events": [], "revision": rev,
                           "compacted": False}
                else:
                    # merge whatever else is already queued into this
                    # frame (up to the wire ceiling): under a burst the
                    # stream ships a few big frames instead of thousands
                    # of one-event ones. A compacted batch is never
                    # merged — it is a resync signal, not events — so it
                    # ships alone right after.
                    events = list(batch.events)
                    revision = batch.revision
                    tail = None
                    while not batch.compacted \
                            and len(events) < wire.MAX_EVENTS_PER_FRAME:
                        nxt = watch.get(timeout=0)
                        if nxt is None:
                            break
                        if nxt.compacted:
                            tail = nxt
                            break
                        events.extend(nxt.events)
                        revision = nxt.revision
                    msg = {"ok": True,
                           "events": [[e.type, e.key, e.value, e.revision]
                                      for e in events],
                           "revision": revision,
                           "compacted": batch.compacted}
                    if tail is not None:
                        wire.send_msg(sock, msg)
                        msg = {"ok": True, "events": [],
                               "revision": tail.revision, "compacted": True}
                wire.send_msg(sock, msg)
        except OSError:
            return
        finally:
            with server.watch_lock:
                server.active_watches.discard(watch)
            watch.cancel()

    @staticmethod
    def _dispatch(store: InMemStore, req: dict) -> dict:
        op = req.get("op")
        if op == "put":
            rev = store.put(req["key"], req["value"], req.get("lease", 0))
            return {"ok": True, "revision": rev}
        if op == "get":
            rec = store.get(req["key"])
            if rec is None:
                return {"ok": True, "record": None}
            return {"ok": True, "record": [rec.key, rec.value, rec.revision, rec.lease]}
        if op == "get_prefix":
            recs, rev = store.get_prefix(req["prefix"])
            return {"ok": True, "revision": rev,
                    "records": [[r.key, r.value, r.revision, r.lease] for r in recs]}
        if op == "delete":
            return {"ok": True, "deleted": store.delete(req["key"])}
        if op == "delete_prefix":
            return {"ok": True, "count": store.delete_prefix(req["prefix"])}
        if op == "put_if_absent":
            won = store.put_if_absent(req["key"], req["value"], req.get("lease", 0))
            return {"ok": True, "won": won}
        if op == "cas":
            won = store.compare_and_swap(
                req["key"], req.get("expect"), req["value"], req.get("lease", 0))
            return {"ok": True, "won": won}
        if op == "lease_grant":
            return {"ok": True, "lease": store.lease_grant(float(req["ttl"]))}
        if op == "lease_keepalive":
            return {"ok": True, "alive": store.lease_keepalive(req["lease"])}
        if op == "lease_revoke":
            return {"ok": True, "revoked": store.lease_revoke(req["lease"])}
        if op == "events_since":
            evs, rev, compacted = store.events_since(
                req["revision"], req.get("prefix", ""))
            return {"ok": True, "revision": rev, "compacted": compacted,
                    "events": [[e.type, e.key, e.value, e.revision] for e in evs]}
        if op == "ping":
            return {"ok": True}
        if op == "status":
            # a standalone server answers enough for a client's leader
            # probe to conclude "just use me"
            return {"ok": True, "role": "standalone", "leader": None,
                    "term": 0, "revision": store.current_revision}
        return {"ok": False, "error": f"unknown op {op!r}"}


class _ThreadingServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class StoreServer:
    """In-process handle: start/stop a store server on a port."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 store: InMemStore | None = None, sweep_interval: float = 0.5):
        self.store = store or InMemStore()
        self._server = _ThreadingServer((host, port), _Handler)
        self._server.store = self.store  # type: ignore[attr-defined]
        self._server.active_watches = set()  # type: ignore[attr-defined]
        self._server.watch_lock = threading.Lock()  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._sweep_interval = sweep_interval
        # the dict API stays the engine's contract; the registry is the
        # scrape view over it (unregistered on stop)
        self._obs = metrics.register_stats("store", self.store.stats)

    def start(self) -> "StoreServer":
        t = threading.Thread(target=self._server.serve_forever,
                             name="edl-store-serve", daemon=True)
        s = threading.Thread(target=self._sweeper, name="edl-store-sweep",
                             daemon=True)
        t.start()
        s.start()
        self._threads = [t, s]
        log.info("store server listening on :%d", self.port)
        return self

    def _sweeper(self) -> None:
        while not self._stop.wait(self._sweep_interval):
            self.store.sweep()

    def stop(self) -> None:
        self._stop.set()
        # end live watch streams: their handler threads wake, close the
        # connections, and clients reconnect (resuming by revision)
        with self._server.watch_lock:  # type: ignore[attr-defined]
            watches = list(self._server.active_watches)  # type: ignore[attr-defined]
        for watch in watches:
            watch.cancel()
        self._server.shutdown()
        self._server.server_close()
        metrics.unregister(self._obs)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def main() -> None:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.coord.server",
        description="edl_tpu_torch coordination store")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=2379)
    parser.add_argument("--sweep_interval", type=float, default=0.5)
    args = parser.parse_args()
    server = StoreServer(args.port, args.host, sweep_interval=args.sweep_interval)
    server.start()
    threading.Event().wait()  # serve forever


if __name__ == "__main__":
    main()
