"""Record-serving data server + remote source client (port of
``edl_tpu.data.data_server``; the frames are the tensor wire's, byte for
byte the JAX package's, so a server and a client of either package talk).

The server exposes any pipeline *source* (`ArraySource`, `FileSource`)
over the binary tensor wire (data/tensor_wire.py), and `RemoteSource` IS
a source (`__len__` + `batch(indices)`), so a `DataLoader` consumes
remote records through the same deterministic shard-by-rank iteration it
uses for local data. Index choice stays client-side; the server is a
stateless gather, so any number of trainers (and elastic joins) share
one server without coordination:

    python -m edl_tpu_torch.data.data_server --data-dir ... --port 23950

Protocol (tensor-wire frames, meta carries control):
    -> {"op": "len"}                      <- {"ok": true, "n": N}
    -> {"op": "batch"} + idx tensor       <- {"ok": true} + record tensors
    -> {"op": "ping"}                     <- {"ok": true}
    errors:                               <- {"ok": false, "error": "..."}

A request that fails (an unknown op, bad indices, a corrupt shard)
answers an error frame and the connection lives; garbage bytes drop the
connection and the server lives; the client reconnects and retries once
on a broken connection, then raises.
"""

from __future__ import annotations

import argparse
import socket
import struct
import threading
from typing import Any

import numpy as np

from edl_tpu_torch.data.tensor_wire import (TensorWireError, recv_tensors,
                                         send_tensors)
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils.exceptions import EdlDataError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.data.data_server")


class DataServer:
    """Serve a source's records over the tensor wire (thread/conn)."""

    def __init__(self, source, host: str = "0.0.0.0", port: int = 0,
                 backlog: int = 64):
        self.source = source
        self._sock = socket.create_server((host, port), backlog=backlog)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._conns: set[socket.socket] = set()  # guarded-by: _conns_lock
        self._conns_lock = threading.Lock()
        # serving counters (mutated under _conns_lock; the obs registry
        # reads the dict view at scrape time)
        self._requests = 0               # guarded-by: _conns_lock
        self._rows_served = 0            # guarded-by: _conns_lock
        self._obs = obs_metrics.register_stats("data_server", self.stats)

    def stats(self) -> dict:
        """Serving counters as a dict view (obs registry source)."""
        with self._conns_lock:
            return {"connections": len(self._conns),
                    "requests": self._requests,
                    "rows_served": self._rows_served,
                    "records": len(self.source)}

    def start(self) -> "DataServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="edl-data-server", daemon=True)
        self._accept_thread.start()
        log.info("data server on :%d (%d records)", self.port,
                 len(self.source))
        return self

    def stop(self) -> None:
        self._stop.set()
        # shutdown() first: close() alone leaves the fd (and the LISTEN
        # state) alive while the accept thread is blocked in accept(), so
        # the port could not be rebound until process exit.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
        # tear down live connections so the port is actually free
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        obs_metrics.unregister(self._obs)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    meta, tensors = recv_tensors(conn)
                except (TensorWireError, struct.error):
                    return  # disconnect or garbage: drop the connection
                try:
                    self._handle(conn, meta, tensors)
                except TensorWireError:
                    raise  # reply write failed — drop the connection
                except Exception as exc:  # noqa: BLE001 — any request
                    # failure (incl. a corrupt shard's BadZipFile) must
                    # reach the client as an error frame, not as a silent
                    # thread death + disconnect
                    send_tensors(conn, {"ok": False,
                                        "error": f"{type(exc).__name__}: "
                                                 f"{exc}"})
        except (OSError, TensorWireError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn, meta: dict[str, Any],
                tensors: dict[str, np.ndarray]) -> None:
        op = meta.get("op")
        with self._conns_lock:
            self._requests += 1
            if op == "batch":
                idx_t = tensors.get("idx")
                self._rows_served += (int(np.asarray(idx_t).size)
                                      if idx_t is not None else 0)
        if op == "ping":
            send_tensors(conn, {"ok": True})
        elif op == "len":
            send_tensors(conn, {"ok": True, "n": len(self.source)})
        elif op == "batch":
            idx = tensors.get("idx")
            if idx is None:
                raise EdlDataError("batch op needs an idx tensor")
            idx = np.asarray(idx, np.int64)
            n = len(self.source)
            if idx.ndim != 1 or (len(idx) and
                                 (idx.min() < 0 or idx.max() >= n)):
                raise EdlDataError(f"bad indices (n={n})")
            batch = self.source.batch(idx)
            send_tensors(conn, {"ok": True}, batch)
        else:
            raise EdlDataError(f"unknown op {op!r}")


class RemoteSource:
    """Client-side source over a DataServer endpoint.

    Satisfies the source protocol (`__len__`, `batch(idx)`), so it drops
    into `DataLoader` unchanged. One socket, guarded by a lock (the
    prefetch thread and the main thread may interleave); transient
    connection errors reconnect-and-retry once, then surface.
    """

    def __init__(self, endpoint: str, timeout: float = 30.0):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self.timeout = timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._n: int | None = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self._addr,
                                                  timeout=self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._sock

    def _call(self, meta: dict, tensors=None
              ) -> tuple[dict, dict[str, np.ndarray]]:
        with self._lock:
            for attempt in (0, 1):
                try:
                    sock = self._connect()
                    send_tensors(sock, meta, tensors)
                    rmeta, rtensors = recv_tensors(sock)
                    break
                except (OSError, TensorWireError):
                    self.close_socket()
                    if attempt:
                        raise
        if not rmeta.get("ok"):
            raise EdlDataError(
                f"data server error: {rmeta.get('error', '?')}")
        return rmeta, rtensors

    def close_socket(self) -> None:
        # holds no lock: called from _call (lock already held) and close()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        """Release the connection. The source stays usable — `_call`
        reconnects lazily — so an owner may close eagerly between
        epochs (`close_socket` is the internal reconnect path)."""
        with self._lock:
            self.close_socket()

    def __len__(self) -> int:
        if self._n is None:
            self._n = int(self._call({"op": "len"})[0]["n"])
        return self._n

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        _, tensors = self._call({"op": "batch"},
                                {"idx": np.asarray(idx, np.int64)})
        return tensors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.data.data_server",
        description="Serve a directory of .npz shards to remote trainers")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--pattern", default=".npz",
                        help="serve files whose name ends with this")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=23950)
    parser.add_argument("--cache-files", type=int, default=8)
    args = parser.parse_args(argv)

    import os

    from edl_tpu_torch.data.pipeline import FileSource
    files = sorted(os.path.join(args.data_dir, f)
                   for f in os.listdir(args.data_dir)
                   if f.endswith(args.pattern))
    server = DataServer(FileSource(files, cache_files=args.cache_files),
                        host=args.host, port=args.port).start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
