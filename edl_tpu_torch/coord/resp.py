"""RESP2 wire protocol: client and a minimal in-process server (copy of
``edl_tpu.coord.resp``).

The transport half of the redis discovery flavor (``coord/redis_store``).
The protocol is real RESP2, so ``RespClient`` talks to a real redis in
deployment, and ``MiniRedis`` implements the command subset the registry
needs, for tests and single-box runs (pure sockets: no redis binary or
client library is needed).

Commands MiniRedis serves: PING, SET [NX] [PX ms], GET, MGET, DEL,
KEYS, SCAN, INCR, SADD, SMEMBERS, PEXPIRE, PTTL, EXISTS, FLUSHALL,
plus PUBLISH / SUBSCRIBE (the pub/sub half of the RedisStore watch
flavor: pushed ["message", channel, payload] arrays, exactly redis's
RESP2 shape, sent to subscriber connections from the publisher's
thread under a per-connection send lock).
Expiry is millisecond-granular (PEXPIRE / SET PX) because registry TTLs
in tests are sub-second; keys expire lazily on access plus in scans.
Glob patterns honor redis semantics including backslash escapes (fnmatch
would treat an escaped `\\[` as a character class and diverge from real
redis).

Error contract: everything the client raises is `RespError`, a subclass
of `EdlStoreError`: the registry/lease machinery's retry paths catch
`EdlStoreError` (coord/registry.py), and a transient socket error must
land in those paths, not kill a keepalive thread. After any transport
error the connection is closed and lazily re-established, so a late
reply from a timed-out command can never be read as the next command's
answer. Stdlib only: no torch, jax or numpy.
"""

from __future__ import annotations

import re
import socket
import socketserver
import threading
import time

from edl_tpu_torch.utils.exceptions import EdlStoreError


class RespError(EdlStoreError):
    """Transport/protocol-level failure (stream possibly desynced)."""


class RespServerError(RespError):
    """A `-ERR ...` reply from the server: the stream stays in sync."""


# -- wire --------------------------------------------------------------------

def encode_command(args: tuple) -> bytes:
    """Client command -> RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        data = a if isinstance(a, bytes) else str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(data), data))
    return b"".join(out)


def _read_line(rf) -> bytes:
    line = rf.readline()
    if not line.endswith(b"\r\n"):
        raise RespError("connection closed mid-reply")
    return line[:-2]


def read_reply(rf):
    """One RESP reply -> python value (str | int | None | list | error).

    Every failure mode raises RespError (bare int() ValueErrors from a
    malformed peer would otherwise escape the EdlStoreError-based retry
    paths and kill keepalive threads)."""
    line = _read_line(rf)
    if not line:
        raise RespError("empty reply")
    kind, rest = line[:1], line[1:]
    try:
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespServerError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = rf.read(n + 2)
            if len(data) != n + 2:
                raise RespError("connection closed mid-bulk")
            return data[:-2].decode()
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [read_reply(rf) for _ in range(n)]
    except (ValueError, UnicodeDecodeError) as exc:
        raise RespError(f"malformed reply {line!r}: {exc}") from exc
    raise RespError(f"unknown reply type {kind!r}")


def encode_reply(value) -> bytes:
    """Server value -> RESP bytes (str=bulk, int=:, None=nil, list=array,
    ('+', s)=simple string, ('-', s)=error)."""
    if isinstance(value, tuple) and len(value) == 2 and value[0] in "+-":
        return f"{value[0]}{value[1]}\r\n".encode()
    if value is None:
        return b"$-1\r\n"
    if isinstance(value, int):
        return b":%d\r\n" % value
    if isinstance(value, list):
        return b"*%d\r\n" % len(value) + b"".join(
            encode_reply(v) for v in value)
    data = value if isinstance(value, bytes) else str(value).encode()
    return b"$%d\r\n%s\r\n" % (len(data), data)


def redis_glob_match(pattern: str, s: str) -> bool:
    """Redis KEYS/SCAN glob semantics: * ? [set] and backslash escapes
    (fnmatch treats '\\[' as a literal backslash + class start — wrong)."""
    rx, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            rx.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "*":
            rx.append(".*")
        elif ch == "?":
            rx.append(".")
        elif ch == "[":
            j = pattern.find("]", i + 1)
            if j == -1:
                rx.append(re.escape(ch))
            else:
                rx.append(pattern[i:j + 1])
                i = j
        else:
            rx.append(re.escape(ch))
        i += 1
    return re.fullmatch("".join(rx), s) is not None


class RespClient:
    """Blocking RESP2 client (thread-safe; reconnects after any error).

    One in-flight command at a time under the lock; any transport error
    closes the socket so a stale late reply can never desynchronize the
    stream — the next command dials a fresh connection.
    """

    def __init__(self, endpoint: str, timeout: float = 10.0,
                 connect_retries: int = 30,
                 connect_interval: float = 0.3):
        from edl_tpu_torch.utils.net import split_endpoint
        self._addr = split_endpoint(endpoint)
        self._timeout = timeout
        self._connect_retries = connect_retries
        self._connect_interval = connect_interval
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._rf = None
        self._connect()  # surface an unreachable endpoint at build time

    def _connect(self) -> None:
        # Bounded retry (like StoreClient._connect): in a pod/compose
        # bring-up the client often starts a beat before its server
        # accepts connections.
        last: Exception | None = None
        for _ in range(max(1, self._connect_retries)):
            try:
                self._sock = socket.create_connection(
                    self._addr, timeout=self._timeout)
                break
            except OSError as exc:
                last = exc
                time.sleep(self._connect_interval)
        else:
            raise RespError(f"cannot connect to {self._addr}: {last}")
        self._sock.settimeout(self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rf = self._sock.makefile("rb")

    def _teardown(self) -> None:
        try:
            if self._rf is not None:
                self._rf.close()
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock, self._rf = None, None

    def command(self, *args):
        with self._lock:
            try:
                if self._sock is None:
                    self._connect()
                self._sock.sendall(encode_command(args))
                return read_reply(self._rf)
            except RespServerError:
                raise  # a -ERR reply: the stream stays in sync
            except RespError:
                # any transport/parse failure may leave unread bytes —
                # tear down so a stale late reply can never be read as
                # the next command's answer
                self._teardown()
                raise
            except OSError as exc:
                self._teardown()
                raise RespError(f"transport error: {exc}") from exc

    def close(self) -> None:
        with self._lock:
            self._teardown()


# -- minimal server ----------------------------------------------------------

class _Subscriber:
    """One subscribed connection: socket + send lock (pushed messages
    come from publisher threads, replies from the handler thread — the
    lock keeps frames from interleaving mid-write)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.send_lock = threading.Lock()

    def send(self, value) -> None:
        with self.send_lock:
            self.sock.sendall(encode_reply(value))


class _State:
    def __init__(self):
        self.lock = threading.RLock()
        self.strings: dict[str, str] = {}
        self.sets: dict[str, set] = {}
        self.deadlines: dict[str, float] = {}  # key -> monotonic deadline
        self.subscribers: dict[str, set[_Subscriber]] = {}

    # -- pub/sub (socket-touching: called from _Handler, not execute) -------

    def subscribe(self, channel: str, sub: _Subscriber) -> int:
        with self.lock:
            self.subscribers.setdefault(channel, set()).add(sub)
            return sum(1 for subs in self.subscribers.values()
                       if sub in subs)

    def unsubscribe(self, sub: _Subscriber) -> None:
        with self.lock:
            for subs in self.subscribers.values():
                subs.discard(sub)

    def publish(self, channel: str, message: str) -> int:
        with self.lock:
            subs = list(self.subscribers.get(channel, ()))
        delivered = 0
        for sub in subs:
            try:
                sub.send(["message", channel, message])
                delivered += 1
            except OSError:
                self.unsubscribe(sub)  # dead subscriber: drop it
        return delivered

    def _alive(self, key: str) -> bool:
        dl = self.deadlines.get(key)
        if dl is not None and dl <= time.monotonic():
            self.strings.pop(key, None)
            self.sets.pop(key, None)
            self.deadlines.pop(key, None)
            return False
        return key in self.strings or key in self.sets

    def _live_keys(self, pattern: str) -> list[str]:
        keys = set(self.strings) | set(self.sets)  # a key can be both
        return sorted(k for k in keys
                      if self._alive(k) and redis_glob_match(pattern, k))

    def execute(self, args: list[str]):
        cmd, rest = args[0].upper(), args[1:]
        with self.lock:
            if cmd == "PING":
                return ("+", "PONG")
            if cmd == "SET":
                key, val, *opts = rest
                nx = px_ms = None
                i = 0
                while i < len(opts):
                    o = opts[i].upper()
                    if o == "NX":
                        nx = True
                    elif o == "PX" and i + 1 < len(opts):
                        px_ms = int(opts[i + 1])
                        i += 1
                    i += 1
                # real redis's NX is type-agnostic: any live key blocks
                if nx and self._alive(key):
                    return None
                self.sets.pop(key, None)  # SET replaces any type
                self.strings[key] = val
                if px_ms is not None:
                    self.deadlines[key] = time.monotonic() + px_ms / 1000.0
                else:
                    self.deadlines.pop(key, None)
                return ("+", "OK")
            if cmd == "GET":
                key = rest[0]
                return self.strings.get(key) if self._alive(key) else None
            if cmd == "MGET":
                return [self.strings.get(k) if self._alive(k) else None
                        for k in rest]
            if cmd == "DEL":
                n = 0
                for k in rest:
                    alive = self._alive(k)
                    if (k in self.strings or k in self.sets) and alive:
                        n += 1
                    self.strings.pop(k, None)
                    self.sets.pop(k, None)
                    self.deadlines.pop(k, None)
                return n
            if cmd == "EXISTS":
                return sum(1 for k in rest
                           if self._alive(k) and k in self.strings)
            if cmd == "KEYS":
                return self._live_keys(rest[0])
            if cmd == "SCAN":
                # single-batch cursor: reply ["0", [keys]] is legal SCAN
                pattern = "*"
                for i, o in enumerate(rest[1:], 1):
                    if o.upper() == "MATCH" and i + 1 <= len(rest) - 1:
                        pattern = rest[i + 1]
                return ["0", self._live_keys(pattern)]
            if cmd == "INCR":
                key = rest[0]
                cur = int(self.strings.get(key, "0")) \
                    if self._alive(key) else 0
                self.strings[key] = str(cur + 1)
                return cur + 1
            if cmd == "SADD":
                key, *members = rest
                self._alive(key)
                s = self.sets.setdefault(key, set())
                before = len(s)
                s.update(members)
                return len(s) - before
            if cmd == "SREM":
                key, *members = rest
                if not self._alive(key):
                    return 0
                s = self.sets.get(key, set())
                n = len(s & set(members))
                s.difference_update(members)
                return n
            if cmd == "SMEMBERS":
                key = rest[0]
                return sorted(self.sets.get(key, set())) \
                    if self._alive(key) else []
            if cmd == "PEXPIRE":
                key, ms = rest[0], int(rest[1])
                if not self._alive(key):
                    return 0
                self.deadlines[key] = time.monotonic() + ms / 1000.0
                return 1
            if cmd == "PTTL":
                key = rest[0]
                if not self._alive(key):
                    return -2
                dl = self.deadlines.get(key)
                if dl is None:
                    return -1
                return max(0, int((dl - time.monotonic()) * 1000))
            if cmd == "FLUSHALL":
                self.strings.clear()
                self.sets.clear()
                self.deadlines.clear()
                return ("+", "OK")
            return ("-", f"ERR unknown command '{cmd}'")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        state: _State = self.server.state  # type: ignore[attr-defined]
        rf = self.request.makefile("rb")
        sub: _Subscriber | None = None
        try:
            while True:
                try:
                    cmd = read_reply(rf)
                except RespError:
                    return  # disconnect / garbage: drop the connection
                if not isinstance(cmd, list) or not cmd:
                    return
                args = [str(c) for c in cmd]
                name = args[0].upper()
                try:
                    if name == "SUBSCRIBE":
                        if sub is None:
                            sub = _Subscriber(self.request)
                        for channel in args[1:]:
                            n = state.subscribe(channel, sub)
                            sub.send(["subscribe", channel, n])
                        continue
                    if name == "PUBLISH":
                        reply = state.publish(args[1], args[2])
                    else:
                        reply = state.execute(args)
                except OSError:
                    return
                except Exception as exc:  # noqa: BLE001 — to the client
                    reply = ("-", f"ERR {type(exc).__name__}: {exc}")
                try:
                    if sub is not None:
                        sub.send(reply)
                    else:
                        self.request.sendall(encode_reply(reply))
                except OSError:
                    return
        finally:
            if sub is not None:
                state.unsubscribe(sub)
            rf.close()


class MiniRedis:
    """In-process RESP2 server over the command subset above."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True)
        self._server.daemon_threads = True
        self._server.state = _State()  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self.endpoint = f"{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="mini-redis")

    def start(self) -> "MiniRedis":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
