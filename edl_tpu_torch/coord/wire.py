"""Framed-JSON wire protocol shared by the store server and client (copy
of ``edl_tpu.coord.wire``; the same frames, byte for byte).

Frame = 4-byte magic ``EDL1`` + uint32 big-endian body length + UTF-8 JSON
body. Requests are ``{"op": str, ...args}``; responses are
``{"ok": true, ...}`` or ``{"ok": false, "error": str}``. The JAX
package's server and its C++ ``edl-store`` daemon speak the same frames,
so the port's client works against either, and the JAX package's client
against the port's server.

Every op is one request -> one response, except ``watch``, which turns the
connection into a long-lived server-push stream:

    client -> {"op": "watch", "prefix": str,
               "start_revision": int | null, "heartbeat": float}
    server -> {"ok": true, "watching": true, "revision": int}   # ack; the
              # revision is the watch's creation anchor (resume point when
              # start_revision was null)
    server -> {"ok": true, "events": [[type, key, value, revision], ...],
               "revision": int, "compacted": bool}              # repeated

Event frames are range-batched: one frame carries up to
``MAX_EVENTS_PER_FRAME`` revision-ordered events under a single
``revision`` header (the resume anchor of the LAST event in the frame).
An empty ``events`` frame is a heartbeat (sent every ``heartbeat``
seconds when idle) whose ``revision`` advances the client's resume anchor
and doubles as liveness. A frame with ``compacted: true`` means events
were lost (history compaction or a lagging watcher queue): the client
must resync with ``get_prefix`` and may resume from that frame's
revision. There is no cancel op: the client closes the connection.

A replicated store answers two refusal shapes, ``{"ok": false,
"not_leader": true, ...}`` and ``{"ok": false, "redirect": true, ...}``;
the port's client refuses both (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any

from edl_tpu_torch.obs import trace
from edl_tpu_torch.utils import config

MAGIC = b"EDL1"
_HEADER = struct.Struct(">4sI")
MAX_BODY = 64 * 1024 * 1024
# ceiling on events coalesced into one watch push frame: bounds frame
# size (and a consumer's catch-up stall) while keeping the per-frame
# header/syscall cost amortized across a burst
MAX_EVENTS_PER_FRAME = 512


class WireError(ConnectionError):
    pass


def stall_timeout() -> float:
    """Mid-frame stall deadline in seconds (EDL_TPU_WIRE_STALL_S; <=0
    disables). IDLE sockets may block per their own timeout policy —
    request/response connections legitimately sit quiet — but once a
    frame has started arriving, the rest must keep flowing: a peer that
    stalls mid-frame (SIGSTOP, half-open TCP) becomes
    a typed WireError instead of a wedged consumer thread."""
    return config.env_float("EDL_TPU_WIRE_STALL_S", 60.0)


def send_msg(sock: socket.socket, msg: dict[str, Any]) -> None:
    if "op" in msg:
        # Trace seam (obs/trace.py): requests carry the active span
        # context under the reserved "_tc" key (copy-on-attach, a no-op
        # when tracing is off), so server-side work joins the caller's
        # trace. Responses and pushes are never stamped.
        msg = trace.attach(msg)
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    sock.sendall(_HEADER.pack(MAGIC, len(body)) + body)


def _recv_exact(sock: socket.socket, n: int, *, stall: float = 0.0,
                mid_frame: bool = False) -> bytes:
    """Read exactly ``n`` bytes. With ``stall`` > 0, bytes after the
    first (or ALL bytes when ``mid_frame`` — the frame started in an
    earlier read) must each arrive within ``stall`` seconds; a socket
    whose own timeout is already tighter keeps it."""
    buf = bytearray()
    prev = sock.gettimeout()
    bounded = False
    try:
        while len(buf) < n:
            want_bound = stall > 0 and (mid_frame or buf) \
                and (prev is None or prev > stall)
            if want_bound != bounded:
                sock.settimeout(stall if want_bound else prev)
                bounded = want_bound
            try:
                chunk = sock.recv(n - len(buf))
            except TimeoutError as exc:
                if bounded:
                    raise WireError(
                        f"peer stalled mid-frame ({len(buf)}/{n} bytes "
                        f"after {stall:.0f}s)") from exc
                raise
            if not chunk:
                raise WireError("peer closed connection")
            buf.extend(chunk)
    finally:
        if bounded:
            sock.settimeout(prev)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> dict[str, Any]:
    stall = stall_timeout()
    magic, length = _HEADER.unpack(
        _recv_exact(sock, _HEADER.size, stall=stall))
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if length > MAX_BODY:
        raise WireError(f"frame too large: {length}")
    body = _recv_exact(sock, length, stall=stall, mid_frame=True)
    try:
        return json.loads(body)
    except (ValueError, UnicodeDecodeError) as exc:
        raise WireError(f"malformed frame body: {exc}") from exc
