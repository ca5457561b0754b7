"""Binary tensor framing for the teacher RPC data plane (copy of
``edl_tpu.data.tensor_wire``; frames are byte-identical, so a JAX-package
peer and a port peer talk to each other).

Frame = 4-byte magic ``EDT1`` + uint32 header length + UTF-8 JSON header +
raw little-endian tensor payload (buffers concatenated in header order):

    header = {"meta": {...}, "tensors": [{"name", "dtype", "shape"}]}

JSON carries control, raw bytes carry data: no base64, no extra host copy
of the payload on the send side (gather send). A trace context a JAX
sender attached rides ``meta["_tc"]``; the port's server pops it
(``obs/trace.py``). The port's own senders attach none.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any

import numpy as np

from edl_tpu_torch.utils import config

MAGIC = b"EDT1"
_HEADER = struct.Struct(">4sI")
MAX_HEADER = 4 * 1024 * 1024
MAX_PAYLOAD = 1024 * 1024 * 1024


class TensorWireError(ConnectionError):
    pass


def stall_timeout() -> float:
    """Mid-frame stall deadline (EDL_TPU_WIRE_STALL_S; <=0 disables).
    Once a frame has started, every recv must produce bytes within this
    bound — a stalled peer becomes a typed TensorWireError, never a
    wedged server thread. Progress resets it."""
    return config.env_float("EDL_TPU_WIRE_STALL_S", 60.0)


def _recv_exact(sock: socket.socket, n: int, *, stall: float = 0.0,
                mid_frame: bool = False) -> bytes:
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
                chunk = sock.recv(min(n - len(buf), 1 << 20))
            except TimeoutError as exc:
                if bounded:
                    raise TensorWireError(
                        f"peer stalled mid-frame ({len(buf)}/{n} bytes "
                        f"after {stall:.0f}s)") from exc
                raise
            if not chunk:
                raise TensorWireError("peer closed connection")
            buf.extend(chunk)
    finally:
        if bounded:
            sock.settimeout(prev)
    return bytes(buf)


# sendmsg is limited to IOV_MAX iovecs per call (1024 on Linux).
_IOV_BATCH = 64


def _send_gather(sock: socket.socket, bufs: list) -> None:
    """writev-style gather send: one syscall over many buffers instead of
    one concatenated copy of the whole frame."""
    if not hasattr(sock, "sendmsg"):  # non-POSIX fallback
        for b in bufs:
            sock.sendall(b)
        return
    # zero-size views reject cast("B"), and empty iovecs are overhead
    views = [memoryview(b).cast("B") for b in bufs
             if memoryview(b).nbytes]
    while views:
        sent = sock.sendmsg(views[:_IOV_BATCH])
        # sendmsg on a blocking socket may still send partially: advance.
        while views and sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        if views and sent:
            views[0] = views[0][sent:]


def send_tensors(sock: socket.socket, meta: dict[str, Any],
                 tensors: dict[str, np.ndarray] | None = None) -> None:
    tensors = tensors or {}
    descs, payloads = [], []
    for name, arr in tensors.items():
        # numpy-native dtypes only; 0-d arrays keep their shape
        arr = np.asarray(arr)
        if arr.ndim and not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)
        if arr.dtype.str.startswith(("<V", "|V", ">V")):
            raise TensorWireError(
                f"non-wire dtype {arr.dtype} for tensor {name!r}")
        descs.append({"name": name, "dtype": arr.dtype.str,
                      "shape": list(arr.shape)})
        payloads.append(arr.data)
    header = json.dumps({"meta": meta, "tensors": descs},
                        separators=(",", ":")).encode("utf-8")
    if len(header) > MAX_HEADER:
        raise TensorWireError(f"header too large: {len(header)}")
    _send_gather(sock, [_HEADER.pack(MAGIC, len(header)), header, *payloads])


def recv_tensors(sock: socket.socket
                 ) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
    stall = stall_timeout()
    magic, hlen = _HEADER.unpack(
        _recv_exact(sock, _HEADER.size, stall=stall))
    if magic != MAGIC:
        raise TensorWireError(f"bad magic {magic!r}")
    if hlen > MAX_HEADER:
        raise TensorWireError(f"header too large: {hlen}")
    try:
        hbytes = _recv_exact(sock, hlen, stall=stall, mid_frame=True)
        header = json.loads(hbytes)
        meta = header["meta"]
        descs = header["tensors"]
    except (ValueError, KeyError, UnicodeDecodeError) as exc:
        raise TensorWireError(f"malformed header: {exc}") from exc
    tensors: dict[str, np.ndarray] = {}
    total = 0
    for d in descs:
        try:
            dtype = np.dtype(d["dtype"])
            shape = tuple(int(x) for x in d["shape"])
            nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        except (TypeError, ValueError, KeyError) as exc:
            raise TensorWireError(f"bad tensor desc {d}: {exc}") from exc
        total += nbytes
        if total > MAX_PAYLOAD:
            raise TensorWireError(f"payload too large: {total}")
        buf = _recv_exact(sock, nbytes, stall=stall, mid_frame=True)
        tensors[d["name"]] = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return meta, tensors
