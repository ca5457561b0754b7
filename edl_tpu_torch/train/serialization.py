"""flax's msgpack checkpoint payload in pure Python (no ``msgpack``
package, no flax).

``to_bytes(tree)`` writes the bytes ``flax.serialization.to_bytes``
writes for the same tree, and ``msgpack_restore`` / ``from_bytes`` read
them back, so a ``state.msgpack`` written by either package restores in
the other. The subset is what flax writes for training states:

- ``to_state_dict``: a dict becomes a map with ``str`` keys in its own
  order; a NamedTuple a map of its fields in field order; a tuple or list
  a map ``{"0": ..., "1": ...}`` in index order; anything else is a leaf;
- leaves: ``None``, ``bool``, ``int``, ``float``, ``str``, ``bytes``; a
  numpy array as ext type 1, whose payload is the msgpack array
  ``(shape, dtype name, C-order bytes)``; a numpy scalar as ext type 3
  (the same payload of its 0-d array); a CPU ``torch.Tensor`` of a dtype
  numpy lacks (``bfloat16``, ``float8_*``) as ext type 1 under the name
  numpy's ml_dtypes gives it;
- msgpack's smallest encodings (fixint/fixstr/fixmap/fixarray first,
  ``str8`` and ``bin`` types), floats as float64;
- arrays above 2**30 bytes are written as flax's chunked form
  (``__msgpack_chunked_array__``) and read back whole.

Reading: a dtype name numpy knows becomes a numpy array (a read-only view
of the payload); ``bfloat16`` and ``float8_*`` become CPU torch tensors
viewed from the raw bytes; any other name raises.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
# dtypes numpy has no name for: stored under ml_dtypes' names
_TORCH_ONLY = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
_TORCH_NAMES = {v: k for k, v in _TORCH_ONLY.items()}


# -- state dicts ------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_state_dict(target) -> Any:
    """flax's ``to_state_dict`` for dicts, NamedTuples, tuples and lists;
    anything else is returned as it is (a leaf)."""
    if _is_namedtuple(target):
        return {k: to_state_dict(getattr(target, k)) for k in target._fields}
    if isinstance(target, dict):
        return {str(k): to_state_dict(v) for k, v in target.items()}
    if isinstance(target, (tuple, list)):
        return {str(i): to_state_dict(v) for i, v in enumerate(target)}
    return target


def from_state_dict(target, state):
    """flax's ``from_state_dict``: ``target``'s structure (dicts,
    NamedTuples, tuples, lists) filled with ``state``'s leaves; raises
    on a key mismatch."""
    if _is_namedtuple(target):
        if set(state) != set(target._fields):
            raise ValueError(f"fields {sorted(state)} != "
                             f"{sorted(target._fields)}")
        return type(target)(**{k: from_state_dict(getattr(target, k),
                                                   state[k])
                               for k in target._fields})
    if isinstance(target, dict):
        missing = set(map(str, target)) - set(state)
        if missing:
            raise ValueError(f"state dict lacks keys {sorted(missing)}")
        return {k: from_state_dict(v, state[str(k)])
                for k, v in target.items()}
    if isinstance(target, (tuple, list)):
        if len(state) != len(target):
            raise ValueError(f"sequence of {len(target)} against a state "
                             f"dict of {len(state)}")
        out = [from_state_dict(v, state[str(i)])
               for i, v in enumerate(target)]
        return type(target)(out)
    return state


# -- packing ----------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} out of msgpack's range")


def _header(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    for code, fmt, top in zip(codes, (">BB", ">BH", ">BI"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return struct.pack(fmt, code, n)
    raise ValueError(f"object of {n} entries is too large for msgpack")


def _str(s: str, out: list) -> None:
    b = s.encode("utf-8")
    out.append(_header(len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)))
    out.append(b)


def _bin(b, out: list) -> None:
    out.append(_header(len(b), None, 0, (0xC4, 0xC5, 0xC6)))
    out.append(b)


def _ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("B", fixed[n]))
    else:
        out.append(_header(n, None, 0, (0xC7, 0xC8, 0xC9)))
    out.append(struct.pack("b", code))
    out.append(data)


def _array_payload(shape: tuple, name: str, raw: bytes) -> bytes:
    """flax's ``msgpack.packb((shape, dtype name, bytes))``."""
    out = [_header(3, 0x90, 0x0F, (None, 0xDC, 0xDD)),
           _header(len(shape), 0x90, 0x0F, (None, 0xDC, 0xDD))]
    out.extend(_int(int(d)) for d in shape)
    _str(name, out)
    _bin(raw, out)
    return b"".join(out)


def _ndarray(x: np.ndarray) -> bytes:
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes do not serialize")
    return _array_payload(x.shape, x.dtype.name, x.tobytes("C"))


def _tensor(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    name = _TORCH_NAMES.get(t.dtype)
    if name is None:
        return _ndarray(t.numpy())
    raw = t.view(torch.uint8 if t.element_size() == 1 else torch.int16)
    return _array_payload(tuple(t.shape), name, raw.numpy().tobytes())


def _pack(obj, out: list) -> None:
    # the order of flax's strict-types msgpack packer
    if obj is None:
        out.append(b"\xc0")
    elif type(obj) is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) in (bytes, bytearray):
        _bin(bytes(obj), out)
    elif type(obj) is str:
        _str(obj, out)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is dict:
        out.append(_header(len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _ext(_EXT_NDARRAY, _ndarray(obj), out)
    elif isinstance(obj, np.generic):
        _ext(_EXT_NPSCALAR, _ndarray(np.asarray(obj)), out)
    elif isinstance(obj, torch.Tensor):
        _ext(_EXT_NDARRAY, _tensor(obj), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _chunk(arr: np.ndarray) -> dict:
    """flax's chunked form of an array above MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _chunk_leaves(d):
    if isinstance(d, dict):
        return {k: _chunk_leaves(v) for k, v in d.items()}
    if isinstance(d, np.ndarray) and d.nbytes > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def msgpack_serialize(state_dict) -> bytes:
    """A state dict (maps with str keys, leaves) as flax's bytes."""
    out: list = []
    _pack(_chunk_leaves(state_dict), out)
    return b"".join(out)


def to_bytes(target) -> bytes:
    """``flax.serialization.to_bytes``: ``to_state_dict`` then msgpack."""
    return msgpack_serialize(to_state_dict(target))


# -- unpacking --------------------------------------------------------------

def _dtype_leaf(shape, name: str, raw) -> Any:
    shape = tuple(shape)
    if name in _TORCH_ONLY:
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        return t.view(_TORCH_ONLY[name]).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as exc:
        raise ValueError(f"unknown dtype name {name!r} in a checkpoint "
                         "array") from exc
    if dtype.name != name:
        raise ValueError(f"dtype name {name!r} is not numpy's canonical "
                         f"{dtype.name!r}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack payload")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._text(b & 0x1F, raw)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self._text(n, raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self.unpack({0xC7: ">B", 0xC8: ">H",
                                          0xC9: ">I"}[b]))
        raise ValueError(f"unsupported msgpack type byte {b:#04x}")

    def _text(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def _map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def _ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(data)
        shape, name, raw = inner.obj(raw=True)
        leaf = _dtype_leaf(shape, name.decode("utf-8"), raw)
        return leaf[()] if code == _EXT_NPSCALAR else leaf


def _unchunk_leaves(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in d.items()}
    return d


def msgpack_restore(data) -> Any:
    """flax's ``msgpack_restore``: the state dict of a payload."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes "
                         "after the msgpack payload")
    return _unchunk_leaves(out)


def from_bytes(target, data):
    """``flax.serialization.from_bytes``: ``target``'s structure filled
    from the payload."""
    return from_state_dict(target, msgpack_restore(data))
