"""Symmetric int8 codec and the int8 gradient wire (port of
``edl_tpu.ops.pack``).

The three expressions every int8 quantizer of the JAX package routes
through, in PyTorch: ``symmetric_scale``, ``quantize_int8`` and
``dequantize_int8``. The fused optimizer's quantized moments
(``ops/opt_kernels.py``) use them as their plain version, and so does
the pack.

``pack_int8_buckets`` turns flat fp32 shards into (int8 payload, 0-dim
fp32 scale) pairs, one scale a shard. On CUDA tensors it launches K8
(``csrc/pack.cu``, built at first use by ``ops/_build.py``) once over a
table of every shard (a memset and two passes on the current stream, the
scales never read back to the host) or raises; on CPU tensors it runs the
plain version, ``_pack_plain``, shard by shard. ``pack_int8`` is its
one-shard case. It takes contiguous fp32 input of any length: the JAX
package pads to the TPU's 128 lanes, which the card does not need. The
kernel raises for any other dtype. The JAX package's own two paths
disagree on bf16 input (its XLA path takes the scale of the bf16 values,
its kernel casts to fp32 first); the plain version here follows the
kernel (the fp32 cast), and the comm path packs only fp32 buckets.

The port keeps IEEE subnormals (the kernel is built with -ftz=false, as
K6/K7 are). XLA on the CPU and the TPU flush them to zero, so a shard
whose every element is subnormal packs to scale 1.0 and q = 0 there and
to a subnormal scale here; a shard with a normal abs-max packs the same.

``all_gather_int8`` and ``all_to_all_int8`` are the two wires every
cross-rank int8 hop rides; they take a process group where the JAX
package takes an axis name and index groups. ``all_gather_packed`` is the
gather wire of payloads packed before (``train/comm`` packs every
compressed bucket of a step in one call, then gathers them bucket by
bucket).

Divisions are IEEE divisions by 0-dim tensors on the data's device: a
Python-float divisor would make a CUDA division a multiplication by its
reciprocal, one rounding away from JAX's and the kernels'.
"""

from __future__ import annotations

import ctypes

import torch

from edl_tpu_torch.ops import _build
from edl_tpu_torch.parallel import distributed

_QMAX = 127.0


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def symmetric_scale(x: torch.Tensor) -> torch.Tensor:
    """fp32 scale mapping |x|max -> 127; 1.0 for an all-zero input so
    q == 0 and dequantize is exact. A 0-dim tensor on x's device."""
    amax = x.float().abs().max()
    return torch.where(amax > 0, amax / _const(_QMAX, x), _const(1.0, x))


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even symmetric int8 under ``scale`` (no zero-point)."""
    return torch.clamp(torch.round(x.float() / scale), -_QMAX,
                       _QMAX).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: one fp32 multiply."""
    return q.float() * scale.float()


# -- K8 ----------------------------------------------------------------------


def _pack_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K8, on any device."""
    scale = symmetric_scale(x)
    return quantize_int8(x, scale), scale


# Shards one call takes (MAX_SHARDS of csrc/pack.cu: the table is passed
# by value within 4 KB of kernel parameters).
PACK_TABLE_MAX = 96

_entries: dict[str, tuple] = {}
# C name and arguments after (ptrs, sizes, count, words) of each entry
_SIGNATURES = {"buckets": ("edl_pack_int8_buckets", []),
               "pass": ("edl_pack_int8_pass", [ctypes.c_int])}


def _kernel(kind: str):
    """K8's C entry ``kind`` (its library built at first use) and the
    library's error-string function."""
    entry = _entries.get(kind)
    if entry is None:
        lib = _build.load("pack")
        name, extra = _SIGNATURES[kind]
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p] + extra + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
        entry = _entries[kind] = (fn, lib.edl_cuda_error_string)
    return entry


def _check_shards(xs, kernel: bool = False) -> torch.device:
    """One or more non-empty shards on one device (cpu or cuda); for the
    kernel (a CUDA device, or ``kernel``), contiguous fp32 ones. Returns
    the device."""
    if not xs:
        raise ValueError("pack_int8_buckets takes one or more shards")
    device = xs[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_int8 runs on cpu or cuda, not {device}")
    for x in xs:
        if x.device != device:
            raise ValueError(f"pack_int8_buckets: shards on different "
                             f"devices: {device} and {x.device}")
        if x.numel() == 0:
            raise ValueError("pack_int8 takes a non-empty shard")
        if kernel or device.type == "cuda":
            if x.dtype != torch.float32:
                raise TypeError(f"pack_int8's kernel takes fp32, got "
                                f"{x.dtype}")
            if not x.is_contiguous():
                raise ValueError("pack_int8's kernel takes a contiguous "
                                 "shard")
    return device


def _call(kind: str, device: torch.device, *args) -> None:
    """One call of K8's entry ``kind`` on ``device``'s current stream."""
    fn, err_string = _kernel(kind)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("pack_int8 launch failed: "
                           + err_string(err).decode())


def _launch_tables(kind: str, device: torch.device, xs, qs, scales,
                   *args) -> int:
    """K8's entry ``kind`` once per PACK_TABLE_MAX shards: each shard's x,
    q and scale in turn as one flat array of pointers, then the sizes, the
    count, the words and ``args``. Returns the entry calls made."""
    words = _build.scratch_words(device, min(len(xs), PACK_TABLE_MAX))
    calls = 0
    for i in range(0, len(xs), PACK_TABLE_MAX):
        part = slice(i, i + PACK_TABLE_MAX)
        ptrs = [t.data_ptr() for row in zip(xs[part], qs[part], scales[part])
                for t in row]
        sizes = [x.numel() for x in xs[part]]
        _call(kind, device, (ctypes.c_void_p * len(ptrs))(*ptrs),
              (ctypes.c_longlong * len(sizes))(*sizes), len(sizes),
              words.data_ptr(), *args)
        calls += 1
    return calls


def _outputs(xs) -> tuple[list, list]:
    """Each shard's int8 payload and 0-dim scale, as views of one flat
    int8 buffer and one fp32 scale vector on the shards' card."""
    sizes = [x.numel() for x in xs]
    flat = torch.empty(sum(sizes), dtype=torch.int8, device=xs[0].device)
    scales = torch.empty(len(xs), dtype=torch.float32, device=xs[0].device)
    qs = [q.view(x.shape) for q, x in zip(flat.split(sizes), xs)]
    return qs, list(scales.unbind())


def pack_int8_buckets(xs) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Float shards -> [(int8 payload of each shard's shape, 0-dim fp32
    scale)], one scale a shard: on the card K8 once over a table of every
    shard (once per PACK_TABLE_MAX of them), each call counted in
    ``pack_int8.launches``; on the CPU the plain version shard by shard."""
    device = _check_shards(xs)
    if device.type == "cpu":
        return [_pack_plain(x) for x in xs]
    qs, scales = _outputs(xs)
    pack_int8.launches += _launch_tables("buckets", device, xs, qs, scales)
    return list(zip(qs, scales))


def pack_int8_pass(xs, qs, scales, *, which: int) -> None:
    """One pass of K8 alone over a table of CUDA shards, for timing
    (csrc/pack.cu, edl_pack_int8_pass): ``which`` 0 = the abs-max pass,
    1 = the pack pass into ``qs``/``scales``. Not counted in
    ``pack_int8.launches``: no step runs it."""
    device = _check_shards(xs, kernel=True)
    if device.type != "cuda" or len(xs) > PACK_TABLE_MAX:
        raise ValueError(f"pack_int8_pass times one table of at most "
                         f"{PACK_TABLE_MAX} CUDA shards")
    _launch_tables("pass", device, xs, qs, scales, int(which))


def pack_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float shard -> (int8 payload of the same shape, 0-dim fp32 scale):
    the one-shard case of :func:`pack_int8_buckets` (K8 on a CUDA tensor,
    ``.launches`` counting its calls; the plain version on a CPU one)."""
    return pack_int8_buckets([x])[0]


pack_int8.launches = 0


def unpack_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int8` (one multiply)."""
    return dequantize_int8(q, scale)


# -- the wires ---------------------------------------------------------------


def all_gather_packed(q: torch.Tensor, scale: torch.Tensor, group=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 GATHER wire of one rank's packed contribution: all_gather
    of (q, scale) -> dequantize. Returns ``(gathered, local)``: the (G, n)
    fp32 dequantized contributions of every member of ``group``, in
    group-rank order, and this rank's own dequantized round trip (what
    error-feedback callers subtract). Wire bytes per rank: n int8 and one
    fp32 scale."""
    all_q = distributed.all_gather(q, group)
    all_s = distributed.all_gather(scale, group)
    return dequantize_int8(all_q, all_s[:, None]), dequantize_int8(q, scale)


def all_gather_int8(x: torch.Tensor, group=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 GATHER wire: pack ``x``, one rank's flat float
    contribution, then :func:`all_gather_packed`."""
    return all_gather_packed(*pack_int8(x), group)


def all_to_all_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """The int8 ALL-TO-ALL wire: per-destination-block pack (one
    pack_int8_buckets call over the G blocks) -> all_to_all(q, scales) ->
    dequantize.

    ``x`` is destination-major: block ``x[i]`` goes to member i of
    ``group``. Each block gets its own scale (blocks bound for different
    destinations have unrelated magnitudes); the receiver dequantizes the
    source-major blocks. No error feedback: callers bound the rounding
    with a loss-parity gate.
    """
    packed = pack_int8_buckets([x[i].contiguous()
                                for i in range(x.shape[0])])
    q = torch.stack([p[0] for p in packed])
    scale = torch.stack([p[1] for p in packed])
    q_r = distributed.all_to_all(q, group)
    s_r = distributed.all_to_all(scale, group)
    return dequantize_int8(q_r, s_r.reshape((x.shape[0],)
                                            + (1,) * (x.dim() - 1)))
