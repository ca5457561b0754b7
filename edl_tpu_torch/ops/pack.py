"""Symmetric int8 codec and the int8 gradient wire (port of
``edl_tpu.ops.pack``).

The three expressions every int8 quantizer of the JAX package routes
through, in PyTorch: ``symmetric_scale``, ``quantize_int8`` and
``dequantize_int8``. The fused optimizer's quantized moments
(``ops/opt_kernels.py``) use them as their plain version, and so does
the pack.

``pack_int8`` turns a flat fp32 shard into (int8 payload, 0-dim fp32
scale). On a CUDA tensor it launches K8 (``csrc/pack.cu``, built at first
use by ``ops/_build.py``; two passes on the current stream, the scale
never read back to the host) or raises; on a CPU tensor it runs the plain
version, ``_pack_plain``. It takes contiguous fp32 input of any length:
the JAX package pads to the TPU's 128 lanes, which the card does not
need. The kernel raises for any other dtype. The JAX package's own two
paths disagree on bf16 input (its XLA path takes the scale of the bf16
values, its kernel casts to fp32 first); the plain version here follows
the kernel (the fp32 cast), and the comm path packs only fp32 buckets.

The port keeps IEEE subnormals (the kernel is built with -ftz=false, as
K6/K7 are). XLA on the CPU and the TPU flush them to zero, so a shard
whose every element is subnormal packs to scale 1.0 and q = 0 there and
to a subnormal scale here; a shard with a normal abs-max packs the same.

``all_gather_int8`` and ``all_to_all_int8`` are the two wires every
cross-rank int8 hop rides (``train/comm._cross_int8`` the first); they
take a process group where the JAX package takes an axis name and index
groups.

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


_entry = None


def _kernel():
    global _entry
    if _entry is None:
        lib = _build.load("pack")
        fn = lib.edl_pack_int8
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
        _entry = (fn, lib.edl_cuda_error_string)
    return _entry


def _pack_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8 on a contiguous fp32 CUDA shard: (q, 0-dim scale), both
    on x's card, written on the current stream."""
    if x.dtype != torch.float32:
        raise TypeError(f"pack_int8's kernel takes fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("pack_int8's kernel takes a contiguous shard")
    if x.numel() == 0:
        raise ValueError("pack_int8 takes a non-empty shard")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    amax = torch.empty(1, dtype=torch.int32, device=x.device)
    fn, err_string = _kernel()
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), amax.data_ptr(),
            x.numel())
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("pack_int8 launch failed: "
                           + err_string(err).decode())
    pack_int8.launches += 1
    return q, scale


def pack_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float shard -> (int8 payload of the same shape, 0-dim fp32 scale):
    K8 on a CUDA tensor (``.launches`` counts its launches), the plain
    version on a CPU one."""
    if x.device.type == "cuda":
        return _pack_cuda(x)
    if x.device.type == "cpu":
        return _pack_plain(x)
    raise ValueError(f"pack_int8 runs on cpu or cuda, not {x.device}")


pack_int8.launches = 0


def unpack_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int8` (one multiply)."""
    return dequantize_int8(q, scale)


# -- the wires ---------------------------------------------------------------


def all_gather_int8(x: torch.Tensor, group=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 GATHER wire: pack -> all_gather(q, scale) -> dequantize.

    ``x`` is one rank's flat float contribution. Returns ``(gathered,
    local)``: the (G, n) fp32 dequantized contributions of every member
    of ``group``, in group-rank order, and this rank's own dequantized
    round trip (what error-feedback callers subtract). Wire bytes per
    rank: n int8 and one fp32 scale.
    """
    q, scale = pack_int8(x)
    all_q = distributed.all_gather(q, group)
    all_s = distributed.all_gather(scale, group)
    return dequantize_int8(all_q, all_s[:, None]), dequantize_int8(q, scale)


def all_to_all_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """The int8 ALL-TO-ALL wire: per-destination-block pack ->
    all_to_all(q, scales) -> dequantize.

    ``x`` is destination-major: block ``x[i]`` goes to member i of
    ``group``. Each block gets its own scale (blocks bound for different
    destinations have unrelated magnitudes); the receiver dequantizes the
    source-major blocks. No error feedback: callers bound the rounding
    with a loss-parity gate.
    """
    packed = [pack_int8(x[i].contiguous()) for i in range(x.shape[0])]
    q = torch.stack([p[0] for p in packed])
    scale = torch.stack([p[1] for p in packed])
    q_r = distributed.all_to_all(q, group)
    s_r = distributed.all_to_all(scale, group)
    return dequantize_int8(q_r, s_r.reshape((x.shape[0],)
                                            + (1,) * (x.dim() - 1)))
