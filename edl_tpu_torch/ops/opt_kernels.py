"""Fused optimizer updates over flat parameter buckets (port of
``edl_tpu.ops.opt_kernels``).

A bucket is one flat fp32 buffer of several parameters, padded to a
multiple of 128 elements (``train/comm.plan_buckets(align=128)``); the
zero padding is a fixed point of both updates. ``_adam_math`` and
``_sgdm_math`` are the single source of the arithmetic, in the JAX
package's expression order; the bucket functions update ``p`` and the
moments IN PLACE (the JAX package returns new arrays) and return them.

Dispatch is by the tensors' device, never by a fallback:

- a CPU tensor runs the plain version (``_adam_math``/``_sgdm_math``);
- a CUDA tensor launches the kernel or raises: Adam(W) runs K5
  (``csrc/adam_fp32.cu``, built at first use by ``ops/_build.py``;
  ``adam_fp32.launches`` counts its launches). Momentum-SGD's kernel
  (K4) and the quantized moments (``quant='int8'/'fp8'``, K6/K7) are not
  ported yet and raise NotImplementedError (ROADMAP Queue 1 item 7).

The scalars lr, c1 = 1 - b1^t and c2 = 1 - b2^t are host floats. The
plain version makes them 0-dim fp32 tensors on the bucket's device: a
Python-float divisor would make a CUDA division a multiplication by its
reciprocal, one rounding away from the kernel's IEEE division.
"""

from __future__ import annotations

import ctypes

import torch

from edl_tpu_torch.ops import _build

_LANE = 128         # buckets are padded to a multiple of this

OPTIMIZERS = ("sgdm", "adam")
QUANT_MODES = ("off", "int8", "fp8")


def _unported_quant(quant: str):
    return NotImplementedError(
        f"quantized resident moments (quant={quant!r}: the QPlane codec "
        "and kernels K6/K7) are not ported yet (ROADMAP Queue 1 item 7)")


# -- optimizer math (the single source of truth) ----------------------------
# Expression order matters: it is the JAX package's, so the plain version
# differs from JAX only where XLA contracts a multiply-add into an fma,
# and the CUDA kernel (no contraction) matches the plain version bitwise.


def _sgdm_math(p, g, m, lr, mu: float, wd: float):
    if wd:
        g = g + wd * p
    m_new = g + mu * m
    p_new = p + m_new * (-lr)
    return p_new, m_new


def _adam_math(p, g, m, v, lr, c1, c2, b1: float, b2: float,
               eps: float, wd: float):
    # v >= +0.0 exactly on the fp32 path, so the clamp is bitwise-neutral
    # there; it guards a dequantized v's negative residual error.
    v = torch.clamp_min(v, 0.0)
    m_new = (1 - b1) * g + b1 * m
    v_new = (1 - b2) * (g * g) + b2 * v
    u = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    if wd:
        u = u + wd * p
    p_new = p + u * (-lr)
    return p_new, m_new, v_new


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _check_bucket(name: str, *bufs: torch.Tensor) -> None:
    p = bufs[0]
    for t in bufs:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes fp32 buckets, got {t.dtype}")
        if t.shape != p.shape or t.dim() != 1:
            raise ValueError(f"{name} takes flat buckets of one length, got "
                             + " ".join(str(tuple(b.shape)) for b in bufs))
        if t.device != p.device:
            raise ValueError(f"{name}: buckets on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous 16-byte aligned "
                             "buckets")
    if p.numel() % _LANE:
        raise ValueError(f"{name}: bucket length {p.numel()} is not a "
                         f"multiple of {_LANE}")


def _library() -> ctypes.CDLL:
    lib = _build.load("adam_fp32")
    if lib.edl_cuda_error_string.restype is not ctypes.c_char_p:
        lib.edl_adam_fp32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
            + [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p])
        lib.edl_adam_fp32.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def adam_fp32(p, g, m, v, lr: float, c1: float, c2: float, *, b1: float,
              b2: float, eps: float, wd: float) -> None:
    """Launch K5 on one bucket: p, m, v rewritten in place."""
    _check_bucket("adam_fp32", p, g, m, v)
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edl_adam_fp32(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), float(lr), float(c1), float(c2), float(b1),
            float(1 - b1), float(b2), float(1 - b2), float(eps), float(wd),
            int(bool(wd)), stream)
    if err != 0:
        raise RuntimeError("adam_fp32 launch failed: "
                           + lib.edl_cuda_error_string(err).decode())
    adam_fp32.launches += 1


adam_fp32.launches = 0


def adam_bucket(p, g, m_state, v_state, lr: float, c1: float, c2: float, *,
                b1: float, b2: float, eps: float, wd: float,
                quant: str = "off"):
    """Fused Adam(W) update of one bucket, in place.

    c1/c2 are the bias-correction denominators (1 - b^t), precomputed by
    the caller so the kernel and the plain version consume identical
    scalars. Returns (p, m_state, v_state).
    """
    if quant != "off":
        raise _unported_quant(quant)
    if p.device.type == "cuda":
        adam_fp32(p, g, m_state, v_state, lr, c1, c2, b1=b1, b2=b2,
                  eps=eps, wd=wd)
    elif p.device.type == "cpu":
        _check_bucket("adam_bucket", p, g, m_state, v_state)
        pn, mn, vn = _adam_math(p, g, m_state, v_state, _scalar(lr, p),
                                _scalar(c1, p), _scalar(c2, p), b1, b2,
                                eps, wd)
        p.copy_(pn)
        m_state.copy_(mn)
        v_state.copy_(vn)
    else:
        raise ValueError(f"adam_bucket runs on cpu or cuda, not {p.device}")
    return p, m_state, v_state


def sgdm_bucket(p, g, m_state, lr: float, *, mu: float, wd: float,
                quant: str = "off"):
    """Fused momentum-SGD update of one bucket, in place. Returns
    (p, m_state). Only the plain version is ported: a CUDA bucket raises
    until kernel K4 comes."""
    if quant != "off":
        raise _unported_quant(quant)
    if p.device.type != "cpu":
        raise NotImplementedError(
            "the momentum-SGD kernel (K4) is not ported yet (ROADMAP Queue 1 "
            "item 7); on a card there is no quiet plain fallback")
    _check_bucket("sgdm_bucket", p, g, m_state)
    pn, mn = _sgdm_math(p, g, m_state, _scalar(lr, p), mu, wd)
    p.copy_(pn)
    m_state.copy_(mn)
    return p, m_state
