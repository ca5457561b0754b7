"""Symmetric int8 codec (trimmed port of ``edl_tpu.ops.pack``).

The three expressions every int8 quantizer of the JAX package routes
through, in PyTorch: ``symmetric_scale``, ``quantize_int8`` and
``dequantize_int8``. The fused optimizer's quantized moments
(``ops/opt_kernels.py``) use them as their plain version. The packed
gradient wire (``pack_int8``, kernel K8) and the collectives that ship
it come with the comm path (ROADMAP Queue 1 item 11).

Divisions are IEEE divisions by 0-dim tensors on the data's device: a
Python-float divisor would make a CUDA division a multiplication by its
reciprocal, one rounding away from JAX's and the kernels'.
"""

from __future__ import annotations

import torch

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
