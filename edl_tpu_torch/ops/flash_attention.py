"""Fused attention forward: a hand-written CUDA kernel and its plain
PyTorch version (port of ``edl_tpu.ops.flash_attention``).

Public API and layout contract are the JAX package's: q, k, v (B, S, H, D)
in, o (B, S, H, D) out in q's dtype, lse (B, S, H) fp32;
``flash_attention_lse`` returns both, ``flash_attention`` only o.
Sequences must fit ``_fit_block`` (128-divisible, or at most 512), which
raises as in JAX.

Dispatch is by the tensors' device, never by a fallback:

- a CPU tensor runs ``_fwd_blockwise``, the plain version: a port of the
  JAX package's blockwise scan (KV-block loop, online softmax, fp32);
- a CUDA tensor launches the kernel in ``csrc/flash_fwd.cu`` (built at
  first use by ``ops/_build.py``) or raises.

``flash_attention_lse.launches`` counts kernel launches. This slice ports
the forward only: a backward through a CUDA tensor raises
NotImplementedError (the dK/dV and dQ kernels come with the training
slice). On the CPU the plain version differentiates through autograd.
"""

from __future__ import annotations

import ctypes

import torch

from edl_tpu_torch.ops import _build

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _fwd_blockwise(q, k, v, *, blk: int, scale: float, causal: bool):
    """Flash forward in plain PyTorch: a KV-block loop with the online
    softmax, all in fp32. Returns (o (B,S,H,D) in q.dtype, lse (B,S,H)
    fp32)."""
    b, s, h, d = q.shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    for ki in range(s // blk):
        ksl = k32[:, ki * blk:(ki + 1) * blk]
        vsl = v32[:, ki * blk:(ki + 1) * blk]
        sblk = torch.einsum("bqhd,bkhd->bhqk", q32, ksl) * scale
        if causal:
            kv_pos = ki * blk + torch.arange(blk, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            sblk = torch.where(mask, sblk, torch.full_like(sblk, _NEG_INF))
        m_new = torch.maximum(m, sblk.amax(dim=-1))
        p = torch.exp(sblk - m_new[..., None])
        corr = torch.exp(m - m_new)  # (B,H,S)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr.transpose(1, 2)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p, vsl))
        m = m_new
    l = torch.clamp_min(l, 1e-30)  # same guard as the kernel
    o = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    lse = (m + torch.log(l)).transpose(1, 2)
    return o, lse


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    if lib.edl_flash_fwd.argtypes is None:   # first load: declare types
        lib.edl_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.edl_flash_fwd.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _fwd_cuda(q, k, v, *, scale: float, causal: bool):
    """Launch the CUDA kernel. Returns (o, lse) as `_fwd_blockwise`.

    bf16 runs the tensor-core body, fp32 the FMA body (fp32 stays off
    the tensor cores: TF32 would break the 2e-5 fp32 bound)."""
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd takes fp32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtype mismatch: {q.dtype} {k.dtype} "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q/k/v on different devices: {q.device} "
                         f"{k.device} {v.device}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd takes head dims {_HEAD_DIMS}, got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_fwd needs the head dim contiguous "
                         "(stride 1)")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid limit 65535")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 flash_fwd reads 16-byte rows: it needs "
                         "16-byte aligned data and (batch, seq, head) "
                         "strides in multiples of 8 elements")
    lib = _library()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, d, *strides, float(scale), int(causal),
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.edl_cuda_error_string(err).decode())
    flash_attention_lse.launches += 1
    return o, lse


class _FlashFwdCuda(torch.autograd.Function):
    """The kernel as an autograd node whose backward is not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        return _fwd_cuda(q, k, v, scale=scale, causal=causal)

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash attention backward on CUDA (the dK/dV and dQ kernels) "
            "comes with the training slice")


def _fit_block(s: int, want: int) -> int:
    """Largest block <= want that divides s (128-granular, so any
    128-divisible sequence works — e.g. S=640 gets 128 blocks)."""
    if want >= s:
        if s % 128 == 0 or s <= 512:
            return s
    for b in (want, 512, 384, 256, 128):
        if b <= want and s % b == 0:
            return b
    raise ValueError(f"sequence {s} not divisible by any block size "
                     f"<= {want} (pad the sequence to a multiple of 128)")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None,
                        block_q: int = 512, block_k: int = 512
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention that also returns the per-row log-sum-exp (B, S, H) fp32
    — the statistic that merges partial attentions exactly.

    ``block_q``/``block_k`` are validated as in JAX; the plain version
    scans KV blocks of ``_fit_block(S, block_k)``, the kernel uses its own
    64-row tiles.
    """
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shape mismatch: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    _fit_block(s, block_q)
    blk_k = _fit_block(s, block_k)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return _fwd_blockwise(q, k, v, blk=blk_k, scale=scale,
                              causal=causal)
    if q.device.type == "cuda":
        return _FlashFwdCuda.apply(q, k, v, scale, causal)
    raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")


flash_attention_lse.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Fused attention. q/k/v: (B, S, H, D) -> (B, S, H, D)."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k)[0]
