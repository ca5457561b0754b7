"""Fused attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions (port of ``edl_tpu.ops.flash_attention``).

Public API and layout contract are the JAX package's: q, k, v (B, S, H, D)
in, o (B, S, H, D) out in q's dtype, lse (B, S, H) fp32;
``flash_attention_lse`` returns both, ``flash_attention`` only o. One
``torch.autograd.Function`` serves both and takes both cotangents, dO and
dlse, as the JAX package's custom_vjp does. Sequences must fit
``_fit_block`` (128-divisible, or at most 512), which raises as in JAX.

Dispatch is by the tensors' device, never by a fallback:

- a CPU tensor runs the plain versions: ``_fwd_blockwise`` and
  ``_bwd_blockwise``, ports of the JAX package's blockwise scans
  (KV-block loops, fp32);
- a CUDA tensor launches the kernels, built at first use by
  ``ops/_build.py``, or raises: the forward K1 (``csrc/flash_fwd.cu``),
  and in the backward dK/dV (K2) and dQ (K3) (``csrc/flash_bwd.cu``).

Each kernel's wrapper counts its launches: ``flash_attention_lse.launches``
(K1), ``flash_bwd_dkdv.launches`` (K2), ``flash_bwd_dq.launches`` (K3).
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


def _bwd_blockwise(q, k, v, lse, do, *, blk: int, scale: float,
                   causal: bool, dlse=None):
    """Flash backward in plain PyTorch, scanning KV blocks; all fp32
    inside. q, k, v, do (B, S, H, D); lse and the optional cotangent
    ``dlse`` (B, S, H). Returns (dq, dk, dv) in q's, k's and v's dtypes.

    The row term is rt_i = sum_j p_ij dP_ij - dlse_i, summed in fp32 in a
    first scan. The JAX package takes delta_i = rowsum(dO_i * O_i) from
    the forward's output O, equal in exact arithmetic; but O is rounded
    to the input dtype, and that rounding reaches dq and dk multiplied by
    the mean key and query (see ``csrc/flash_bwd.cu``). So the backward
    does not take O.

    With ``dlse`` the score gradient gains the softmax term:
    d(lse)/d(s_ij) = p_ij, so the row term becomes sum_j p dP - dlse —
    what lets a consumer of (o, lse) (the lse combine of ring attention)
    differentiate through both.
    """
    b, s, h, d = q.shape
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    lse_bh = lse.float().transpose(1, 2)
    q_pos = torch.arange(s, device=q.device)

    def block(ki):
        """k, p and dP of KV block ki against every q row."""
        ksl = k32[:, ki * blk:(ki + 1) * blk]
        vsl = v32[:, ki * blk:(ki + 1) * blk]
        sblk = torch.einsum("bqhd,bkhd->bhqk", q32, ksl) * scale
        if causal:
            kv_pos = ki * blk + torch.arange(blk, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            sblk = torch.where(mask, sblk, torch.full_like(sblk, _NEG_INF))
        p = torch.exp(sblk - lse_bh[..., None])    # (B, H, S, blk)
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, vsl)
        return ksl, p, dp

    # the row term, (B, H, S)
    row_term = sum((p * dp).sum(dim=-1)
                   for _, p, dp in map(block, range(s // blk)))
    if dlse is not None:
        row_term = row_term - dlse.float().transpose(1, 2)
    dq = torch.zeros_like(q32)
    dk_blocks, dv_blocks = [], []
    for ki in range(s // blk):
        ksl, p, dp = block(ki)
        dv_blocks.append(torch.einsum("bhqk,bqhd->bkhd", p, do32))
        # dL/ds_ij = p_ij (dp_ij - rt_i); the trailing scale converts to
        # the gradient w.r.t. the unscaled q.k
        ds = p * (dp - row_term[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, ksl)
        dk_blocks.append(torch.einsum("bhqk,bqhd->bkhd", ds, q32))
    dk = torch.cat(dk_blocks, dim=1)
    dv = torch.cat(dv_blocks, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_ARGTYPES = {
    "flash_fwd": {
        "edl_flash_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                          + [ctypes.c_longlong] * 9
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])},
    "flash_bwd": {
        "edl_flash_bwd_dkdv": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]),
        "edl_flash_bwd_dq": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p, ctypes.c_float,
                                ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p])},
}


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if lib.edl_cuda_error_string.restype is not ctypes.c_char_p:
        for fn, argtypes in _ARGTYPES[name].items():   # first load
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(kernel: str, *ts: torch.Tensor) -> None:
    """What the kernels take: fp32 or bf16 alike, one device, head dims
    32/64/128 with the head dim contiguous, at most 65535 batch*heads,
    and for bf16 (the wgmma bodies, fed by TMA) 16-byte aligned data and
    (batch, seq, head) strides in multiples of 8 elements."""
    q = ts[0]
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel} takes fp32 or bf16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{kernel}: dtype mismatch: "
                        + " ".join(str(t.dtype) for t in ts))
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{kernel}: tensors on different devices: "
                         + " ".join(str(t.device) for t in ts))
    if d not in _HEAD_DIMS:
        raise ValueError(f"{kernel} takes head dims {_HEAD_DIMS}, got {d}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{kernel} needs the head dim contiguous "
                         "(stride 1)")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid limit 65535")
    if q.dtype == torch.bfloat16 and any(_misaligned(t) for t in ts):
        raise ValueError(f"the bf16 {kernel} reads 16-byte rows: it needs "
                         "16-byte aligned data and (batch, seq, head) "
                         "strides in multiples of 8 elements")


def _misaligned(t: torch.Tensor) -> bool:
    return bool(t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]))


def _raise_on(lib: ctypes.CDLL, kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           + lib.edl_cuda_error_string(err).decode())


def _fwd_cuda(q, k, v, *, scale: float, causal: bool):
    """Launch the forward kernel (K1). Returns (o, lse) as
    `_fwd_blockwise`.

    bf16 runs the wgmma body fed by TMA copies, fp32 the FMA body (fp32
    stays off the tensor cores: TF32 would break the 2e-5 fp32 bound)."""
    b, s, h, d = q.shape
    _check_kernel_inputs("flash_fwd", q, k, v)
    lib = _library("flash_fwd")
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, d, *strides, float(scale), int(causal),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, "flash_fwd", err)
    flash_attention_lse.launches += 1
    return o, lse


def _bwd_args(q, k, v, do, *rows):
    b, s, h, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *[st for t in (q, k, v, do) for st in t.stride()[:3]])
    ptrs = [t.data_ptr() for t in (q, k, v, do)]
    ptrs += [0 if t is None else t.data_ptr() for t in rows]
    return ptrs, [b, s, h, d], strides


def flash_bwd_dq(q, k, v, do, lse, dlse=None, *, scale: float,
                 causal: bool):
    """Launch K3: (dq, rt). dq is (B, S, H, D) contiguous in q's dtype;
    rt = sum_k p dP - dlse is the (B, S, H) fp32 row term K2 takes. lse
    and dlse (None: zero) are (B, S, H) fp32 contiguous."""
    rt = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ptrs, dims, strides = _bwd_args(q, k, v, do, lse, dlse, rt)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edl_flash_bwd_dq(
            *ptrs, dq.data_ptr(), *dims, strides, float(scale), int(causal),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, "flash_bwd_dq", err)
    flash_bwd_dq.launches += 1
    return dq, rt


def flash_bwd_dkdv(q, k, v, do, lse, rt, *, scale: float, causal: bool):
    """Launch K2: (dk, dv), (B, S, H, D) contiguous in k's and v's
    dtypes, from the row term rt that K3 wrote."""
    ptrs, dims, strides = _bwd_args(q, k, v, do, lse, rt)
    lib = _library("flash_bwd")
    dk = torch.empty(q.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edl_flash_bwd_dkdv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, strides,
            float(scale), int(causal), _DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, "flash_bwd_dkdv", err)
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0


def _bwd_cuda(q, k, v, lse, do, *, scale: float, causal: bool,
              dlse=None):
    """The backward on the card: K3 (dq and the row term), then K2.
    Returns (dq, dk, dv) as `_bwd_blockwise`."""
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                              and _misaligned(do)):
        do = do.contiguous()
    _check_kernel_inputs("flash_bwd", q, k, v, do)
    lse = lse.float().contiguous()
    if dlse is not None:
        dlse = dlse.float().contiguous()
    dq, rt = flash_bwd_dq(q, k, v, do, lse, dlse, scale=scale,
                          causal=causal)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, rt, scale=scale,
                            causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with both cotangents, the contract of the JAX package's
    custom_vjp. Forward: K1 on a CUDA tensor, `_fwd_blockwise` on a CPU
    tensor; backward: K2 and K3, or `_bwd_blockwise`. A cotangent that
    autograd leaves undefined (lse unused: the `flash_attention` case) is
    folded away."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, blk):
        if q.device.type == "cuda":
            o, lse = _fwd_cuda(q, k, v, scale=scale, causal=causal)
        else:
            o, lse = _fwd_blockwise(q, k, v, blk=blk, scale=scale,
                                    causal=causal)
        ctx.save_for_backward(q, k, v, lse)
        ctx.scale, ctx.causal, ctx.blk = scale, causal, blk
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(q)
        if q.device.type == "cuda":
            grads = _bwd_cuda(q, k, v, lse, do, scale=ctx.scale,
                              causal=ctx.causal, dlse=dlse)
        else:
            grads = _bwd_blockwise(q, k, v, lse, do, blk=ctx.blk,
                                   scale=ctx.scale, causal=ctx.causal,
                                   dlse=dlse)
        return (*grads, None, None, None)


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
    — the statistic that merges partial attentions exactly. Differentiable
    through both outputs.

    ``block_q``/``block_k`` are validated as in JAX; the plain version
    scans KV blocks of ``_fit_block(S, block_k)``, the kernels use their
    own tiles.
    """
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shape mismatch: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    _fit_block(s, block_q)
    blk_k = _fit_block(s, block_k)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _FlashAttention.apply(q, k, v, scale, causal, blk_k)


flash_attention_lse.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Fused attention. q/k/v: (B, S, H, D) -> (B, S, H, D). The unused
    lse's cotangent is undefined, which the backward folds away."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k)[0]
