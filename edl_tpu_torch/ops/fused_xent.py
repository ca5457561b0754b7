"""Streamed-vocab softmax cross-entropy for LM heads (port of
``edl_tpu.ops.fused_xent``).

The dense loss keeps the (N, V) fp32 logits, their log-softmax and both
gradients alive: at B=16, S=1024, V=32768 each is 2.1 GB. This loss never
forms them. The forward streams vocab chunks of the head, keeping a
running max, a running sum of exponentials and each row's target logit;
it saves the inputs and the fp32 log-sum-exp, nothing of size N x V. The
backward replays each chunk from the saved log-sum-exp: d_logits =
(softmax - onehot) * g / N, formed a chunk at a time and contracted at
once into d_hidden and that chunk's d_kernel. The transient memory is
O(N x chunk).

The chunks are plain slices ``[c0, min(c0 + chunk, V))``: the last one
is narrower when the vocab is ragged. The JAX package instead clamps the
last chunk's start to ``V - chunk`` (``dynamic_slice`` needs a fixed
width) and masks the columns it re-reads; both visit each column once
with the same math.

The products are plain fp32 ``torch.matmul`` (the JAX package leaves
them to XLA, outside any Pallas kernel); on a card TF32 stays off, as
everywhere in the port, so they run in full fp32.
"""

from __future__ import annotations

import torch


def _chunks(v: int, want: int) -> int:
    """Chunk width: v if it fits, else ``want``."""
    return v if v <= want else want


def _fwd_pass(hidden: torch.Tensor, kernel: torch.Tensor,
              targets: torch.Tensor, chunk: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lse (N,), target logit (N,)), fp32, streaming vocab chunks."""
    n = hidden.shape[0]
    v = kernel.shape[1]
    h32, k32 = hidden.float(), kernel.float()
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=hidden.device)
    l = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    tgt = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, v, chunk):
        c1 = min(c0 + chunk, v)
        logits = h32 @ k32[:, c0:c1]                        # (N, C)
        in_chunk = (targets >= c0) & (targets < c1)
        local = (targets - c0).clamp(0, c1 - c0 - 1)
        picked = logits.gather(1, local[:, None])[:, 0]
        tgt = torch.where(in_chunk, picked, tgt)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        chunk_sum = logits.sub_(m_new[:, None]).exp_().sum(dim=-1)  # in place
        l = l * torch.exp(m - m_new) + chunk_sum
        m = m_new
    return m + torch.log(l), tgt


class _StreamedXent(torch.autograd.Function):
    """The mean cross-entropy with the JAX package's custom_vjp: saves
    hidden, kernel, targets and the fp32 lse."""

    @staticmethod
    def forward(ctx, hidden, kernel, targets, chunk):
        lse, tgt = _fwd_pass(hidden, kernel, targets, chunk)
        ctx.save_for_backward(hidden, kernel, targets, lse)
        ctx.chunk = chunk
        return (lse - tgt).mean()

    @staticmethod
    def backward(ctx, g):
        hidden, kernel, targets, lse = ctx.saved_tensors
        n, d = hidden.shape
        v = kernel.shape[1]
        h32, k32 = hidden.float(), kernel.float()
        scale = g.float() / n                        # d(mean) / d(row)
        dh = torch.zeros((n, d), dtype=torch.float32, device=hidden.device)
        # d_kernel is formed as (V, d) rows and handed back transposed:
        # for the lm_head weight (V, d), whose transpose the LM loss
        # passes, that is its own layout, and no copy is made
        dk = torch.empty((v, d), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, v, ctx.chunk):
            c1 = min(c0 + ctx.chunk, v)
            k_blk = k32[:, c0:c1]
            # p = exp(logits - lse), then (p - onehot) * scale, in place:
            # the onehot adds -1 at a row's target where this chunk holds
            # it and -0 (no change) elsewhere; no host sync
            p = (h32 @ k_blk).sub_(lse[:, None]).exp_()
            hit = (targets >= c0) & (targets < c1)
            local = (targets - c0).clamp(0, c1 - c0 - 1)
            p.scatter_add_(1, local[:, None], -hit.float()[:, None])
            p.mul_(scale)
            dh += p @ k_blk.t()
            dk[c0:c1] = p.t() @ h32
        return dh.to(hidden.dtype), dk.t().to(kernel.dtype), None, None


def streamed_lm_xent(hidden: torch.Tensor, kernel: torch.Tensor,
                     targets: torch.Tensor, chunk: int = 8192
                     ) -> torch.Tensor:
    """Mean CE of softmax(hidden @ kernel) against integer targets.

    hidden: (N, d); kernel: (d, V) (the JAX package's layout; the LM loss
    passes ``lm_head.weight.t()``, a view); targets: (N,) ints in [0, V).
    Equals ``-mean(log_softmax(hidden @ kernel)[arange(N), targets])``
    without ever forming the (N, V) logits.
    """
    chunk = _chunks(kernel.shape[1], chunk)
    return _StreamedXent.apply(hidden, kernel, targets.long(), chunk)
