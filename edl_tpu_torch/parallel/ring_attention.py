"""Attention references of the port (``dense_attention`` of
``edl_tpu.parallel.ring_attention``; ring attention itself comes with
the multi-GPU slice).
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """Plain single-device attention, (B, S, H, D) in and out.

    The transformer's ``attention="dense"`` path and the numerical oracle
    of the tests: scores and softmax in fp32, causal mask at -1e30, the
    result cast back to q's dtype.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = s.shape[-2], s.shape[-1]
        mask = (torch.arange(s_q, device=s.device)[:, None]
                >= torch.arange(s_k, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
