"""Ring attention: sequence (context) parallelism over the sp ranks of a
mesh (port of ``edl_tpu.parallel.ring_attention``: the dense ring body
``_local_ring_attention``, the flash ring body ``_local_ring_flash``,
``ring_attention`` and ``dense_attention``).

Each rank of the sp group holds one block of the sequence, (B, S/n,
H, D) of q, k and v. The k/v blocks go round the ring (``ppermute`` of
``parallel/distributed.py``, staged through host memory on gloo); at
each of the n steps the rank attends its q block to the k/v block it
holds and merges the result into a running accumulator. Causal masking
uses global positions: the rank's block index times S/n. k and v travel
as one stacked tensor, so each step is one ppermute and the backward's
transposes run in one order on every rank (a chain of dependencies):
their sends carry no tag that would tell a k cotangent from a v one.

- The dense body keeps fp32 scores and the running (o, m, l) of the
  blockwise softmax, with the -1e30 mask.
- The flash body runs ``ops/flash_attention.flash_attention_lse`` on
  each block pair (K1 forward, K2/K3 backward on a card): a past block
  is attended without a mask (``causal=False``), the diagonal block
  causally, a future block not at all (the JAX body's ``future`` branch
  merges zeros at lse -1e30, which changes nothing; the block still
  enters the graph with a zero gradient, so every rank's backward sends
  and receives as its forward did). The partial
  outputs merge exactly by their log-sum-exps, in fp32. The combine's
  cotangent reaches each block's lse, and the flash backward takes it
  as its dlse input; its row term is summed in fp32 (ROADMAP Queue 3,
  PR 2).

The JAX package's ``ring_attention`` takes global arrays and a mesh and
``shard_map``s the body; a port rank holds only its own block, so
:func:`ring_attention` takes the local blocks and the port ``Mesh``
(whose ``group("sp")`` and ``coords["sp"]`` place the rank on the
ring). The backward replays the ring the other way round: ``ppermute``'s
backward sends each cotangent back to the rank it came from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from edl_tpu_torch.parallel import distributed

_NEG_INF = -1e30


@dataclass(frozen=True)
class SeqParallel:
    """A rank's place on the sp ring: the ranks' process group (None for
    the default group), this rank's block index and the ring's size."""

    group: Any
    index: int
    size: int

    @classmethod
    def of(cls, mesh, axis: str = "sp") -> "SeqParallel | None":
        """The ring over ``mesh``'s ``axis``; None when it has one rank."""
        if mesh is None or mesh.axis_size(axis) <= 1:
            return None
        return cls(mesh.group(axis), mesh.coords[axis], mesh.axis_size(axis))


def _local_ring_attention(q, k, v, sp: SeqParallel, causal: bool,
                          scale: float) -> torch.Tensor:
    """The dense ring body. q/k/v: this rank's (B, S/n, H, D) blocks."""
    b, s_local, h, d = q.shape
    dev = q.device
    q32 = q.float()
    q_pos = sp.index * s_local + torch.arange(s_local, device=dev)
    o = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, s_local), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for i in range(sp.size):
        src = (sp.index - i) % sp.size                    # block origin
        k_blk, v_blk = kv[0], kv[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
        if causal:
            kv_pos = src * s_local + torch.arange(s_local, device=dev)
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1)
        o = o * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
        if i + 1 < sp.size:
            kv = distributed.ppermute(kv, sp.group)
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.permute(0, 2, 1, 3).to(q.dtype)                 # (B,S,H,D)


def _combine(o, lse, o_b, lse_b):
    """The exact blockwise-softmax merge of two normalized partial
    attentions by their log-sum-exps, in fp32."""
    m = torch.maximum(lse, lse_b)
    safe = m > _NEG_INF / 2
    zero = torch.zeros_like(m)
    w1 = torch.where(safe, torch.exp(lse - m), zero)
    w2 = torch.where(safe, torch.exp(lse_b - m), zero)
    den = torch.clamp(w1 + w2, min=1e-30)
    o_new = (o * w1[..., None] + o_b * w2[..., None]) / den[..., None]
    lse_new = torch.where(safe, m + torch.log(den), m)
    return o_new, lse_new


def _local_ring_flash(q, k, v, sp: SeqParallel, causal: bool,
                      scale: float) -> torch.Tensor:
    """The flash ring body: ``flash_attention_lse`` on each block pair,
    merged by :func:`_combine`."""
    from edl_tpu_torch.ops.flash_attention import flash_attention_lse

    b, s_local, h, d = q.shape
    o = torch.zeros((b, s_local, h, d), dtype=torch.float32,
                    device=q.device)
    lse = torch.full((b, s_local, h), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack([k, v])
    for i in range(sp.size):
        src = (sp.index - i) % sp.size
        if causal and src > sp.index:                     # future
            # nothing to merge; the block still enters the graph (with a
            # zero gradient) so that every rank's backward runs every
            # ppermute's transpose, as every rank's forward ran it
            o = o + 0.0 * kv.float().sum()
        else:                                             # past, diagonal
            o_b, lse_b = flash_attention_lse(
                q, kv[0], kv[1], causal=causal and src == sp.index,
                scale=scale)
            o, lse = _combine(o, lse, o_b.float(), lse_b)
        if i + 1 < sp.size:
            kv = distributed.ppermute(kv, sp.group)
    return o.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh=None, sp: SeqParallel | None = None,
                   sp_axis: str = "sp", causal: bool = True,
                   scale: float | None = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Ring attention over this rank's (B, S/n, H_local, D) blocks of
    q/k/v; the ring is ``mesh``'s ``sp_axis`` (or ``sp`` itself). Heads
    split over tp are independent, so a rank passes only its own heads.
    ``use_flash`` runs the flash body. Without a ring (one rank) it is
    :func:`dense_attention`, or the flash kernel, of the whole block."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if sp is None:
        sp = SeqParallel.of(mesh, sp_axis)
    if sp is None:
        sp = SeqParallel(None, 0, 1)
    body = _local_ring_flash if use_flash else _local_ring_attention
    return body(q, k, v, sp, causal, scale)


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
