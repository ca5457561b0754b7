"""Decoder-only transformer LM, for serving and training (port of
``edl_tpu.models.transformer``), its losses ``lm_loss_fn``,
``lm_loss_fused`` (the streamed-vocab loss, ``ops/fused_xent.py``) and
``lm_loss_moe``, the mixture of experts (``moe_capacity``,
``router_topk``, ``MoEMLP``), and the remat knob
``choose_remat``/``auto_remat``.

Sequence parallelism: with ``cfg.sp`` (a
``parallel/ring_attention.SeqParallel`` of more than one rank) the model
takes this rank's block of the sequence, its positions offset by the
block's start, and attention is the ring (``ring_attention``: the flash
body where ``cfg.use_flash`` picks the kernel, on a card under "auto",
else the dense body; the JAX model runs the dense ring). The losses take
the whole batch and return the whole sequence's loss (``_sp_loss``).

Mixture of experts: ``moe=True`` swaps each block's MLP for ``MoEMLP``
(its parameters ``block{i}.moe_mlp.router``, ``.w_in``, ``.w_out``, the
flax layouts). The dispatch is the dense einsum over every expert, or a
wire (``train/comm.MoEWire``) that sends each expert's slots to the rank
that owns it. The expert math is plain torch, as in the JAX package,
where no Pallas kernel computes it. flax's ``sow`` of the router's aux
terms is each ``MoEMLP``'s ``last_aux``, read by ``lm_loss_moe``.

Parameters are fp32 and computation runs in ``cfg.dtype`` (bf16 by
default), as in the flax model: every projection casts its input and its
weight to ``cfg.dtype``; LayerNorm takes its statistics in fp32 (eps
1e-6) and returns ``cfg.dtype`` (flax computes the variance as
E[x^2] - E[x]^2, torch in two passes: the results differ in the last
fp32 bits); the MLP's gelu is the tanh approximation; the positional
table is cast to ``cfg.dtype`` before the add; the ``lm_head`` runs in
fp32 and returns fp32 logits. For that fp32 product to match the
reference on a card, TF32 must be off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).

Under FSDP (``parallel/sharding.shard_module``) a rank holds a slice of
each parameter the rules shard; every forward reads its weights through
``sharding.full``, which is the parameter itself when it is whole and
gathers the slices (its backward reduce-scatters the gradient) when it
is not. Under ``remat`` the gather is recomputed with the block.

Under tp (``shard_module`` over a tp axis) a rank holds its block of the
heads (q/k/v rows, ``out`` columns), of the MLP's hidden units
(``mlp_in`` rows, ``mlp_out`` columns), of the vocab (``lm_head`` rows)
and of the token table's embedding dim, and the layers are Megatron's:
attention runs on the rank's H/tp heads (the flash kernels take them in
the same (B, S, H_local, D) layout), q/k/v and ``mlp_in`` are
column-parallel (their input passes ``distributed.copy_to_tp``: the
identity forward, the partial input gradients all-reduced backward),
``out`` and ``mlp_out`` are row-parallel (``reduce_from_tp`` sums the
partial outputs), the token lookup is gathered along d
(``gather_from_tp``) and the lm_head is column-parallel over the vocab.
A layer finds its tp group on its parameters (``sharding.tp_spec``), so
the same module serves a world's process group and the one-process
teacher's shards (``distill/sharded_teacher.py``).

State-dict names mirror the flax parameter tree (``block0.attn.query``,
``ln_final``, ``lm_head`` ...); ``edl_tpu_torch.bridge`` converts between
the two.

``dtype`` may be ``torch.float32``, ``torch.bfloat16`` or
``torch.float16`` (``lm_train --fp16``, with dynamic loss scaling).

Training is ``module.train()`` (flax's ``train=True``): with
``dropout == 0``, which is what ``lm_train`` runs, it computes exactly
what eval does. ``remat=True`` runs each block under
``torch.utils.checkpoint`` (flax ``nn.remat``): its activations are
recomputed in the backward, the flash forward K1 with them. Dropout in
training raises: no JAX trainer reaches it either (no ``apply_fn`` call
of the JAX package passes a ``dropout`` rng stream, so a flax
``nn.Dropout`` with ``deterministic=False`` there raises as well).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from edl_tpu_torch import resolve_device
from edl_tpu_torch.ops.flash_attention import flash_attention
from edl_tpu_torch.ops.fused_xent import streamed_lm_xent
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.parallel.ring_attention import (dense_attention,
                                                   ring_attention)
from edl_tpu_torch.parallel.sharding import full, tp_spec


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 2048
    dropout: float = 0.0     # > 0 raises in training (see the docstring)
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    # "auto" = the flash kernel when the input is on CUDA and the
    # sequence is 128-divisible, else dense; "flash"/"dense" force one.
    # Under an sp ring the same rule picks the ring's body.
    attention: str = "auto"
    # the sequence-parallel ring (parallel/ring_attention.SeqParallel):
    # set with more than one rank, the model takes this rank's block of
    # the sequence and attention is the ring. None = the whole sequence.
    sp: Any = field(default=None, compare=False, hash=False)
    # mixture of experts: moe=True swaps each block's MLP for MoEMLP, a
    # top-k capacity-factor router over n_experts gelu FFNs
    moe: bool = False
    n_experts: int = 8
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.moe:
            if self.n_experts < 2:
                raise ValueError(
                    f"moe needs n_experts >= 2, got {self.n_experts}")
            if not 1 <= self.moe_top_k <= self.n_experts:
                raise ValueError(
                    f"moe_top_k must be in [1, n_experts="
                    f"{self.n_experts}], got {self.moe_top_k}")
            if self.moe_capacity_factor <= 0:
                raise ValueError(
                    f"moe_capacity_factor must be > 0, got "
                    f"{self.moe_capacity_factor}")
        if self.attention not in ("auto", "flash", "dense"):
            raise ValueError(f"unknown attention={self.attention!r} "
                             "(auto|flash|dense)")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def use_ring(self) -> bool:
        return self.sp is not None and self.sp.size > 1

    def use_flash(self, seq_len: int, device: torch.device | str) -> bool:
        if self.attention != "auto":
            return self.attention == "flash"
        return torch.device(device).type == "cuda" and seq_len % 128 == 0


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=cfg.dtype)``: fp32 statistics, output in
    ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype, device=None,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


def _linear(in_features: int, out_features: int, device) -> nn.Linear:
    return nn.Linear(in_features, out_features, bias=False, device=device)


def _tp(weight: torch.Tensor):
    """The tp collectives of a parameter split over tp, else None."""
    spec = tp_spec(weight)
    return None if spec is None else spec.group


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.n_heads * cfg.head_dim
        self.query = _linear(cfg.d_model, inner, device)
        self.key = _linear(cfg.d_model, inner, device)
        self.value = _linear(cfg.d_model, inner, device)
        self.out = _linear(inner, cfg.d_model, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        tp = _tp(self.query.weight)
        if tp is not None:
            x = distributed.copy_to_tp(x, tp)
        # this rank's heads: all of them, or its block of H/tp under tp
        heads = (b, s, -1, cfg.head_dim)
        q = F.linear(x, full(self.query.weight).to(cfg.dtype)).view(heads)
        k = F.linear(x, full(self.key.weight).to(cfg.dtype)).view(heads)
        v = F.linear(x, full(self.value.weight).to(cfg.dtype)).view(heads)
        if cfg.use_ring:
            o = ring_attention(q, k, v, sp=cfg.sp, causal=True,
                               use_flash=cfg.use_flash(s, x.device))
        elif cfg.use_flash(s, x.device):
            o = flash_attention(q, k, v, causal=True)
        else:
            o = dense_attention(q, k, v, causal=True)
        out = F.linear(o.reshape(b, s, -1),
                       full(self.out.weight).to(cfg.dtype))
        return out if tp is None else distributed.reduce_from_tp(out, tp)


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token buffer size: ceil(cf * T * k / E), at least 1."""
    return max(1, math.ceil(capacity_factor * n_tokens * top_k
                            / n_experts))


def router_topk(logits: torch.Tensor, top_k: int, capacity: int
                ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Top-k capacity-factor routing (Switch/GShard style), the JAX
    package's dense math.

    logits: (T, E) router scores. Each token picks its top_k experts by
    softmax probability (ties to the lower expert, as ``lax.top_k``);
    within each expert, slots are granted choice-major (every token's
    first choice before any second choice), and assignments past
    ``capacity`` are dropped: they vanish from dispatch and combine, and
    the token's output falls through the residual connection.

    Returns ``(combine, dispatch, aux)``: combine (T, E, C) fp32 gate
    weights (renormalized over the top-k), dispatch (T, E, C) bool, and
    aux = {load_balance (the Shazeer
    f·p loss, 1.0 at perfect balance), dropped_frac (the dropped share of
    the T*k assignments)}.
    """
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]                   # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    oh = F.one_hot(idx, e).float()                                # (T,k,E)
    # each assignment's slot in its expert's buffer, choice-major
    flat = oh.transpose(0, 1).reshape(top_k * t, e)
    pos_flat = torch.cumsum(flat, dim=0) - flat
    pos = (pos_flat * flat).sum(-1).reshape(top_k, t).t().long()  # (T, k)
    kept = pos < capacity
    # the out-of-range slot `capacity` one-hots to the all-zero row, so a
    # dropped assignment leaves dispatch and combine alike
    pos_oh = F.one_hot(torch.where(kept, pos, torch.full_like(pos, capacity)),
                       capacity + 1)[..., :capacity].float()      # (T,k,C)
    dispatch = torch.einsum("tke,tkc->tec", oh, pos_oh) > 0
    combine = torch.einsum("tk,tke,tkc->tec", gate, oh, pos_oh)
    f = oh.sum(dim=1).mean(dim=0) / top_k                         # (E,)
    p = probs.mean(dim=0)
    aux = {"load_balance": e * (f * p).sum(),
           "dropped_frac": 1.0 - kept.float().mean()}
    return combine, dispatch, aux


class MoEMLP(nn.Module):
    """The expert-parallel MLP: the router (d_model, E), the expert
    tables ``w_in`` (E, d_model, d_ff) and ``w_out`` (E, d_ff, d_model),
    in the flax layouts (``bridge`` copies them as they are).

    With ``wire`` None (the default) every expert runs here over the
    dense (E, C, d) dispatch buffer. With a wire (train/comm.MoEWire)
    the buffer goes to the experts' owner ranks and back; each rank runs
    only its local experts. The router's aux terms of the last forward
    stay in ``last_aux`` (flax's ``sow``), which ``lm_loss_moe`` reads.
    """

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.n_experts
        self.router = nn.Parameter(torch.empty(cfg.d_model, e,
                                               device=device))
        self.w_in = nn.Parameter(torch.empty(e, cfg.d_model, cfg.d_ff,
                                             device=device))
        self.w_out = nn.Parameter(torch.empty(e, cfg.d_ff, cfg.d_model,
                                              device=device))
        self.last_aux: dict = {}

    def forward(self, x: torch.Tensor, wire=None) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, s, d = x.shape
        t = b * s
        cap = moe_capacity(t, cfg.n_experts, cfg.moe_top_k,
                           cfg.moe_capacity_factor)
        xf = x.reshape(t, d)
        logits = xf.float() @ full(self.router).float()
        combine, dispatch, aux = router_topk(logits, cfg.moe_top_k, cap)
        self.last_aux = aux
        buf = torch.einsum("tec,td->ecd", dispatch.to(dt), xf)
        w_in, w_out = full(self.w_in), full(self.w_out)
        if wire is None:
            h = torch.einsum("ecd,edf->ecf", buf, w_in.to(dt))
            h = F.gelu(h, approximate="tanh")
            out = torch.einsum("ecf,efd->ecd", h, w_out.to(dt))
        else:
            recv = wire.dispatch(buf)               # (E/W, W*cap, d)
            h = torch.einsum("ecd,edf->ecf", recv,
                             wire.local_slice(w_in).to(dt))
            h = F.gelu(h, approximate="tanh")
            out = torch.einsum("ecf,efd->ecd", h,
                               wire.local_slice(w_out).to(dt))
            out = wire.combine(out)                 # back to (E, cap, d)
        y = torch.einsum("tec,ecd->td", combine.to(dt), out)
        return y.reshape(b, s, d)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.dtype, device)
        if cfg.moe:
            self.moe_mlp = MoEMLP(cfg, device)
        else:
            self.mlp_in = _linear(cfg.d_model, cfg.d_ff, device)
            self.mlp_out = _linear(cfg.d_ff, cfg.d_model, device)

    def forward(self, x: torch.Tensor, wire=None) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.attn(self.ln_attn(x))
        if self.cfg.moe:
            return x + self.moe_mlp(self.ln_mlp(x), wire)
        h = self.ln_mlp(x)
        tp = _tp(self.mlp_in.weight)
        if tp is not None:      # column-parallel in, row-parallel out
            h = distributed.copy_to_tp(h, tp)
        h = F.linear(h, full(self.mlp_in.weight).to(dt))
        h = F.gelu(h, approximate="tanh")
        h = F.linear(h, full(self.mlp_out.weight).to(dt))
        return x + (h if tp is None else distributed.reduce_from_tp(h, tp))


class Transformer(nn.Module):
    """Causal LM: tokens (B, S) int -> logits (B, S, vocab) fp32.

    Parameters are created on ``device`` (CUDA unless the caller asks for
    the CPU) and drawn from a ``torch.Generator`` seeded with ``seed``,
    with the flax model's initializers: normal(0.02) for the token and
    position tables, normal(1/sqrt(fan_in)) for every projection, ones
    and zeros for LayerNorm. The draws differ from JAX's (another
    generator); tests carry JAX's weights over with the bridge.
    """

    def __init__(self, cfg: TransformerConfig, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                      device=dev)
        self.pos_embed = nn.Parameter(
            torch.empty(cfg.max_len, cfg.d_model, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}", Block(cfg, dev))
        self.ln_final = LayerNorm(cfg.d_model, cfg.dtype, dev)
        self.lm_head = _linear(cfg.d_model, cfg.vocab_size, dev)
        # under tp, what forward returns by default: this rank's vocab
        # slice of the logits (True) or the logits gathered (False)
        self.vocab_local = False
        self.eval()
        self._init(torch.Generator(device=dev).manual_seed(seed))

    def blocks(self) -> list[Block]:
        return [getattr(self, f"block{i}") for i in range(self.cfg.n_layers)]

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.tok_embed.weight, 0.0, 0.02, generator=gen)
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=gen)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                nn.init.normal_(mod.weight, 0.0,
                                1.0 / math.sqrt(mod.in_features),
                                generator=gen)
            elif isinstance(mod, MoEMLP):
                # flax: normal(0.02) for the router, fan_in normal over
                # each expert's (in, out) table
                nn.init.normal_(mod.router, 0.0, 0.02, generator=gen)
                for w in (mod.w_in, mod.w_out):
                    nn.init.normal_(w, 0.0, 1.0 / math.sqrt(w.shape[1]),
                                    generator=gen)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False,
                moe_wire=None, vocab_local: bool | None = None
                ) -> torch.Tensor:
        """Logits (B, S, vocab) fp32, or with ``return_hidden`` the
        final-LayerNorm hidden states (B, S, d_model) in ``cfg.dtype``,
        the input of the streamed-vocab loss, which reads the lm_head
        weight itself. Under an sp ring ``tokens`` is this rank's block of
        the sequence, at positions ``sp.index * S``. ``moe_wire`` is the
        expert dispatch's transport (train/comm.MoEWire; the JAX package
        rebinds its config's), None the dense einsum dispatch over every
        expert on this rank.

        Under tp (``parallel/sharding.shard_module``) the token table
        holds this rank's slice of the embedding dim: each row's slice is
        looked up, then gathered from tp along d. The lm_head holds the
        rank's block of the vocab (column-parallel): with ``vocab_local``
        (default: the module's ``vocab_local``) the logits are this
        rank's vocab slice (B, S, vocab/tp), what the vocab-parallel loss
        and the sharded teacher's top-k read; else they are gathered."""
        cfg = self.cfg
        if self.training and cfg.dropout > 0:
            raise NotImplementedError(
                "dropout in training is not ported (flax nn.Dropout): no "
                "JAX trainer passes it a 'dropout' rng stream either")
        s = tokens.shape[1]
        lo = cfg.sp.index * s if cfg.use_ring else 0
        x = F.embedding(tokens.long(), self.tok_embed.weight).to(cfg.dtype)
        tp = _tp(self.tok_embed.weight)
        if tp is not None:
            x = distributed.gather_from_tp(x, tp)
        x = x + full(self.pos_embed)[None, lo:lo + s].to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.blocks():
            args = (x, moe_wire) if cfg.moe else (x,)
            x = (checkpoint(block, *args, use_reentrant=False) if remat
                 else block(*args))
        x = self.ln_final(x)
        if return_hidden:
            return x
        head = _tp(self.lm_head.weight)
        h = x.float()
        if head is not None:
            h = distributed.copy_to_tp(h, head)
        logits = F.linear(h, full(self.lm_head.weight))
        local = self.vocab_local if vocab_local is None else vocab_local
        if head is None or local:
            return logits
        return distributed.gather_from_tp(logits, head)


def lm_loss_fn(model: Transformer, batch: dict) -> tuple[torch.Tensor, dict]:
    """Causal LM loss for {'tokens': (B, S)} batches: next-token cross
    entropy from an fp32 log-softmax, with the perplexity in the aux.

    Under an sp ring every rank holds the whole batch and runs its block
    of the sequence (:func:`_sp_loss`); the loss is the JAX package's
    mean over all B·(S-1) positions on every rank. Under tp the
    log-softmax is vocab-parallel (:func:`vocab_parallel_ll`) and every
    tp rank returns the same loss."""
    tokens = batch["tokens"]
    if model.cfg.use_ring:
        loss = _sp_loss(model, tokens, lambda blk, targets: -_model_ll(
            model, blk, targets).sum())
    else:
        loss = -_model_ll(model, tokens, tokens[:, 1:]).mean()
    return loss, {"ppl": torch.exp(loss.detach())}


def _model_ll(model: Transformer, tokens: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """log p of each target under the logits of ``tokens``' first
    ``targets.shape[1]`` positions; vocab-parallel under tp."""
    logits = model(tokens, vocab_local=True)[:, :targets.shape[1]]
    head = _tp(model.lm_head.weight)
    if head is None:
        return _next_token_ll(logits, targets)
    return vocab_parallel_ll(logits, targets, head)


def vocab_parallel_ll(logits: torch.Tensor, targets: torch.Tensor,
                      tp) -> torch.Tensor:
    """``log_softmax(logits)[target]`` where each tp rank holds its block
    of the vocab, (..., V/tp) at ``tp.index * V/tp``: the row max is
    all-reduced (a max, detached: the loss does not depend on it), the
    sum of exps is all-reduced, and the target's logit comes from the rank
    that holds it (the others mask it) and is all-reduced. The gradient
    is the whole log-softmax's exactly, each rank its slice's."""
    logits = logits.float()
    n = logits.shape[-1]
    m = tp.all_gather(logits.detach().amax(dim=-1)).amax(dim=0)
    shifted = logits - m[..., None]
    sum_exp = distributed.reduce_from_tp(torch.exp(shifted).sum(dim=-1), tp)
    local = targets.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(shifted, -1, local.clamp(0, n - 1)[..., None])
    picked = torch.where(inside, picked[..., 0], 0.0)
    return distributed.reduce_from_tp(picked, tp) - torch.log(sum_exp)


def _next_token_ll(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _sp_loss(model: Transformer, tokens: torch.Tensor, part_sum
             ) -> torch.Tensor:
    """The whole sequence's mean next-token loss from this rank's block.
    The rank's positions predict the tokens one to their right, read from
    the whole batch: the last position of block r predicts the first
    token of block r+1, and the last block has one target fewer.
    ``part_sum(block_tokens, targets)`` is the summed loss of those
    targets; divided by the global B·(S-1), the ring's sum of the ranks'
    shares is the loss. It is returned on every rank (one all-reduce over
    the ring) with the gradient of the rank's own share: the world step
    sums the ranks' gradients over sp."""
    sp = model.cfg.sp
    b, s = tokens.shape
    if s % sp.size:
        raise ValueError(f"sequence {s} does not split over {sp.size} sp "
                         "ranks")
    n = s // sp.size
    lo = sp.index * n
    part = part_sum(tokens[:, lo:lo + n],
                    tokens[:, lo + 1:lo + n + 1]) / (b * (s - 1))
    total = distributed.all_reduce(part.detach().clone(), sp.group)
    return total + (part - part.detach())


def lm_loss_fused(model: Transformer, batch: dict, *,
                  chunk: int = 8192) -> tuple[torch.Tensor, dict]:
    """``lm_loss_fn`` without the (B, S, V) logits: the final hidden
    states feed the streamed-vocab cross-entropy, which reads the lm_head
    weight (its transpose, a view: the JAX package's (d, V) kernel).
    Under tp the vocab-sharded head is gathered from tp first, as XLA
    gathers it in the JAX package; the hidden states' gradient is then
    whole on every tp rank, and each rank keeps its slice of the head's."""
    tokens = batch["tokens"]

    def mean_xent(blk, targets):
        hidden = model(blk, return_hidden=True)[:, :targets.shape[1]]
        head = full(model.lm_head.weight)
        tp = _tp(model.lm_head.weight)
        if tp is not None:
            head = distributed.gather_from_tp(head, tp, dim=0)
        return streamed_lm_xent(hidden.reshape(-1, hidden.shape[-1]),
                                head.t(), targets.reshape(-1), chunk)

    if model.cfg.use_ring:
        loss = _sp_loss(model, tokens, lambda blk, targets: mean_xent(
            blk, targets) * targets.numel())
    else:
        loss = mean_xent(tokens, tokens[:, 1:])
    return loss, {"ppl": torch.exp(loss.detach())}


def lm_loss_moe(model: Transformer, batch: dict, *,
                aux_weight: float = 0.01, wire=None
                ) -> tuple[torch.Tensor, dict]:
    """``lm_loss_fn`` for moe=True configs: the next-token cross entropy
    plus the routers' load-balance auxiliary (``aux_weight`` times its
    mean over the MoE blocks), with the capacity-drop fraction in the
    metrics. ``wire`` is the dispatch's transport (the JAX package's
    ``apply_fn`` of a model rebound to its config's ``moe_wire``)."""
    tokens = batch["tokens"]
    logits = model(tokens, moe_wire=wire)
    ce = -_next_token_ll(logits[:, :-1], tokens[:, 1:]).mean()
    auxes = [blk.moe_mlp.last_aux for blk in model.blocks()
             if model.cfg.moe]
    zero = torch.zeros((), dtype=torch.float32, device=ce.device)
    balance = (torch.stack([a["load_balance"] for a in auxes]).mean()
               if auxes else zero)
    dropped = (torch.stack([a["dropped_frac"] for a in auxes]).mean()
               if auxes else zero)
    loss = ce + aux_weight * balance.to(ce.dtype)
    return loss, {"ppl": torch.exp(ce.detach()),
                  "moe_balance": balance.detach(),
                  "moe_dropped": dropped.detach()}


def choose_remat(cfg: TransformerConfig, batch_size: int,
                 seq_len: int | None = None, hbm_bytes: int | None = None,
                 budget_frac: float = 0.6,
                 device: str | torch.device = "cuda") -> bool:
    """Should blocks be checkpointed? The JAX package's arithmetic: the
    backward without remat keeps about 12 d_model-wide tensors a block
    (plus the (heads, S, S) scores where attention is dense) alive at
    once; if that exceeds ``budget_frac`` of the memory left after the
    fp32 parameters and two fp32 moments, remat pays its recompute.

    ``hbm_bytes`` defaults to the card's memory on ``device``, or 16 GiB
    for the CPU. The dense scores count where the model on ``device``
    runs dense attention: off the card under ``attention="auto"``. The
    JAX package counts them wherever its backend is not a TPU, because
    its auto attention is flash only there; on the CPU both agree.
    """
    dev = torch.device(device)
    seq = seq_len or cfg.max_len
    itemsize = torch.finfo(cfg.dtype).bits // 8
    per_block = 12 * batch_size * seq * cfg.d_model * itemsize
    if not cfg.use_flash(seq, dev):
        per_block += batch_size * cfg.n_heads * seq * seq * itemsize
    activations = cfg.n_layers * per_block
    n_params = (cfg.vocab_size * cfg.d_model * 2          # embed + head
                + cfg.max_len * cfg.d_model
                + cfg.n_layers * (4 * cfg.d_model ** 2
                                  + 2 * cfg.d_model * cfg.d_ff))
    resident = n_params * (4 + 8)                          # fp32 + adam
    if hbm_bytes is None:
        hbm_bytes = (torch.cuda.get_device_properties(dev).total_memory
                     if dev.type == "cuda" else 16 * (1 << 30))
    return activations > budget_frac * max(hbm_bytes - resident,
                                           hbm_bytes // 8)


def auto_remat(cfg: TransformerConfig, batch_size: int,
               seq_len: int | None = None, hbm_bytes: int | None = None,
               device: str | torch.device = "cuda") -> TransformerConfig:
    """cfg with ``remat`` set by :func:`choose_remat`."""
    return dataclasses.replace(
        cfg, remat=choose_remat(cfg, batch_size, seq_len, hbm_bytes,
                                device=device))
