"""Decoder-only transformer LM, dense, for serving and training (port
of ``edl_tpu.models.transformer``), its losses ``lm_loss_fn`` and
``lm_loss_fused`` (the streamed-vocab loss, ``ops/fused_xent.py``), and
the remat knob ``choose_remat``/``auto_remat``.

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
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from edl_tpu_torch import resolve_device
from edl_tpu_torch.ops.flash_attention import flash_attention
from edl_tpu_torch.ops.fused_xent import streamed_lm_xent
from edl_tpu_torch.parallel.ring_attention import dense_attention
from edl_tpu_torch.parallel.sharding import full


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
    attention: str = "auto"
    mesh: Any = None
    moe: bool = False

    def __post_init__(self):
        if self.moe:
            raise NotImplementedError(
                "mixture-of-experts blocks are not ported yet")
        if self.mesh is not None:
            raise NotImplementedError(
                "cfg.mesh is the JAX model's sharding-constraint seam; the "
                "port shards the module (parallel/sharding.shard_module)")
        if self.attention not in ("auto", "flash", "dense"):
            raise ValueError(f"unknown attention={self.attention!r} "
                             "(auto|flash|dense)")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

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
        heads = (b, s, cfg.n_heads, cfg.head_dim)
        q = F.linear(x, full(self.query.weight).to(cfg.dtype)).view(heads)
        k = F.linear(x, full(self.key.weight).to(cfg.dtype)).view(heads)
        v = F.linear(x, full(self.value.weight).to(cfg.dtype)).view(heads)
        if cfg.use_flash(s, x.device):
            o = flash_attention(q, k, v, causal=True)
        else:
            o = dense_attention(q, k, v, causal=True)
        return F.linear(o.reshape(b, s, -1),
                        full(self.out.weight).to(cfg.dtype))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.mlp_in = _linear(cfg.d_model, cfg.d_ff, device)
        self.mlp_out = _linear(cfg.d_ff, cfg.d_model, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.attn(self.ln_attn(x))
        h = F.linear(self.ln_mlp(x), full(self.mlp_in.weight).to(dt))
        h = F.gelu(h, approximate="tanh")
        return x + F.linear(h, full(self.mlp_out.weight).to(dt))


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

    def forward(self, tokens: torch.Tensor,
                return_hidden: bool = False) -> torch.Tensor:
        """Logits (B, S, vocab) fp32, or with ``return_hidden`` the
        final-LayerNorm hidden states (B, S, d_model) in ``cfg.dtype``,
        the input of the streamed-vocab loss, which reads the lm_head
        weight itself."""
        cfg = self.cfg
        if self.training and cfg.dropout > 0:
            raise NotImplementedError(
                "dropout in training is not ported (flax nn.Dropout): no "
                "JAX trainer passes it a 'dropout' rng stream either")
        s = tokens.shape[1]
        x = F.embedding(tokens.long(), self.tok_embed.weight).to(cfg.dtype)
        x = x + full(self.pos_embed)[None, :s].to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.blocks():
            x = (checkpoint(block, x, use_reentrant=False) if remat
                 else block(x))
        x = self.ln_final(x)
        if return_hidden:
            return x
        return F.linear(x.float(), full(self.lm_head.weight))


def lm_loss_fn(model: Transformer, batch: dict) -> tuple[torch.Tensor, dict]:
    """Causal LM loss for {'tokens': (B, S)} batches: next-token cross
    entropy from an fp32 log-softmax, with the perplexity in the aux."""
    tokens = batch["tokens"]
    logits = model(tokens)[:, :-1]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    loss = -ll.mean()
    return loss, {"ppl": torch.exp(loss.detach())}


def lm_loss_fused(model: Transformer, batch: dict, *,
                  chunk: int = 8192) -> tuple[torch.Tensor, dict]:
    """``lm_loss_fn`` without the (B, S, V) logits: the final hidden
    states feed the streamed-vocab cross-entropy, which reads the lm_head
    weight (its transpose, a view: the JAX package's (d, V) kernel)."""
    tokens = batch["tokens"]
    hidden = model(tokens, return_hidden=True)
    b, s, d = hidden.shape
    hidden = hidden[:, :-1].reshape(b * (s - 1), d)
    targets = tokens[:, 1:].reshape(-1)
    loss = streamed_lm_xent(hidden, full(model.lm_head.weight).t(), targets,
                            chunk)
    return loss, {"ppl": torch.exp(loss.detach())}


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
