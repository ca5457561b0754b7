"""Decoder-only transformer LM, dense, for serving and training (port
of ``edl_tpu.models.transformer``), and its loss ``lm_loss_fn``.

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

State-dict names mirror the flax parameter tree (``block0.attn.query``,
``ln_final``, ``lm_head`` ...); ``edl_tpu_torch.bridge`` converts between
the two.

Training is ``module.train()`` (flax's ``train=True``): with
``dropout == 0``, which is what ``lm_train`` runs, it computes exactly
what eval does. Dropout in training, remat and the streamed-vocab loss
(``lm_loss_fused``) are not ported yet and raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch import resolve_device
from edl_tpu_torch.ops.flash_attention import flash_attention
from edl_tpu_torch.parallel.ring_attention import dense_attention


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 2048
    dropout: float = 0.0     # > 0 raises in training (not ported yet)
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
                "a device mesh comes with the multi-GPU slice")
        if self.remat:
            raise NotImplementedError(
                "remat (per-block activation checkpointing) is not ported "
                "yet (ROADMAP Queue 1 item 6)")
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
        q = F.linear(x, self.query.weight.to(cfg.dtype)).view(heads)
        k = F.linear(x, self.key.weight.to(cfg.dtype)).view(heads)
        v = F.linear(x, self.value.weight.to(cfg.dtype)).view(heads)
        if cfg.use_flash(s, x.device):
            o = flash_attention(q, k, v, causal=True)
        else:
            o = dense_attention(q, k, v, causal=True)
        return F.linear(o.reshape(b, s, -1), self.out.weight.to(cfg.dtype))


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
        h = F.linear(self.ln_mlp(x), self.mlp_in.weight.to(dt))
        h = F.gelu(h, approximate="tanh")
        return x + F.linear(h, self.mlp_out.weight.to(dt))


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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.training and cfg.dropout > 0:
            raise NotImplementedError(
                "dropout in training is not ported yet (flax nn.Dropout; "
                "ROADMAP Queue 1 item 6)")
        s = tokens.shape[1]
        x = F.embedding(tokens.long(), self.tok_embed.weight).to(cfg.dtype)
        x = x + self.pos_embed[None, :s].to(cfg.dtype)
        for block in self.blocks():
            x = block(x)
        x = self.ln_final(x)
        return self.lm_head(x.float())


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
