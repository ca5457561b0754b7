"""Text-classification students of NLP distillation (port of
``edl_tpu.models.bow``): ``BOWClassifier`` (embed -> masked sum over the
tokens, id 0 being the pad -> softsign -> dense head) and
``CNNClassifier`` (embed -> width-3 convolution over the tokens, relu ->
masked softsign sum -> head).

Names are flax's: ``embed`` (an ``nn.Embedding``, flax's
``embed/embedding``), ``conv`` (an ``nn.Conv1d`` whose weight is flax's
WIO ``(3, in, out)`` kernel as ``(out, in, 3)``; ``padding="SAME"`` at
width 3 is a padding of 1) and ``head``. Ids may be int32 or int64.
Initializers are flax's defaults from a seeded ``torch.Generator``: the
embedding normal of variance 1 / embed_dim, kernels lecun-normal,
biases zero.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch import resolve_device
from edl_tpu_torch.models.mlp import lecun_normal_


def masked_sum(embedded: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Sum the token vectors where id != 0 (0 is the pad id)."""
    mask = (ids != 0).to(embedded.dtype)[..., None]
    return torch.sum(embedded * mask, dim=1)


def soft_sign(x: torch.Tensor) -> torch.Tensor:
    return x / (1 + torch.abs(x))


class _TextClassifier(nn.Module):
    """The embedding and head both classifiers share; ``head_in`` is the
    pooled width. Returns the generator the subclass draws the rest
    from."""

    def _build(self, vocab_size: int, embed_dim: int, num_classes: int,
               head_in: int, dtype: torch.dtype, device,
               seed: int) -> torch.Generator:
        dev = resolve_device(device)
        self.num_classes, self.dtype = num_classes, dtype
        self.embed = nn.Embedding(vocab_size, embed_dim, device=dev)
        self.head = nn.Linear(head_in, num_classes, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            nn.init.normal_(self.embed.weight, 0.0,
                            math.sqrt(1.0 / embed_dim), generator=gen)
            lecun_normal_(self.head.weight, head_in, gen)
            self.head.bias.zero_()
        return gen

    def _head(self, hidden: torch.Tensor, ids: torch.Tensor
              ) -> torch.Tensor:
        return self.head(soft_sign(masked_sum(hidden, ids)).float())


class BOWClassifier(_TextClassifier):
    """Bag of words: embed -> masked sum -> softsign -> dense head."""

    def __init__(self, vocab_size: int = 30000, embed_dim: int = 128,
                 num_classes: int = 2, dtype: torch.dtype = torch.float32,
                 *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        self._build(vocab_size, embed_dim, num_classes, embed_dim, dtype,
                    device, seed)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._head(self.embed(ids).to(self.dtype), ids)


class CNNClassifier(_TextClassifier):
    """Embed -> width-3 conv (relu) -> masked softsign sum -> head."""

    def __init__(self, vocab_size: int = 30000, embed_dim: int = 128,
                 num_filters: int = 128, num_classes: int = 2,
                 dtype: torch.dtype = torch.float32, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        gen = self._build(vocab_size, embed_dim, num_classes, num_filters,
                          dtype, device, seed)
        self.conv = nn.Conv1d(embed_dim, num_filters, 3, padding=1,
                              device=self.embed.weight.device)
        with torch.no_grad():
            lecun_normal_(self.conv.weight, 3 * embed_dim, gen)
            self.conv.bias.zero_()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        emb = self.embed(ids).to(self.dtype)              # (B, L, E)
        # parameters stay fp32; the convolution runs in the activations'
        # dtype, as flax's Conv(dtype=...) does
        hidden = F.conv1d(emb.transpose(1, 2),
                          self.conv.weight.to(self.dtype),
                          self.conv.bias.to(self.dtype),
                          padding=1).transpose(1, 2)
        return self._head(F.relu(hidden), ids)
