"""DeepFM CTR model over Criteo-style dense + hashed sparse features
(port of ``edl_tpu.models.deepfm``).

A first-order linear term, a second-order factorization-machine term and
a deep tower share one embedding table over 26 hashed id fields (int ids
in [0, vocab)) and 13 dense values; the FM term uses the
sum-square/square-sum identity. Module names are flax's
(``sparse_embed``, ``sparse_linear``, ``dense_linear``, ``deep_<i>``,
``deep_out``), so ``edl_tpu_torch.bridge`` maps the parameters by name.

Both tables are ``nn.Embedding``s with DENSE gradients, as flax gives
them: optax's Adam updates the whole table every step (moments of rows
no id touched decay too), so a sparse embedding or ``SparseAdam`` would
train another model. Init: flax's ``nn.Embed`` default (a normal of
variance 1 / features, truncated at 2 std) and lecun-normal Dense
kernels with zero biases, from a ``torch.Generator`` seeded with
``seed``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch import resolve_device
from edl_tpu_torch.models.mlp import lecun_normal_

NUM_DENSE = 13
NUM_SPARSE = 26
_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated at +-2


class DeepFM(nn.Module):
    """CTR logit (B, num_classes) fp32 over (dense (B, num_dense) float,
    sparse_ids (B, num_sparse) int)."""

    def __init__(self, vocab_size: int = 1000 * 1000, embed_dim: int = 10,
                 num_dense: int = NUM_DENSE, num_sparse: int = NUM_SPARSE,
                 hidden: Sequence[int] = (400, 400, 400),
                 num_classes: int = 1, dtype: torch.dtype = torch.float32, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.num_dense, self.num_sparse = num_dense, num_sparse
        self.hidden, self.dtype = tuple(hidden), dtype
        self.sparse_embed = nn.Embedding(vocab_size, embed_dim, device=dev)
        self.sparse_linear = nn.Embedding(vocab_size, 1, device=dev)
        self.dense_linear = nn.Linear(num_dense, 1, device=dev)
        width = num_sparse * embed_dim + num_dense
        for i, out in enumerate(self.hidden):
            self.add_module(f"deep_{i}", nn.Linear(width, out, device=dev))
            width = out
        self.deep_out = nn.Linear(width, num_classes, device=dev)
        self._init(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        for table in (self.sparse_embed, self.sparse_linear):
            std = math.sqrt(1.0 / table.embedding_dim) / _TRUNC_STD
            nn.init.trunc_normal_(table.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        for fc in self.modules():
            if isinstance(fc, nn.Linear):
                lecun_normal_(fc.weight, fc.in_features, gen)
                fc.bias.zero_()

    def _dense(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, fc.weight.to(self.dtype), fc.bias.to(self.dtype))

    def forward(self, dense: torch.Tensor,
                sparse_ids: torch.Tensor) -> torch.Tensor:
        b = sparse_ids.shape[0]
        ids = sparse_ids.long()
        dense = dense.to(self.dtype)
        # one shared table: (B, F) -> (B, F, D) in a single gather
        emb = F.embedding(ids, self.sparse_embed.weight).to(self.dtype)
        w1 = F.embedding(ids, self.sparse_linear.weight).to(self.dtype)
        first = (w1[..., 0].sum(1, keepdim=True)
                 + self._dense(self.dense_linear, dense))
        # second order (FM): 0.5 * (sum^2 - sum of squares) over fields
        s = emb.sum(1)
        second = 0.5 * (s * s - (emb * emb).sum(1)).sum(-1, keepdim=True)
        deep = torch.cat([emb.reshape(b, self.num_sparse * self.embed_dim),
                          dense], -1)
        for i in range(len(self.hidden)):
            deep = F.relu(self._dense(getattr(self, f"deep_{i}"), deep))
        deep = self._dense(self.deep_out, deep)
        return (first + second + deep).float()


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean sigmoid cross-entropy; labels in {0,1}, logits (B, 1) or (B,)."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def auc(scores, labels) -> float:
    """Rank-based AUC (exact; ties get midranks), host numpy: the
    reference CTR job's tracked metric."""
    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, len(scores) + 1)
    # midranks for tied scores
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))
