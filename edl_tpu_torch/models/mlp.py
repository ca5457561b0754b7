"""Small MLP classifier, the mnist-scale teacher and student of the
distill examples (port of ``edl_tpu.models.mlp``).

flax's ``Dense`` layers bind their input width at init from the first
input; the port's take it up front (``in_features``, the flattened
per-sample size; 784 for 28x28x1). Parameter names are flax's
(``Dense_0``, ``Dense_1``, ...): lecun-normal kernels from a seeded
``torch.Generator``, zero biases.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch import resolve_device

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated at +-2


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at two deviations,
    of variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=gen)


class MLP(nn.Module):
    def __init__(self, num_classes: int = 10,
                 hidden: Sequence[int] = (256, 128), *,
                 in_features: int = 784,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes, self.hidden = num_classes, tuple(hidden)
        widths = [in_features, *self.hidden, num_classes]
        gen = torch.Generator(device=dev).manual_seed(seed)
        for i, (cin, cout) in enumerate(zip(widths, widths[1:])):
            layer = nn.Linear(cin, cout, device=dev)
            with torch.no_grad():
                lecun_normal_(layer.weight, cin, gen)
                layer.bias.zero_()
            self.add_module(f"Dense_{i}", layer)
        self.n_layers = len(widths) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


def mlp(num_classes: int = 10, **kw) -> MLP:
    return MLP(num_classes=num_classes, **kw)
