"""Linear regression, the smoke model of the one-world trainer (port of
``edl_tpu.models.linear``): flax ``nn.Dense(features)`` as ``Dense_0``
(a lecun-normal kernel from a seeded ``torch.Generator``, a zero bias)
and the mean squared error."""

from __future__ import annotations

import math

import torch
from torch import nn

from edl_tpu_torch import resolve_device

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated at +-2


class LinearRegression(nn.Module):
    def __init__(self, in_features: int = 1, features: int = 1, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.Dense_0 = nn.Linear(in_features, features, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            std = math.sqrt(1.0 / in_features) / _TRUNC_STD
            nn.init.trunc_normal_(self.Dense_0.weight, 0.0, std, -2 * std,
                                  2 * std, generator=gen)
            self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)
