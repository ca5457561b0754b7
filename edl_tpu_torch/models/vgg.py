"""VGG (11/13/16/19), port of ``edl_tpu.models.vgg``.

Five stages of 3x3 'SAME' convolutions with a bias, each followed by
BatchNorm and ReLU, a 2x2/2 max-pool after each stage, two ReLU FC layers
of ``fc_dim`` and an fp32 classifier head. The input contract is the JAX
package's: NHWC images, viewed as a channels_last NCHW tensor, as
``models/resnet.py`` does; activations run in ``dtype`` (bf16 by
default), parameters and BatchNorm statistics stay fp32.

flax semantics the port keeps:

- The last feature map flattens in H·W·C order (flax's
  ``x.reshape((B, -1))`` of NHWC), so ``fc0``'s rows are flax's rows and
  the bridge carries its kernel as every other Dense kernel. Torch's own
  NCHW flatten (C·H·W) would compute something else wherever the map is
  larger than 1x1 (above 32 px).
- BatchNorm is ``models/resnet.BatchNorm``: flax's momentum 0.9 (torch's
  0.1), eps 1e-5, the biased batch variance.
- Init: convs ``variance_scaling(2, fan_out, normal)`` (a normal
  truncated at 2 std) with zero biases, the FC layers and the head flax's
  lecun-normal with zero biases, from a ``torch.Generator`` seeded with
  ``seed``.
- flax's Dense layers bind their input width at init; ``fc0``'s is
  512 x (H/32) x (W/32), so the port takes the served ``image_size`` up
  front (224 by default, the 25,088 inputs of the published VGG).
- ``nn.Dropout(dropout)`` after each FC layer: in the JAX package a
  training forward with ``dropout > 0`` raises flax's InvalidRngError,
  since no ``apply_fn`` call of the package passes a ``dropout`` rng
  stream (ROADMAP Queue 3). The port raises too; at ``dropout=0.0``
  (flax's Dropout returns early at rate 0) it trains, and in eval mode
  dropout is the identity at any rate.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch import resolve_device
from edl_tpu_torch.models.mlp import lecun_normal_
from edl_tpu_torch.models.resnet import BatchNorm

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated at +-2
WIDTHS = (64, 128, 256, 512, 512)

DROPOUT_FAULT = (
    "VGG dropout > 0 in training is not ported: the JAX package's VGG "
    "(edl_tpu/models/vgg.py:44) raises flax's InvalidRngError there, since "
    "no apply_fn call of the package passes a 'dropout' rng stream "
    "(ROADMAP Queue 3, faults in the reference); train with dropout=0.0")


class ConvBias(nn.Module):
    """flax ``nn.Conv(features, (3, 3), dtype=dtype)``: 'SAME' padding,
    stride 1, the fp32 kernel and bias cast to ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, self.bias.to(self.dtype), padding=1)


def _pair(size) -> tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


class VGG(nn.Module):
    """VGG for ImageNet classification: NHWC images -> fp32 logits.

    Attributes (the flax module's): stage_convs (convs per stage, 5
    stages), num_classes, fc_dim, dropout, dtype (of the activations).
    ``image_size`` (an int or (H, W)) is the input's spatial size, which
    fixes ``fc0``'s input width. Parameters are made on ``device`` (CUDA
    unless the caller asks for the CPU) and drawn from a generator
    seeded with ``seed``.
    """

    def __init__(self, stage_convs: Sequence[int], num_classes: int = 1000,
                 fc_dim: int = 4096, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, *,
                 image_size: int | Sequence[int] = 224,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.stage_convs = tuple(stage_convs)
        self.num_classes, self.fc_dim = num_classes, fc_dim
        self.dropout, self.dtype = dropout, dtype
        h, w = _pair(image_size)
        cin = 3
        for stage, (n_convs, width) in enumerate(zip(self.stage_convs,
                                                     WIDTHS)):
            for i in range(n_convs):
                self.add_module(f"conv{stage}_{i}",
                                ConvBias(cin, width, dtype=dtype, device=dev))
                self.add_module(f"norm{stage}_{i}",
                                BatchNorm(width, dtype=dtype, device=dev))
                cin = width
            h, w = h // 2, w // 2      # 2x2/2 VALID max-pool
        self.fc0 = nn.Linear(cin * h * w, fc_dim, device=dev)
        self.fc1 = nn.Linear(fc_dim, fc_dim, device=dev)
        self.head = nn.Linear(fc_dim, num_classes, device=dev)
        self.train()
        self._init(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        for _, conv, _ in self.layers():
            out_ch = conv.weight.shape[0]
            std = math.sqrt(2.0 / (out_ch * 9)) / _TRUNC_STD
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        for fc in (self.fc0, self.fc1, self.head):
            lecun_normal_(fc.weight, fc.in_features, gen)
            fc.bias.zero_()

    def layers(self) -> list[tuple[int, ConvBias, BatchNorm]]:
        """(stage, conv, norm) in order."""
        return [(s, getattr(self, f"conv{s}_{i}"),
                 getattr(self, f"norm{s}_{i}"))
                for s, n in enumerate(self.stage_convs) for i in range(n)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.dropout > 0:
            raise NotImplementedError(DROPOUT_FAULT)
        # NHWC -> a channels_last NCHW view, then the activation dtype
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        layers = self.layers()
        for j, (stage, conv, norm) in enumerate(layers):
            x = F.relu(norm(conv(x)))
            if j + 1 == len(layers) or layers[j + 1][0] != stage:
                x = F.max_pool2d(x, 2, 2)
        # flax's flatten order, H·W·C: a view of the channels_last map
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for fc in (self.fc0, self.fc1):
            x = F.relu(F.linear(x, fc.weight.to(self.dtype),
                                fc.bias.to(self.dtype)))
        # classifier in fp32: the logits feed softmax-CE
        return F.linear(x.float(), self.head.weight, self.head.bias)


VGG11 = partial(VGG, stage_convs=(1, 1, 2, 2, 2))
VGG13 = partial(VGG, stage_convs=(2, 2, 2, 2, 2))
VGG16 = partial(VGG, stage_convs=(2, 2, 3, 3, 3))
VGG19 = partial(VGG, stage_convs=(2, 2, 4, 4, 4))
