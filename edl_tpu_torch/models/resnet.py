"""ResNet family (ResNet50/101/152 and the *_vd variants), port of
``edl_tpu.models.resnet``.

Bottleneck ResNets for ImageNet, plus the "vd" tweaks: a deep 3x3x3 stem,
the stride on the 3x3 conv, and avg-pool-then-1x1 downsample shortcuts.

The input contract is the JAX package's: NHWC images, as the loader
gives them. ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC batch is a
channels_last NCHW view (no copy), and the whole network stays
channels_last, the layout cuDNN's tensor-core convolutions want.
Parameters and BatchNorm statistics are fp32; activations run in
``dtype`` (bf16 under ``--bf16``); the classifier runs in fp32.
Convolutions, pooling and the classifier are cuDNN/cuBLAS calls
(``F.conv2d``, ``F.linear``): the JAX package computes them outside any
Pallas kernel too.

flax 0.12 semantics the port keeps:

- SAME padding is asymmetric where the total is odd: a strided 3x3 conv
  on an even size pads (0, 1), the 7x7 stem (2, 3); ``max_pool`` 3x3/2
  pads (0, 1) with -inf; the vd shortcut's ``avg_pool`` 2x2/2 pads
  (0, 1) on odd sizes and counts the padding in the mean. Asymmetric
  pads are explicit ``F.pad`` calls; symmetric ones ride the conv.
- BatchNorm: statistics over (N, H, W) in fp32, output in ``dtype``,
  eps 1e-5; the running averages use flax's momentum 0.9 (torch's 0.1)
  and the BIASED batch variance; ``train()``/``eval()`` is flax's
  ``use_running_average=not train``.
- In a world that runs the SPMD step (``set_batch_group``), the batch
  statistics are those of the GLOBAL batch, as the JAX package's
  partitioned step takes them: each rank sums x and x^2 in fp32 over
  (N, H, W), one staged all-reduce of the two sums runs over the data
  group, and the mean, the biased variance E[x^2] - E[x]^2 (flax's)
  and the running averages follow; the backward all-reduces sum(dy) and
  sum(dy * xhat) (``_GlobalBatchNorm``, over the port's collective, not
  ``torch.nn.SyncBatchNorm``, which calls the backend directly).
- Init: convs ``variance_scaling(2, fan_out, normal)`` (a normal
  truncated at 2 std, std = sqrt(2 / fan_out) / 0.8796), the classifier
  ``variance_scaling(1, fan_in, uniform)`` with a zero bias, and each
  block's last BN scale at zero. Draws come from a ``torch.Generator``
  seeded with ``seed`` (not JAX's bits: tests bridge JAX's init).
- Module names are flax's (``stem_conv0``, ``BottleneckBlock_3``,
  ``Conv_1``, ``BatchNorm_2``, ``conv_shortcut``, ``Dense_0`` ...), so
  ``edl_tpu_torch.bridge`` maps parameters and statistics by name and
  ``bridge.flax_named_parameters`` gives the flax flatten order.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch import resolve_device
from edl_tpu_torch.parallel import distributed

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated at +-2


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: int, stride: int) -> tuple:
    (top, bottom), (left, right) = (same_pads(n, kernel, stride)
                                    for n in x.shape[-2:])
    return top, bottom, left, right


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME", dtype=dtype)``: the
    input and an fp32 kernel cast to ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom, left, right = _pads(x, self.kernel, self.stride)
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    the channels of an NCHW tensor; ``train()`` normalizes with the batch
    statistics and folds them into the running averages."""

    def __init__(self, features: int, *, dtype: torch.dtype, device=None,
                 zero_scale: bool = False, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        init = torch.zeros if zero_scale else torch.ones
        self.weight = nn.Parameter(init(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))
        self.sync = None   # (group, world) of the global-batch path

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(self.dtype)
        if self.sync is not None:
            return self._global(x)
        # With momentum 1, F.batch_norm writes the batch mean and the
        # UNBIASED batch variance into these scratch buffers: the
        # statistics come from the same fused pass that normalizes.
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            # (n - 1) / n turns the unbiased variance into the biased one
            self.running_var.mul_(m).add_(var, alpha=(1 - m) * (n - 1) / n)
        return y.to(self.dtype)

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        group, world = self.sync
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps, group, world)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var, alpha=1 - m)
        return y.to(self.dtype)


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the batch of every rank of ``group``
    (``world`` ranks, each with a local batch of the same size). Returns
    (y in fp32, batch mean, biased batch variance); the weight's and the
    bias's gradients are this rank's sums (the step averages them over
    the world, as every other gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, world):
        c = x.shape[1]
        xf = x.float()
        sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])
        distributed.all_reduce(sums, group)
        n = (x.numel() // c) * world
        mean = sums[:c] / n
        var = torch.clamp_min(sums[c:] / n - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c, 1, 1)
        y = ((xf - mean.view(shape)) * (invstd * weight).view(shape)
             + bias.view(shape))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n, ctx.group = n, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        shape = (1, c, 1, 1)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        dy = dy.float()
        sums = torch.cat([dy.sum((0, 2, 3)), (dy * xhat).sum((0, 2, 3))])
        d_bias, d_weight = sums[:c].clone(), sums[c:].clone()
        distributed.all_reduce(sums, ctx.group)
        dx = (weight * invstd).view(shape) * (
            dy - (sums[:c] / ctx.n).view(shape)
            - xhat * (sums[c:] / ctx.n).view(shape))
        return dx.to(x.dtype), d_weight, d_bias, None, None, None


def set_batch_group(model: nn.Module, group, world: int) -> None:
    """Take every BatchNorm's training statistics over the batch of the
    ``world`` ranks of ``group`` (None: the default group); a world of
    one restores the local statistics."""
    sync = (group, world) if world > 1 else None
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.sync = sync


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``."""
    top, bottom, left, right = _pads(x, 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (2, 2), strides=(2, 2), padding="SAME")``: the
    zero padding counts in the mean."""
    top, bottom, left, right = _pads(x, 2, 2)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.avg_pool2d(x, 2, 2)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut where the
    shape changes. ``vd``: the downsampling shortcut is avg_pool + a
    stride-1 1x1 conv."""

    def __init__(self, in_ch: int, filters: int, strides: int, *,
                 vd: bool = False, dtype: torch.dtype, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=dtype, device=device)
        self.vd, self.strides = vd, strides
        self.Conv_0 = conv(in_ch, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)
        # zero-init of the last BN scale: an identity-ish block at init
        self.BatchNorm_2 = norm(filters * 4, zero_scale=True)
        self.project = in_ch != filters * 4 or strides != 1
        if self.project:
            self.conv_shortcut = conv(in_ch, filters * 4, 1,
                                      1 if vd and strides > 1 else strides)
            self.norm_shortcut = norm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.project:
            if self.vd and self.strides > 1:
                residual = _avg_pool_same(residual)
            residual = self.norm_shortcut(self.conv_shortcut(residual))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Bottleneck ResNet for ImageNet classification: NHWC images ->
    fp32 logits.

    Attributes (the flax module's): stage_sizes (blocks per stage, e.g.
    (3, 4, 6, 3) for ResNet50), num_classes, num_filters, vd, dtype (of
    the activations; parameters and statistics stay fp32). Parameters are
    made on ``device`` (CUDA unless the caller asks for the CPU) and drawn
    from a generator seeded with ``seed``.
    """

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, vd: bool = False,
                 dtype: torch.dtype = torch.bfloat16, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes, self.vd, self.dtype = num_classes, vd, dtype
        conv = partial(Conv, dtype=dtype, device=dev)
        norm = partial(BatchNorm, dtype=dtype, device=dev)
        if vd:
            # deep stem: three 3x3 convs (32, 32, 64) instead of one 7x7
            for i, (cin, width) in enumerate(((3, 32), (32, 32), (32, 64))):
                self.add_module(f"stem_conv{i}",
                                conv(cin, width, 3, 2 if i == 0 else 1))
                self.add_module(f"stem_norm{i}", norm(width))
        else:
            self.stem_conv = conv(3, 64, 7, 2)
            self.stem_norm = norm(64)
        in_ch, n = 64, 0
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                filters = num_filters * 2 ** stage
                self.add_module(f"BottleneckBlock_{n}", BottleneckBlock(
                    in_ch, filters, 2 if stage > 0 and block == 0 else 1,
                    vd=vd, dtype=dtype, device=dev))
                in_ch, n = filters * 4, n + 1
        self.n_blocks = n
        self.Dense_0 = nn.Linear(in_ch, num_classes, device=dev)
        self.train()
        self._init(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, Conv):
                out_ch, _, kh, kw = mod.weight.shape
                std = math.sqrt(2.0 / (out_ch * kh * kw)) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
        limit = math.sqrt(3.0 / self.Dense_0.in_features)
        nn.init.uniform_(self.Dense_0.weight, -limit, limit, generator=gen)
        nn.init.zeros_(self.Dense_0.bias)

    def stem(self) -> list[tuple[nn.Module, nn.Module]]:
        if self.vd:
            return [(getattr(self, f"stem_conv{i}"),
                     getattr(self, f"stem_norm{i}")) for i in range(3)]
        return [(self.stem_conv, self.stem_norm)]

    def blocks(self) -> list[BottleneckBlock]:
        return [getattr(self, f"BottleneckBlock_{i}")
                for i in range(self.n_blocks)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> a channels_last NCHW view, then the activation dtype
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for conv, norm in self.stem():
            x = F.relu(norm(conv(x)))
        x = _max_pool_same(x)
        for block in self.blocks():
            x = block(x)
        x = x.mean(dim=(2, 3))   # global average pool, in dtype
        # classifier in fp32: the logits feed softmax-CE
        return F.linear(x.float(), self.Dense_0.weight, self.Dense_0.bias)


ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3))
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3))
ResNet50_vd = partial(ResNet, stage_sizes=(3, 4, 6, 3), vd=True)
ResNet101_vd = partial(ResNet, stage_sizes=(3, 4, 23, 3), vd=True)
ResNet152_vd = partial(ResNet, stage_sizes=(3, 8, 36, 3), vd=True)

# Tiny config for tests and dry runs: 1 block a stage, 8 base filters.
ResNetTiny = partial(ResNet, stage_sizes=(1, 1, 1, 1), num_filters=8)
