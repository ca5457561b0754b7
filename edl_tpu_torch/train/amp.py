"""Dynamic loss scaling for fp16 activations (port of
``edl_tpu.train.amp``).

Scale the loss before the backward so fp16 gradients do not underflow,
unscale each gradient after it, SKIP the step when any gradient is not
finite (halving the scale), and double the scale after a run of clean
steps. Use through ``make_train_step(loss_fn, loss_scale=True)``, whose
step becomes ``step(state, batch, ls) -> (state, metrics, ls)``, with
``ls`` made once by ``DynamicLossScale.create()`` and threaded through
every call (``lm_train --fp16`` keeps it in a closure cell).

The JAX package's step is pure: it computes the update and then keeps
either the new or the whole old state (``where(finite, new, old)``, the
step count included). The port updates in place (K5 rewrites parameters
and moments where they lie), so it decides BEFORE the update: the step
reads the finite flag on the host (``read_finite``, one device-to-host
read a step, counted in ``read_finite.reads``) and on a non-finite step
does not run the optimizer at all. Parameters, moments and the step
count are then untouched, as the JAX package's select leaves them.

The scale and the growth count are fp32 and int32 0-d CPU tensors
(torch takes a 0-d CPU tensor as a scalar operand of a tensor on any
device), updated with the JAX package's fp32 rules.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

MAX_SCALE = 2.0 ** 24
MIN_SCALE = 1.0


class DynamicLossScale(NamedTuple):
    """Loss-scale state; ``create()`` gives the JAX package's defaults
    (init 2^15, 2x growth every 2000 clean steps, 0.5x on overflow)."""

    scale: torch.Tensor = None  # type: ignore[assignment]
    growth_count: torch.Tensor = None  # type: ignore[assignment]
    growth_interval: int = 2000

    @staticmethod
    def create(init_scale: float = 2.0 ** 15,
               growth_interval: int = 2000) -> "DynamicLossScale":
        return DynamicLossScale(
            scale=torch.tensor(init_scale, dtype=torch.float32),
            growth_count=torch.tensor(0, dtype=torch.int32),
            growth_interval=growth_interval)


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor on the tensors' device: every element finite."""
    flags = [torch.isfinite(t).all() for t in tensors]
    return torch.stack(flags).all() if flags else torch.tensor(True)


def scaled_backward(loss: torch.Tensor, params: Iterable[torch.Tensor],
                    ls: DynamicLossScale) -> list[torch.Tensor]:
    """Backward of ``ls.scale * loss``, then each parameter's ``.grad``
    unscaled in place to fp32 by multiplying it by the fp32 ``1 / scale``
    (the JAX package's ``g.astype(f32) * inv``). Returns the gradients
    (None for a parameter the loss does not reach); they may be
    non-finite: ``update_scale`` decides what the step does."""
    (loss * ls.scale.to(loss.dtype)).backward()
    inv = torch.tensor(1.0, dtype=torch.float32) / ls.scale
    grads = []
    for p in params:
        if p.grad is not None:
            p.grad = p.grad.float().mul_(inv)
        grads.append(p.grad)
    return grads


def read_finite(finite: torch.Tensor) -> bool:
    """The finite flag on the host: one device-to-host read, counted."""
    read_finite.reads += 1
    return bool(finite)


read_finite.reads = 0


def update_scale(ls: DynamicLossScale, finite: bool) -> DynamicLossScale:
    """The JAX package's ``update_scale_and_select`` rules for the scale:
    on a non-finite step it halves (floor 1.0) and the count resets;
    otherwise the count advances, and after ``growth_interval`` clean
    steps the scale doubles (cap 2^24) and the count resets. The select
    is the caller's: it skipped the update already."""
    if not finite:
        return ls._replace(
            scale=torch.clamp_min(ls.scale * 0.5, MIN_SCALE),
            growth_count=torch.zeros_like(ls.growth_count))
    count = ls.growth_count + 1
    if int(count) >= ls.growth_interval:
        return ls._replace(scale=torch.clamp_max(ls.scale * 2.0, MAX_SCALE),
                           growth_count=torch.zeros_like(count))
    return ls._replace(growth_count=count)
