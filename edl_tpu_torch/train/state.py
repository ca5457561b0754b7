"""Train state and resume status (port of ``edl_tpu.train.state``).

``TrainState`` holds what a step updates: the module (its parameters),
the leaf list the optimizer follows, the optimizer and its state, and
the step count. PyTorch updates in place, so ``apply_gradients`` returns
the same object with the step advanced. ``TrainStatus`` is the host-side
resume cursor, a copy of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch


class TorchOptimizer:
    """The unfused optimizer as a tx: a ``torch.optim`` class, its
    hyperparameters and a schedule (the counterpart of an optax
    GradientTransformation with a schedule). ``init(params)`` builds the
    optimizer; ``step(opt, count)`` sets every group's lr to
    ``schedule(count)`` and steps it."""

    def __init__(self, cls: type, learning_rate, **kwargs: Any):
        self.cls = cls
        self.learning_rate = learning_rate
        self.kwargs = kwargs

    def lr(self, count: int) -> float:
        return float(self.learning_rate(count)
                     if callable(self.learning_rate) else self.learning_rate)

    def init(self, params: Sequence) -> torch.optim.Optimizer:
        return self.cls([p for _, p in params], lr=self.lr(0),
                        **self.kwargs)

    def step(self, opt: torch.optim.Optimizer, count: int) -> None:
        lr = self.lr(count)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> TorchOptimizer:
    """torch.optim.AdamW with optax.adamw's defaults: the same update
    (decoupled weight decay, bias-corrected moments, eps outside the
    square root), rounded in another order."""
    return TorchOptimizer(torch.optim.AdamW, learning_rate, betas=(b1, b2),
                          eps=eps, weight_decay=weight_decay)


def sgd(learning_rate, momentum: float = 0.9,
        weight_decay: float = 0.0) -> TorchOptimizer:
    """torch.optim.SGD for optax.chain(add_decayed_weights(wd),
    sgd(lr, momentum)): the same update (g + wd p into the momentum,
    p - lr m), rounded in another order."""
    return TorchOptimizer(torch.optim.SGD, learning_rate, momentum=momentum,
                          weight_decay=weight_decay, nesterov=False)


@dataclass
class TrainState:
    """The module, the (name, parameter) list the optimizer follows, the
    tx (a FusedOptimizer or a TorchOptimizer) and its state, and the
    optimizer steps taken."""

    model: torch.nn.Module
    params: list
    tx: Any
    opt_state: Any
    step: int = 0

    @classmethod
    def create(cls, *, model: torch.nn.Module, tx,
               params: Sequence | None = None) -> "TrainState":
        """``params`` defaults to ``model.named_parameters()``; the fused
        optimizer's buckets follow its order (the transformer passes the
        flax flatten order)."""
        params = list(params if params is not None
                      else model.named_parameters())
        return cls(model=model, params=params, tx=tx,
                   opt_state=tx.init(params))

    def apply_gradients(self) -> "TrainState":
        """One optimizer step from the parameters' ``.grad``, in place."""
        if hasattr(self.tx, "fused_apply"):
            # the fused bucket path: params and moments rewritten in one
            # kernel pass per bucket (train/fused_opt.py)
            grads = [p.grad for _, p in self.params]
            _, self.opt_state = self.tx.fused_apply(grads, self.opt_state,
                                                    self.params)
        else:
            self.tx.step(self.opt_state, self.step)
        self.step += 1
        return self


@dataclass
class TrainStatus:
    """Host-side resume cursor (the JAX package persists it beside each
    checkpoint; the port's checkpoints come with ROADMAP item 8)."""

    epoch: int = -1          # last fully completed epoch (-1 = none)
    step: int = 0            # global optimizer steps completed
    step_in_epoch: int = 0   # steps into the partially-done epoch (0 = none)
    samples_seen: int = 0    # for data-order resume bookkeeping
    world_size: int = 1      # devices at save time (resharding hint)

    def next_epoch(self) -> int:
        return self.epoch + 1
