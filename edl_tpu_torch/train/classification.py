"""Classification losses and step builders (label smoothing, mixup),
port of ``edl_tpu.train.classification``.

``make_classification_step`` returns the ``step(state, batch)`` of
``train/step.py`` for {'image', 'label'} batches: the model's forward in
train mode (BatchNorm statistics update the module's buffers), soft
cross-entropy against (smoothed, optionally mixed) one-hot targets, and
the optimizer step through ``TrainState.apply_gradients`` (with
``comm``, the manual gradient path of ``train/comm.py`` over the joined
world).
``make_eval_step`` runs the model in eval mode (running statistics) and
returns top-1/top-5 accuracy. The distill steps (``make_distill_step``,
``make_sparse_distill_step``) come with the student side (ROADMAP Queue 1
item 12).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.bridge import flax_named_parameters
from edl_tpu_torch.ops.augment import mixup
from edl_tpu_torch.train.state import TrainState
from edl_tpu_torch.train.step import make_train_step


def smoothed_labels(labels: torch.Tensor, num_classes: int,
                    smoothing: float = 0.0) -> torch.Tensor:
    """Integer labels -> (optionally smoothed) one-hot targets, fp32."""
    one_hot = F.one_hot(labels.long(), num_classes).float()
    if smoothing > 0.0:
        one_hot = one_hot * (1.0 - smoothing) + smoothing / num_classes
    return one_hot


def soft_cross_entropy(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean CE between logits and a target distribution."""
    return -torch.mean(torch.sum(targets * torch.log_softmax(logits, -1),
                                 dim=-1))


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 1) -> torch.Tensor:
    topk = torch.topk(logits, k, dim=-1).indices
    hit = (topk == labels.long()[:, None]).any(dim=-1)
    return hit.float().mean()


def create_state(model: torch.nn.Module, tx) -> TrainState:
    """A TrainState for a classification model built (and initialized
    from its seed) by the caller. The optimizer follows the flax flatten
    order of the parameters, as the JAX package's buckets do."""
    return TrainState.create(model=model, tx=tx,
                             params=flax_named_parameters(model))


def mixup_rng(seed: int, step: int) -> np.random.Generator:
    """The mixup draws of one step: a generator seeded by (seed, step),
    so a resumed run replays the same stream."""
    return np.random.default_rng([seed, step])


def make_classification_step(num_classes: int, *, smoothing: float = 0.0,
                             mixup_alpha: float = 0.0, seed: int = 0,
                             comm=None, topology=None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` for {'image', 'label'}
    batches; metrics hold the loss and the batch's top-1 accuracy as
    device tensors. ``comm``/``topology`` route the gradient reduction
    through the manual bucketed path (see ``make_train_step``)."""

    def loss_fn(model: torch.nn.Module, batch: dict,
                step: int) -> tuple[torch.Tensor, dict]:
        targets = smoothed_labels(batch["label"], num_classes, smoothing)
        images = batch["image"]
        if mixup_alpha > 0.0:
            images, targets = mixup(images, targets, mixup_alpha,
                                    rng=mixup_rng(seed, step))
        model.train()
        logits = model(images)
        return soft_cross_entropy(logits, targets), {
            "acc1": accuracy_topk(logits.detach(), batch["label"], 1)}

    return make_train_step(loss_fn, with_step=True, comm=comm,
                           topology=topology)


def make_eval_step() -> Callable:
    """``eval_step(state, batch) -> {'acc1', 'acc5'}`` in eval mode (the
    running statistics); the model goes back to train mode after."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict[str, Any]:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            logits = model(batch["image"])
        finally:
            model.train(was_training)
        return {"acc1": accuracy_topk(logits, batch["label"], 1),
                "acc5": accuracy_topk(logits, batch["label"],
                                      min(5, logits.shape[-1]))}

    return eval_step
