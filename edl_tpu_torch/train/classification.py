"""Classification losses and step builders (label smoothing, mixup,
distill), port of ``edl_tpu.train.classification``.

``make_classification_step`` returns the ``step(state, batch)`` of
``train/step.py`` for {'image', 'label'} batches: the model's forward in
train mode (BatchNorm statistics update the module's buffers), soft
cross-entropy against (smoothed, optionally mixed) one-hot targets, and
the optimizer step through ``TrainState.apply_gradients`` (with
``comm``, the manual gradient path of ``train/comm.py`` over the joined
world; with a ``mesh``, the SPMD world step).
``make_eval_step`` runs the model in eval mode (running statistics) and
returns top-1/top-5 accuracy. The distill steps (``make_distill_step``,
``make_sparse_distill_step``) train against a teacher's logits that the
``DistillReader`` put in the batch: temperature-scaled KL against the
dense logits, or against the teacher's top-k (``sparse_distill_kl``,
which never forms the dense teacher tensor), optionally mixed with the
hard-label cross-entropy; with a ``mesh``, as the SPMD world step.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.bridge import flax_named_parameters
from edl_tpu_torch.ops.augment import mixup, normalize_image
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


def distill_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               temperature: float = 1.0) -> torch.Tensor:
    """Temperature-scaled KL(teacher || student), scaled by T^2 (Hinton)."""
    t = temperature
    teacher = torch.softmax(teacher_logits.float() / t, dim=-1)
    return soft_cross_entropy(student_logits / t, teacher) * t * t


def sparse_distill_kl(student_logits: torch.Tensor,
                      teacher_idx: torch.Tensor, teacher_val: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """``distill_kl`` against a top-k teacher: (B, K) indices and values
    off the compressed teacher wire. The teacher's probabilities
    renormalize over its k classes (what scatter-expanding with a -inf
    fill gives), and the student's log-probabilities are gathered at the
    teacher's indices: the dense (B, C) teacher tensor never exists."""
    t = temperature
    teacher = torch.softmax(teacher_val.float() / t, dim=-1)
    logp = torch.log_softmax(student_logits.float() / t, dim=-1)
    logp_k = torch.gather(logp, -1, teacher_idx.long())
    return -torch.mean(torch.sum(teacher * logp_k, dim=-1)) * t * t


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 1) -> torch.Tensor:
    topk = torch.topk(logits, k, dim=-1).indices
    hit = (topk == labels.long()[:, None]).any(dim=-1)
    return hit.float().mean()


def create_state(model: torch.nn.Module, tx) -> TrainState:
    """A TrainState for a classification model built (and initialized
    from its seed) by the caller. The optimizer follows the flax flatten
    order of the parameters, as the JAX package's buckets do. The JAX
    package's ``input_shape``/``input_dtype`` (an init forward, int32
    for the text students' token ids) have no counterpart: the port's
    models size their parameters at construction and take int32 or
    int64 ids."""
    return TrainState.create(model=model, tx=tx,
                             params=flax_named_parameters(model))


def mixup_rng(seed: int, step: int) -> np.random.Generator:
    """The mixup draws of one step: a generator seeded by (seed, step),
    so a resumed run replays the same stream."""
    return np.random.default_rng([seed, step])


def make_classification_step(num_classes: int, *, smoothing: float = 0.0,
                             mixup_alpha: float = 0.0, seed: int = 0,
                             normalize: str | None = None,
                             comm=None, topology=None,
                             mesh=None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` for {'image', 'label'}
    batches; metrics hold the loss and the batch's top-1 accuracy as
    device tensors. ``normalize`` ('imagenet' | 'unit') turns uint8
    pixels into normalized floats on the device first (the JPEG and
    packed planes ship bytes). ``comm``/``topology`` route the gradient
    reduction through the manual bucketed path, ``mesh`` (a world above
    one) through the SPMD world step with global-batch BatchNorm (see
    ``make_train_step``)."""

    def loss_fn(model: torch.nn.Module, batch: dict,
                step: int) -> tuple[torch.Tensor, dict]:
        targets = smoothed_labels(batch["label"], num_classes, smoothing)
        images = normalize_image(batch["image"], normalize)
        if mixup_alpha > 0.0:
            images, targets = mixup(images, targets, mixup_alpha,
                                    rng=mixup_rng(seed, step))
        model.train()
        logits = model(images)
        return soft_cross_entropy(logits, targets), {
            "acc1": accuracy_topk(logits.detach(), batch["label"], 1)}

    return make_train_step(loss_fn, with_step=True, comm=comm,
                           topology=topology, mesh=mesh)


def _make_kd_step(kd_loss: Callable, num_classes: int, *,
                  hard_weight: float, smoothing: float, input_key: str,
                  normalize: str | None = None, mesh=None) -> Callable:
    """The distill steps' shared plumbing: ``kd_loss(logits, batch) ->
    loss`` is all that differs between the dense and sparse variants."""

    def loss_fn(model: torch.nn.Module,
                batch: dict) -> tuple[torch.Tensor, dict]:
        model.train()
        logits = model(normalize_image(batch[input_key], normalize))
        loss = kd_loss(logits, batch)
        if hard_weight > 0.0:
            targets = smoothed_labels(batch["label"], num_classes, smoothing)
            loss = ((1.0 - hard_weight) * loss
                    + hard_weight * soft_cross_entropy(logits, targets))
        return loss, {"acc1": accuracy_topk(logits.detach(), batch["label"],
                                            1)}

    return make_train_step(loss_fn, mesh=mesh)


def make_distill_step(num_classes: int, *, temperature: float = 1.0,
                      hard_weight: float = 0.0, smoothing: float = 0.0,
                      input_key: str = "image",
                      predict_key: str = "teacher_logits",
                      normalize: str | None = None, mesh=None) -> Callable:
    """Step for {input_key, 'label', predict_key} batches: the KD loss
    (plus, with ``hard_weight``, the hard-label CE mix); the student side
    of the DistillReader pipeline. ``mesh`` (a world above one) gives the
    SPMD world step, as ``make_classification_step``'s does; the JAX
    package's ``donate`` has no counterpart."""

    def kd_loss(logits, batch):
        return distill_kl(logits, batch[predict_key], temperature)

    return _make_kd_step(kd_loss, num_classes, hard_weight=hard_weight,
                         smoothing=smoothing, input_key=input_key,
                         normalize=normalize, mesh=mesh)


def make_sparse_distill_step(num_classes: int, *, temperature: float = 1.0,
                             hard_weight: float = 0.0,
                             smoothing: float = 0.0,
                             input_key: str = "image",
                             predict_key: str = "teacher_logits",
                             normalize: str | None = None,
                             mesh=None) -> Callable:
    """``make_distill_step`` for sparse teacher targets: batches carry
    ``{predict_key}.idx`` / ``{predict_key}.val`` (a DistillReader with
    ``compress_topk=K, sparse_predicts=True``) instead of dense logits."""

    def kd_loss(logits, batch):
        return sparse_distill_kl(logits, batch[predict_key + ".idx"],
                                 batch[predict_key + ".val"], temperature)

    return _make_kd_step(kd_loss, num_classes, hard_weight=hard_weight,
                         smoothing=smoothing, input_key=input_key,
                         normalize=normalize, mesh=mesh)


def make_eval_step(input_key: str = "image",
                   normalize: str | None = None) -> Callable:
    """``eval_step(state, batch) -> {'acc1', 'acc5'}`` in eval mode (the
    running statistics) over ``batch[input_key]``; the model goes back to
    train mode after."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict[str, Any]:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            logits = model(normalize_image(batch[input_key], normalize))
        finally:
            model.train(was_training)
        return {"acc1": accuracy_topk(logits, batch["label"], 1),
                "acc5": accuracy_topk(logits, batch["label"],
                                      min(5, logits.shape[-1]))}

    return eval_step
