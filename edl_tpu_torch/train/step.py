"""Train step builder (port of ``edl_tpu.train.step``).

``make_train_step(loss_fn)`` returns ``step(state, batch) -> (state,
metrics)``: the forward through ``loss_fn(model, batch) -> (loss, aux)``
(``loss_fn(model, batch, step)`` with ``with_step=True``, for losses
that draw per-step randomness as the JAX package's do from
``state.step``), ``loss.backward()``, then ``state.apply_gradients()``
(the fused optimizer's seam). With ``comm`` (a
``train/comm.CommConfig``, and optionally the slice ``topology``) the
step is the manual gradient path over the joined world instead
(``train/comm.make_comm_train_step``). BatchNorm statistics are module
buffers that the train-mode forward updates in place, so the JAX
package's ``aux["batch_stats"]`` has nothing to fold. Metrics stay device
tensors: the step never reads a value back, so the host keeps queueing
work; the loop reads them at its log points only.

With ``loss_scale=True`` (fp16 dynamic loss scaling, ``train/amp.py``)
the step is ``step(state, batch, ls) -> (state, metrics, ls)`` and its
metrics gain ``loss_scale`` and ``finite``. That step reads one value
back, the finite flag, and runs the optimizer only on a finite step.
"""

from __future__ import annotations

from typing import Callable

import torch

from edl_tpu_torch.train import amp
from edl_tpu_torch.train.comm import make_comm_train_step

LossFn = Callable[..., tuple[torch.Tensor, dict]]


def make_train_step(loss_fn: LossFn, loss_scale: bool = False,
                    comm=None, with_step: bool = False,
                    topology=None) -> Callable:
    """Build a step from ``loss_fn(model, batch) -> (loss, aux)``.

    The JAX package's ``donate`` has no counterpart (the step updates in
    place), nor its ``mesh`` (the world is the joined process group).
    ``loss_scale`` wraps the backward in dynamic loss scaling (see the
    module docstring); it excludes ``comm``, as in the JAX package.
    """
    if comm is not None:
        if loss_scale:
            raise ValueError(
                "comm= and loss_scale= are mutually exclusive (the "
                "manual gradient path owns the backward's reduction; "
                "fp16 scaling is an amp-path feature)")
        return make_comm_train_step(loss_fn, config=comm, topology=topology,
                                    with_step=with_step)

    def forward(state, batch):
        for _, p in state.params:
            p.grad = None
        loss, aux = (loss_fn(state.model, batch, state.step) if with_step
                     else loss_fn(state.model, batch))
        # BatchNorm statistics live in the module's buffers and were
        # updated by the forward: nothing to fold into the state
        aux.pop("batch_stats", None)
        return loss, {k: v.detach() for k, v in aux.items()}

    if loss_scale:
        def amp_step(state, batch, ls):
            loss, aux = forward(state, batch)
            grads = amp.scaled_backward(loss, [p for _, p in state.params],
                                        ls)
            finite = amp.all_finite(g for g in grads if g is not None)
            ok = amp.read_finite(finite)
            if ok:   # a skipped step leaves params, moments and step as is
                state = state.apply_gradients()
            ls = amp.update_scale(ls, ok)
            return state, {"loss": loss.detach(), "loss_scale": ls.scale,
                           "finite": finite, **aux}, ls

        return amp_step

    def step(state, batch):
        loss, aux = forward(state, batch)
        loss.backward()
        state = state.apply_gradients()
        return state, {"loss": loss.detach(), **aux}

    return step

