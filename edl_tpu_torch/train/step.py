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

With a ``mesh`` of more than one rank (``parallel/mesh.make_mesh`` over
the joined world, data axes dp and fsdp, tp and sp) and no ``comm``, the
step is the JAX package's one SPMD program done by hand
(:class:`WorldTrainStep`):
each rank runs the forward and backward on its slice of the global
batch, BatchNorm takes the global batch's statistics
(``models/resnet.set_batch_group``), the gradients are averaged over the
world (one staged all-reduce per dtype over one flat buffer of the whole
leaves, in flax leaf order; a leaf sharded over fsdp got its mean from
the reduce-scatter of ``parallel/sharding.full``'s backward), the
optimizer runs as on one card (on the slices of sharded leaves), and
the loss and float metrics are averaged. Over an sp axis the ranks of a
replica hold the same rows and their sequence blocks (the model's
``cfg.sp``): each loss is the whole sequence's, with the gradient of the
rank's share (``models/transformer._sp_loss``), so the gradients are
summed over sp and averaged over the replicas. Every rank starts from
rank 0's whole parameters and buffers (a sharded leaf's slices are cut from one
seeded init on every rank). Under ``loss_scale`` each rank's finite flag
is all-reduced, so every rank skips the same step.
"""

from __future__ import annotations

from typing import Callable

import torch

from edl_tpu_torch.models.resnet import set_batch_group
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.parallel.mesh import DATA_AXES, TP_AXIS
from edl_tpu_torch.parallel.sharding import SP_AXIS, cuts, fsdp_spec
from edl_tpu_torch.train import amp
from edl_tpu_torch.train.comm import make_comm_train_step, sync_tensors

LossFn = Callable[..., tuple[torch.Tensor, dict]]


def make_train_step(loss_fn: LossFn, loss_scale: bool = False,
                    comm=None, with_step: bool = False,
                    topology=None, mesh=None) -> Callable:
    """Build a step from ``loss_fn(model, batch) -> (loss, aux)``.

    The JAX package's ``donate`` has no counterpart (the step updates in
    place). ``mesh`` with more than one rank and no ``comm`` gives the
    world step (see the module docstring); the comm path runs over the
    joined world as it is. ``loss_scale`` wraps the backward in dynamic
    loss scaling; it excludes ``comm``, as in the JAX package.
    """
    if comm is not None:
        if loss_scale:
            raise ValueError(
                "comm= and loss_scale= are mutually exclusive (the "
                "manual gradient path owns the backward's reduction; "
                "fp16 scaling is an amp-path feature)")
        return make_comm_train_step(loss_fn, config=comm, topology=topology,
                                    with_step=with_step)
    if mesh is not None and mesh.size > 1:
        return WorldTrainStep(loss_fn, mesh=mesh, loss_scale=loss_scale,
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


class WorldTrainStep:
    """The SPMD world step over a ``mesh`` of data axes (dp, fsdp), tp and
    sp; ``step(state, batch)`` or, with ``loss_scale``,
    ``step(state, batch, ls)``. Built lazily: the first call turns on the
    global-batch BatchNorm and broadcasts rank 0's whole parameters and
    buffers.

    Under tp the ranks of a replica hold the same rows and their slices
    of the tp-sharded leaves (``parallel/sharding.shard_module``, cut
    from one seeded init on every rank, so never broadcast). A gradient
    reduces only over the ranks that share its tp index
    (``mesh.cross_group("tp")``): a tp-replicated leaf (the LayerNorms,
    ``pos_embed``) already holds its whole gradient on every tp rank and
    is not summed over tp."""

    def __init__(self, loss_fn: LossFn, *, mesh, loss_scale: bool = False,
                 with_step: bool = False):
        others = [a for a in mesh.axis_names
                  if a not in DATA_AXES + (SP_AXIS, TP_AXIS)
                  and mesh.shape[a] > 1]
        if others:
            raise NotImplementedError(
                f"the world step runs dp/fsdp/tp/sp meshes; axes {others} "
                "shard expert tables over ep (ROADMAP Queue 1 item 14(d); "
                "--moe runs train/comm.MoECommStep)")
        if mesh.axis_size(SP_AXIS) > 1 and mesh.axis_size("fsdp") > 1:
            raise ValueError("sp and fsdp together: the JAX CLI refuses "
                             "--fsdp with --mesh sp")
        self.loss_fn, self.mesh = loss_fn, mesh
        self.loss_scale, self.with_step = loss_scale, with_step
        self.world = mesh.size
        self.dp = mesh.axis_size("dp")
        self.tp = mesh.axis_size(TP_AXIS)
        # the data replicas: the sp and tp ranks of one replica hold the
        # same rows; sp's gradients sum, tp's are each rank's own slices'
        self.replicas = mesh.size // (mesh.axis_size(SP_AXIS) * self.tp)
        # the ranks that share this rank's tp index (the whole world
        # without tp), over which every gradient reduces
        self.cross = mesh.size // self.tp
        self.cross_group = mesh.cross_group(TP_AXIS) if self.tp > 1 else None
        self.built = False
        self.steps = 0

    def _build(self, state) -> None:
        # every data axis together is the world: the default group
        set_batch_group(state.model, None, self.world)
        whole = [p for _, p in state.params if not cuts(p)]
        sync_tensors(whole + list(state.model.buffers()))
        self.built = True

    def _reduce(self, params: list) -> None:
        """Every gradient the mean over the data replicas (summed over
        sp), in place: the leaves not split over fsdp by one all-reduce
        per dtype over the ranks sharing the tp index, their gradients
        scaled by 1/replicas; an fsdp-sharded leaf's gradient is its fsdp
        group's mean already, and is averaged over the dp axis when there
        is one."""
        inv_w = 1.0 / self.replicas
        by_dtype: dict[torch.dtype, list] = {}
        for p in params:
            spec = fsdp_spec(p)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if spec is None:
                by_dtype.setdefault(p.grad.dtype, []).append(p)
            elif self.dp > 1:
                distributed.all_reduce(p.grad.mul_(1.0 / self.dp),
                                       self.mesh.group("dp"))
        for dtype in sorted(by_dtype, key=str):
            ps = by_dtype[dtype]
            flat = torch.cat([p.grad.reshape(-1) for p in ps]).mul_(inv_w)
            if self.cross > 1:
                distributed.all_reduce(flat, self.cross_group)
            offset = 0
            for p in ps:
                p.grad = flat[offset:offset + p.numel()].view_as(p)
                offset += p.numel()

    def _forward(self, state, batch):
        for _, p in state.params:
            p.grad = None
        loss, aux = (self.loss_fn(state.model, batch, state.step)
                     if self.with_step else self.loss_fn(state.model, batch))
        aux.pop("batch_stats", None)
        return loss, {k: v.detach() for k, v in aux.items()}

    def _metrics(self, loss, aux) -> dict:
        """The loss and the float metrics averaged over the world: one
        collective for all of them."""
        floats = [k for k, v in aux.items() if v.is_floating_point()]
        scalars = torch.stack([loss.detach().float()]
                              + [aux[k].float() for k in floats])
        distributed.all_reduce(scalars).div_(self.world)
        out = {"loss": scalars[0], **aux}
        for i, k in enumerate(floats):
            out[k] = scalars[i + 1]
        return out

    def __call__(self, state, batch, ls=None):
        if not self.built:
            self._build(state)
        params = [p for _, p in state.params]
        loss, aux = self._forward(state, batch)
        if not self.loss_scale:
            loss.backward()
            self._reduce(params)
            state = state.apply_gradients()
            self.steps += 1
            return state, self._metrics(loss, aux)
        amp.scaled_backward(loss, params, ls)
        self._reduce(params)
        finite = amp.all_finite(p.grad for p in params)
        flag = finite.float().reshape(1)
        distributed.all_reduce(flag)
        ok = amp.read_finite(flag[0] == self.world)
        if ok:   # every rank skips the same step
            state = state.apply_gradients()
        ls = amp.update_scale(ls, ok)
        self.steps += 1
        metrics = self._metrics(loss, aux)
        metrics.update(loss_scale=ls.scale, finite=flag[0] == self.world)
        return state, metrics, ls
