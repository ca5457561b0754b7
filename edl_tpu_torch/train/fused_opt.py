"""Fused optimizer: one kernel call per parameter bucket (port of
``edl_tpu.train.fused_opt``).

Parameters are packed into the same flat, dtype-grouped, 128-padded
buckets as the JAX package (``train/comm.plan_buckets``). A step hands
every bucket to one entry of ``ops/opt_kernels``, which on a card runs
one kernel call over a table of them: K4 (``sgdm_fp32_buckets``) or K5
(``adam_fp32_buckets``) with fp32 moments, one launch; K6
(``sgdm_q_buckets``) or K7 (``adam_q_buckets``) with quantized moments,
a memset and three passes. On the CPU each entry runs the plain version
bucket by bucket; the math per element is the JAX package's per-bucket
update.

Resident moment formats (``quant``): ``off`` keeps fp32 bucket buffers;
``int8``/``fp8`` keep each moment plane as a ``QPlane`` (the quantized
moment and its quantized error-feedback residual, one fp32 scale each per
bucket, on the device): 2 bytes an element instead of 4. The scales
follow the buckets, so the buckets follow the JAX package's leaf order
(the flax flatten order, ``bridge.flax_named_parameters``).

Design (the port's, recorded in PERF.md): the parameters LIVE in the
bucket buffers. ``init`` packs them (a bucket of one leaf without
padding is that leaf's own storage) and rebinds each parameter to a
view of its slot, so the kernel rewrites the module's weights where
they lie: no pack of the parameters before the update and no unpack
after it (the JAX package does both every step). Gradients are packed
once a step the same way: a one-leaf bucket without padding hands the
leaf's ``.grad`` to the kernel as it is; any other bucket is gathered
with one ``torch.cat``. The padding of the parameter and moment
buffers starts at zero and stays zero (a zero gradient, parameter and
moments give a zero update).

The step count and the schedule live on the host: lr, c1 = 1 - b1^t and
c2 = 1 - b2^t are fp32 values computed there (c1/c2 in fp32, as the
JAX package computes them) and passed to the kernel by value, so a step
reads nothing back from the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Union

import numpy as np
import torch

from edl_tpu_torch.ops import opt_kernels as ok
from edl_tpu_torch.train import comm as comm_lib

OPTIMIZERS = ok.OPTIMIZERS
QUANT_MODES = ok.QUANT_MODES
FUSED_MODES = ("off", "fp32", "int8", "fp8")   # the --fused-opt knob

_LANE = 128

ScheduleOrFloat = Union[float, Callable[[int], float]]


class FusedOptState(NamedTuple):
    """Resident optimizer state.

    count: optimizer steps taken (host int; Adam bias correction and the
       schedule's input).
    m, v: per-bucket moments: fp32 buffers (quant='off') or QPlanes
       (v is () for momentum-SGD).
    p: per-bucket fp32 buffers the parameters live in (views of them are
       the module's parameters).
    """

    count: int
    m: tuple
    v: tuple
    p: tuple


class FusedOptimizer:
    """Bucketed fused optimizer: ``init(params)`` then
    ``fused_apply(grads, opt_state, params)`` each step.

    ``params`` is the list of (name, parameter) pairs in the order the
    buckets follow. ``update`` raises: there is no
    de-fused update, the parameter write happens inside the kernel pass.
    """

    def __init__(self, optimizer: str, learning_rate: ScheduleOrFloat,
                 *, momentum: float = 0.9, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, quant: str = "off",
                 bucket_mb: float = 4.0):
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}, "
                             f"got {optimizer!r}")
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, "
                             f"got {quant!r}")
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.momentum = float(momentum)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.quant = quant
        self.bucket_mb = float(bucket_mb)

    def plan(self, params: Sequence) -> comm_lib.BucketPlan:
        plan = comm_lib.plan_buckets(_leaves(params), self.bucket_mb,
                                     align=_LANE)
        for b in plan.buckets:
            if b.dtype != torch.float32:
                raise ValueError(f"the fused optimizer takes fp32 params "
                                 f"only; got a {b.dtype} bucket")
        return plan

    def init(self, params: Sequence) -> FusedOptState:
        """Zero moments, and the parameters moved into bucket buffers
        (each parameter rebound to a view of its slot; a bucket of one
        leaf without padding keeps that leaf's own storage)."""
        plan = self.plan(params)
        leaves = _leaves(params)
        with torch.no_grad():
            # detached: a bucket is a plain buffer, not an autograd view
            # of the leaf it may share storage with
            p_bufs = tuple(b.detach()
                           for b in comm_lib.pack_buckets(leaves, plan))
            for leaf, view in zip(leaves,
                                  comm_lib.unpack_buckets(p_bufs, plan)):
                leaf.data = view
        def zero(b):
            if self.quant == "off":
                return torch.zeros_like(b)
            return ok.zero_plane(b.numel(), self.quant, device=b.device)

        m = tuple(zero(b) for b in p_bufs)
        v = (tuple(zero(b) for b in p_bufs)
             if self.optimizer == "adam" else ())
        return FusedOptState(count=0, m=m, v=v, p=p_bufs)

    def update(self, grads, state, params=None):
        raise NotImplementedError(
            "FusedOptimizer has no de-fused update(); the param write "
            "happens inside the kernel pass. Use fused_apply(grads, "
            "opt_state, params) — TrainState.apply_gradients does so.")

    def scalars(self, count: int) -> tuple[float, float, float]:
        """(lr, c1, c2) of the step after ``count`` steps, as fp32 values:
        c = 1 - b^t in fp32, t = count + 1."""
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else self.learning_rate)
        t = np.float32(count + 1)
        c1 = np.float32(1.0) - np.float32(self.b1) ** t
        c2 = np.float32(1.0) - np.float32(self.b2) ** t
        return float(np.float32(lr)), float(c1), float(c2)

    @torch.no_grad()
    def fused_apply(self, grads: Sequence, opt_state: FusedOptState,
                    params: Sequence):
        """One fused step over every bucket, in place. ``grads`` follow
        ``params``' order (None = a zero gradient). Returns (params,
        new_opt_state)."""
        plan = self.plan(params)
        leaves = _leaves(params)
        _check_views(leaves, opt_state.p, plan)
        lr, c1, c2 = self.scalars(opt_state.count)
        g_bufs = _grad_buckets(plan, leaves, grads)
        st = opt_state
        adam = dict(b1=self.b1, b2=self.b2, eps=self.eps,
                    wd=self.weight_decay)
        if self.optimizer == "adam" and self.quant == "off":
            ok.adam_fp32_buckets(st.p, g_bufs, st.m, st.v, lr, c1, c2, **adam)
        elif self.optimizer == "adam":
            ok.adam_q_buckets(st.p, g_bufs, st.m, st.v, lr, c1, c2,
                              quant=self.quant, **adam)
        elif self.quant == "off":
            ok.sgdm_fp32_buckets(st.p, g_bufs, st.m, lr, mu=self.momentum,
                                 wd=self.weight_decay)
        else:
            ok.sgdm_q_buckets(st.p, g_bufs, st.m, lr, mu=self.momentum,
                              wd=self.weight_decay, quant=self.quant)
        return params, opt_state._replace(count=opt_state.count + 1)


def _leaves(params: Sequence) -> list[torch.Tensor]:
    return [p for _, p in params]


def _grad_buckets(plan, leaves, grads) -> list[torch.Tensor]:
    """The buckets' flat gradients: a one-leaf bucket without padding is
    that leaf's own .grad; a None gradient (an unused parameter) is zero,
    as JAX's is."""
    return comm_lib.pack_buckets(
        [torch.zeros_like(p) if g is None else g
         for p, g in zip(leaves, grads)], plan)


def _check_views(leaves, p_bufs, plan) -> None:
    """Every parameter must still be the view of its slot that ``init``
    made (a ``module.to(...)`` or ``param.data = ...`` after init would
    leave the optimizer updating buffers the module no longer reads)."""
    for buf, b in zip(p_bufs, plan.buckets):
        base = buf.data_ptr()
        for s in b.slots:
            if leaves[s.leaf].data_ptr() != base + 4 * s.offset:
                raise RuntimeError(
                    f"parameter {s.leaf} no longer lives in its optimizer "
                    "bucket (moved or replaced after FusedOptimizer.init)")


def fused_sgd(learning_rate: ScheduleOrFloat, momentum: float = 0.9,
              weight_decay: float = 0.0, *, quant: str = "off",
              bucket_mb: float = 4.0) -> FusedOptimizer:
    """Fused momentum-SGD: optax.chain(add_decayed_weights(wd),
    sgd(lr, momentum))'s update in its expression order."""
    return FusedOptimizer("sgdm", learning_rate, momentum=momentum,
                          weight_decay=weight_decay, quant=quant,
                          bucket_mb=bucket_mb)


def fused_adam(learning_rate: ScheduleOrFloat, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, *, quant: str = "off",
               bucket_mb: float = 4.0) -> FusedOptimizer:
    """Fused Adam(W) (eps_root = 0, optax.adamw's order)."""
    return FusedOptimizer("adam", learning_rate, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay, quant=quant,
                          bucket_mb=bucket_mb)


def make_fused_tx(optimizer: str, learning_rate: ScheduleOrFloat,
                  fused_mode: str, **kw):
    """The --fused-opt knob -> tx. fused_mode: off|fp32|int8|fp8
    ('off' returns None: the caller keeps its unfused optimizer)."""
    if fused_mode not in FUSED_MODES:
        raise ValueError(f"fused mode must be one of {FUSED_MODES}, "
                         f"got {fused_mode!r}")
    if fused_mode == "off":
        return None
    quant = "off" if fused_mode == "fp32" else fused_mode
    factory = fused_sgd if optimizer == "sgdm" else fused_adam
    return factory(learning_rate, quant=quant, **kw)


def opt_state_bytes(opt_state: FusedOptState) -> int:
    """Resident optimizer-state bytes: the moment buffers, or every tensor
    of their QPlanes (the parameter buffers are the model's own weights).
    The quantized modes must cut it >= 1.8x."""
    return sum(t.numel() * t.element_size()
               for t in _moment_tensors(opt_state))


def _moment_tensors(state: FusedOptState) -> list[torch.Tensor]:
    """Every moment buffer, or every tensor of every QPlane."""
    out = []
    for moment in (*state.m, *state.v):
        out.extend(moment if isinstance(moment, ok.QPlane) else (moment,))
    return out


# -- parity gate -------------------------------------------------------------


def _gate_world(seed: int = 0, device: str | torch.device = "cpu"):
    """The JAX package's gate world, drawn the same way: a small ragged
    tree (multi-bucket packing, lane padding, an oversized leaf) as
    (name, tensor) pairs in flax flatten order, and its gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"dense/kernel": (257, 33), "dense/bias": (33,),
              "emb": (64, 64), "norm/scale": (129,)}
    params = {k: rng.normal(0, 0.1, size=s).astype(np.float32)
              for k, s in shapes.items()}
    order = sorted(params)       # jax.tree.map draws in flatten order
    grads = {k: rng.normal(0, 0.02, size=params[k].shape)
             .astype(np.float32) for k in order}
    pairs = [(k, torch.nn.Parameter(torch.from_numpy(params[k]).to(device)))
             for k in order]
    return pairs, [torch.from_numpy(grads[k]).to(device) for k in order]


def _run_fused(tx: FusedOptimizer, params, grads, steps: int,
               plain: bool = False) -> FusedOptState:
    """``steps`` fused steps in place; ``plain`` runs each bucket's plain
    version (``_sgdm_plain``/``_adam_plain``) on the same device instead
    of ``fused_apply``'s entries."""
    state = tx.init(params)
    for _ in range(steps):
        if not plain:
            _, state = tx.fused_apply(grads, state, params)
            continue
        lr, c1, c2 = tx.scalars(state.count)
        g_bufs = _grad_buckets(tx.plan(params), _leaves(params), grads)
        with torch.no_grad():
            for i, g in enumerate(g_bufs):
                if tx.optimizer == "sgdm":
                    ok._sgdm_plain(state.p[i], g, state.m[i], lr,
                                   tx.momentum, tx.weight_decay, tx.quant)
                else:
                    ok._adam_plain(state.p[i], g, state.m[i], state.v[i],
                                   lr, c1, c2, tx.b1, tx.b2, tx.eps,
                                   tx.weight_decay, tx.quant)
        state = state._replace(count=state.count + 1)
    return state


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (fp32 compared as int32, so -0.0 and
    +0.0 differ and a NaN equals its own bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def update_parity_gate(seed: int = 0, steps: int = 3, lr: float = 0.1,
                       wd: float = 1e-4,
                       device: str | torch.device = "cuda") -> dict:
    """The kernel-vs-plain half of the JAX package's gate: for every
    optimizer x quant mode, the fused update through ``fused_apply``
    (K4-K7 on a card) against each bucket's plain version on the same
    device, over ``steps`` steps of the gate world, bitwise (params,
    moments, quantized payloads and scales)."""
    report: dict = {"steps": steps, "device": str(device)}
    for opt in OPTIMIZERS:
        for quant in QUANT_MODES:
            states = []
            for plain in (False, True):
                params, grads = _gate_world(seed, device)
                if opt == "sgdm":
                    tx = fused_sgd(lr, 0.9, wd, quant=quant, bucket_mb=0.05)
                else:
                    tx = fused_adam(lr, weight_decay=wd, quant=quant,
                                    bucket_mb=0.05)
                states.append(_run_fused(tx, params, grads, steps,
                                         plain=plain))
            kern, ref = states
            report["buckets"] = len(kern.p)
            report[f"{opt}_{quant}_kernel_bitwise"] = all(
                bitwise_equal(a, b) for a, b in zip(
                    [*kern.p, *_moment_tensors(kern)],
                    [*ref.p, *_moment_tensors(ref)]))
    report["ok"] = all(v for k, v in report.items()
                       if k.endswith("_bitwise"))
    return report
