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

``python -m edl_tpu_torch.train.fused_opt smoke [--quant int8|fp8]
[--device cpu]`` runs the gate (``update_parity_gate``) and the
quantized-moment convergence smoke (``convergence_smoke``) and exits 0
only when both pass.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Union

import numpy as np
import torch

from edl_tpu_torch import resolve_device
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


def opt_state_bytes(opt_state) -> int:
    """Resident optimizer-state bytes: the moment buffers, or every tensor
    of their QPlanes (the parameter buffers are the model's own weights);
    for an unfused ``torch.optim`` optimizer, every tensor of its state
    (made at its first step). The quantized modes must cut it >= 1.8x."""
    if isinstance(opt_state, torch.optim.Optimizer):
        tensors = [t for st in opt_state.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor)]
    else:
        tensors = _moment_tensors(opt_state)
    return sum(t.numel() * t.element_size() for t in tensors)


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


# -- convergence-parity smoke (the gate for quantized moments) ---------------


def convergence_smoke(quant: str = "int8", steps: int = 40,
                      envelope: float = 0.25, weights: dict | None = None,
                      device: str | torch.device = "cuda") -> dict:
    """Quantized-moment convergence against the dense optimizer, the JAX
    package's smoke on one device: momentum-SGD trains the BatchNorm CNN
    (``comm._smoke_cnn``: dense ``state.sgd(0.05, 0.9)`` against
    ``fused_sgd(0.05, 0.9, quant=...)``, K6 on a card), Adam trains the
    Markov transformer (``comm._smoke_transformer``: ``state.adamw(1e-2)``
    against ``fused_adam(1e-2, quant=...)``, K7), each pair from the same
    init. Both runs must learn, the quantized run must keep at least
    ``1 - envelope`` of the dense run's loss improvement (a relative
    envelope: one bound across models whose losses differ 40x), and its
    optimizer state must be >= 1.8x smaller. ``weights`` ({"cnn_sgdm":
    state_dict, "transformer_adam": state_dict}) replaces the port's
    seeded init, e.g. with the JAX package's bridged one. The models and
    batches live on ``device`` (CUDA unless the caller asks for the CPU;
    raises where CUDA is asked for and absent)."""
    from edl_tpu_torch.train import state as state_lib
    from edl_tpu_torch.train.step import make_train_step

    dev = resolve_device(device)
    world = 1
    report: dict = {"quant": quant, "steps": steps, "envelope": envelope,
                    "world": world}

    def run(name, loss_fn, state_fn, quant_tx, batch):
        if weights is not None:
            state_fn = comm_lib._loaded(state_fn, weights[name])
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        step = make_train_step(loss_fn)
        s_a = state_fn()
        fresh = state_fn()
        s_b = state_lib.TrainState.create(model=fresh.model, tx=quant_tx,
                                          params=fresh.params)
        first = last_a = last_b = None
        for _ in range(steps):
            s_a, m_a = step(s_a, batch)
            s_b, m_b = step(s_b, batch)
            if first is None:
                first = float(m_a["loss"])
            last_a, last_b = float(m_a["loss"]), float(m_b["loss"])
        delta = abs(last_a - last_b)
        improvement = max(first - last_a, 1e-9)
        report[name] = {
            "loss_initial": round(first, 4),
            "loss_dense": round(last_a, 4),
            "loss_quant": round(last_b, 4),
            "delta_rel": round(delta / improvement, 5),
            "opt_bytes_dense": opt_state_bytes(s_a.opt_state),
            "opt_bytes_quant": opt_state_bytes(s_b.opt_state),
            "learned": last_a < first and last_b < first,
            "within_envelope": delta <= envelope * improvement}

    loss_fn, state_fn, batch = comm_lib._smoke_cnn(world, dev)
    run("cnn_sgdm", loss_fn, state_fn,
        fused_sgd(0.05, 0.9, quant=quant, bucket_mb=0.05), batch)

    loss_fn, tr_state_fn, batch = comm_lib._smoke_transformer(world, dev)
    lr = 1e-2

    def adam_state_fn():
        state = tr_state_fn()
        return state_lib.TrainState.create(
            model=state.model, tx=state_lib.adamw(lr), params=state.params)

    run("transformer_adam", loss_fn, adam_state_fn,
        fused_adam(lr, quant=quant, bucket_mb=0.05), batch)

    report["ok"] = all(
        report[k]["learned"] and report[k]["within_envelope"]
        and report[k]["opt_bytes_dense"]
        >= 1.8 * report[k]["opt_bytes_quant"]
        for k in ("cnn_sgdm", "transformer_adam"))
    return report


def _main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="edl_tpu_torch.train.fused_opt")
    sub = parser.add_subparsers(dest="cmd", required=True)
    smoke = sub.add_parser(
        "smoke", help="fused-optimizer gate: kernel equivalence (K4-K7 "
                      "against their plain versions, bit for bit) + "
                      "quantized-moment convergence parity against the "
                      "dense optimizer")
    smoke.add_argument("--quant", choices=("int8", "fp8"),
                       default="int8")
    smoke.add_argument("--steps", type=int, default=40)
    smoke.add_argument("--envelope", type=float, default=0.25,
                       help="RELATIVE loss envelope: the quantized run "
                            "must keep >= 1-envelope of dense's loss "
                            "improvement")
    smoke.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    gate = update_parity_gate(device=device)
    conv = convergence_smoke(quant=args.quant, steps=args.steps,
                             envelope=args.envelope, device=device)
    report = {"kernel_gate": gate, "convergence": conv,
              "ok": gate["ok"] and conv["ok"]}
    print(json.dumps({"fused_opt_smoke": report}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(_main())
