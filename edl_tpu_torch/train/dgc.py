"""Deep Gradient Compression: the update transform and the sparse
collective (port of ``edl_tpu.train.dgc``).

Two separable halves, as in the JAX package:

- :func:`dgc` is the optimizer DGC governs (the JAX package's
  ``optax.chain(dgc(sparsity, momentum, rampup_steps),
  add_decayed_weights(wd), sgd(lr))``, with its momentum-free sgd): per
  leaf, the momentum-corrected accumulator ``u = momentum * u + g``, the
  velocity ``v = residual + u``, the entries of ``v`` at or above the
  top-(1 - sparsity) magnitude threshold are sent (and cleared from ``u``
  and ``v``), the rest stay in the dense local residual; the parameters
  take ``p -= lr * (sent + wd * p)``. During ramp-up (the first
  ``rampup_steps`` steps) the update is the dense momentum-corrected
  ``u`` and the residual stays empty. Leaves under 64 entries are never
  compressed. In a world it runs after the world step's gradient
  all-reduce, as the JAX package's optax chain runs after XLA's psum, so
  every rank holds the same state.
- :func:`sparse_psum` is the communication half: each rank contributes
  its top-k (values, int32 indices) of each leaf, the ranks all-gather
  the pairs and scatter-add them into a dense sum. ``wire="int8"``
  quantizes the values with the shared int8 codec: one
  ``ops/pack.pack_int8_buckets`` call (kernel K8 on a card) over every
  leaf's values, one scale a leaf, then ``all_gather_packed``.

The threshold of a leaf above 16384 entries is estimated from a random
sample of 16384 positions (the DGC paper's recipe), re-drawn every step.
The JAX package draws them with threefry from ``PRNGKey(n % (2^31 - 1))``
folded with the step; the port draws them with a Philox generator seeded
by the same two numbers (:func:`philox_sample`). Callers that need the
JAX package's positions pass ``sample=`` (``(n, step) -> int64 indices``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from edl_tpu_torch.ops.pack import all_gather_packed, pack_int8_buckets
from edl_tpu_torch.parallel import distributed

SAMPLE_CAP = 16384
MIN_COMPRESS = 64

Sample = Callable[[int, int], torch.Tensor]


def philox_sample(n: int, step: int, device) -> torch.Tensor:
    """SAMPLE_CAP uniform positions in [0, n) for leaf size ``n`` at
    ``step``: Philox (the port's generator) seeded by (n mod 2^31 - 1,
    step)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(((n % (2**31 - 1)) << 32) | (step & 0xFFFFFFFF))
    return torch.randint(0, n, (SAMPLE_CAP,), generator=gen, device=dev)


def topk_threshold(flat: torch.Tensor, keep_frac: float, step: int,
                   sample: Sample | None = None) -> torch.Tensor:
    """|value| threshold keeping about ``keep_frac`` of ``flat``: the
    exact k-th largest magnitude up to SAMPLE_CAP entries, else the k-th
    largest of a random sample of SAMPLE_CAP positions."""
    n = flat.numel()
    if n <= SAMPLE_CAP:
        k = max(1, int(round(n * keep_frac)))
        return torch.topk(flat.abs(), k).values[-1]
    idx = (sample(n, step) if sample is not None
           else philox_sample(n, step, flat.device))
    mags = flat[idx.to(flat.device)].abs()
    k = max(1, int(round(mags.numel() * keep_frac)))
    return torch.topk(mags, k).values[-1]


class DGCState(NamedTuple):
    """The JAX package's DGCState: the step count and, per leaf, the
    momentum-corrected accumulator and the unsent residual."""

    step: int
    momentum: list
    residual: list


class DGCOptimizer:
    """The tx of ``--dgc-sparsity``: ``init(params)`` then
    ``apply(grads, state, params, count)`` each step (TrainState's
    unfused, non-torch.optim seam). ``last_sent`` holds the last step's
    updates (before weight decay), for :func:`compression_ratio`."""

    def __init__(self, learning_rate, *, sparsity: float = 0.99,
                 momentum: float = 0.9, rampup_steps: int = 0,
                 weight_decay: float = 0.0, sample: Sample | None = None):
        if not 0.0 <= sparsity < 1.0:
            raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
        self.learning_rate = learning_rate
        self.sparsity, self.momentum = float(sparsity), float(momentum)
        self.rampup_steps = int(rampup_steps)
        self.weight_decay = float(weight_decay)
        self.sample = sample
        self.last_sent: list[torch.Tensor] = []

    def lr(self, count: int) -> float:
        return float(self.learning_rate(count)
                     if callable(self.learning_rate) else self.learning_rate)

    def init(self, params: Sequence) -> DGCState:
        leaves = [p for _, p in params]
        return DGCState(0, [torch.zeros_like(p) for p in leaves],
                        [torch.zeros_like(p) for p in leaves])

    @torch.no_grad()
    def apply(self, grads: Sequence, state: DGCState, params: Sequence,
              count: int) -> DGCState:
        step = state.step + 1
        rampup = step <= self.rampup_steps
        lr = self.lr(count)
        sent_all = []
        for (_, p), g, u, v in zip(params, grads, state.momentum,
                                   state.residual):
            g = torch.zeros_like(p) if g is None else g
            u.mul_(self.momentum).add_(g)
            v.add_(u)
            if rampup:
                sent = u.clone()
                v.zero_()
            elif v.numel() < MIN_COMPRESS or self.sparsity == 0.0:
                sent = v.clone()
                v.zero_()
            else:
                thresh = topk_threshold(v.reshape(-1), 1.0 - self.sparsity,
                                        step, self.sample)
                mask = v.abs() >= thresh
                sent = torch.where(mask, v, torch.zeros_like(v))
                u.masked_fill_(mask, 0.0)
                v.masked_fill_(mask, 0.0)
            sent_all.append(sent)
            p.sub_((sent + self.weight_decay * p) * lr)
        self.last_sent = sent_all
        return state._replace(step=step)


def dgc(learning_rate, sparsity: float = 0.99, momentum: float = 0.9,
        rampup_steps: int = 0, weight_decay: float = 0.0,
        sample: Sample | None = None) -> DGCOptimizer:
    """The DGC optimizer (see the module docstring)."""
    return DGCOptimizer(learning_rate, sparsity=sparsity, momentum=momentum,
                        rampup_steps=rampup_steps, weight_decay=weight_decay,
                        sample=sample)


def sparse_psum(tensors: Sequence[torch.Tensor], group=None,
                keep_frac: float = 0.01, wire: str = "fp32"
                ) -> list[torch.Tensor]:
    """The sum over ``group`` of each tensor, each rank contributing only
    its top-k entries by magnitude (k = round(n * keep_frac), at least
    1); tensors under 64 entries (or ``keep_frac >= 1``) are summed
    dense. ``wire="int8"`` ships the values int8 with one fp32 scale a
    tensor. Returns dense sums, identical on every rank."""
    if wire not in ("fp32", "int8"):
        raise ValueError(f"wire must be 'fp32' or 'int8', got {wire!r}")
    out: list = [None] * len(tensors)
    picked = []
    for i, t in enumerate(tensors):
        n = t.numel()
        if n < MIN_COMPRESS or keep_frac >= 1.0:
            out[i] = distributed.all_reduce(t.clone(), group)
            continue
        k = max(1, int(round(n * keep_frac)))
        flat = t.reshape(-1)
        idx = torch.topk(flat.abs(), k).indices
        picked.append((i, flat, idx, flat[idx].contiguous()))
    packed = (pack_int8_buckets([vals for *_, vals in picked])
              if wire == "int8" and picked else [None] * len(picked))
    for (i, flat, idx, vals), pq in zip(picked, packed):
        if pq is not None:
            all_vals, _ = all_gather_packed(*pq, group)
            all_vals = all_vals.to(flat.dtype)
        else:
            all_vals = distributed.all_gather(vals, group)
        all_idx = distributed.all_gather(idx.to(torch.int32), group)
        dense = torch.zeros_like(flat).index_put_(
            (all_idx.reshape(-1).long(),), all_vals.reshape(-1),
            accumulate=True)
        out[i] = dense.view_as(tensors[i])
    return out


def compression_ratio(updates: Sequence[torch.Tensor]) -> float:
    """Fraction of nonzero entries in a (sparsified) update list."""
    total = sum(t.numel() for t in updates)
    nonzero = sum(int(torch.count_nonzero(t)) for t in updates)
    return nonzero / max(total, 1)
