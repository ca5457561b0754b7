"""Learning-rate schedules (port of ``edl_tpu.train.lr``).

Each schedule is a plain callable ``step -> float`` that returns optax's
value for the same arguments: the arithmetic runs in fp32 in optax's
expression order (``linear_schedule``, ``cosine_decay_schedule``,
``warmup_cosine_decay_schedule``, ``piecewise_constant_schedule``,
``exponential_decay``, ``join_schedules``), so a value differs from
optax's only where numpy's fp32 ``cos``/``power`` round differently from
XLA's. Schedules run on the host: the fused optimizer hands the value to
its kernel by value.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

_f32 = np.float32


def _polynomial(init_value: float, end_value: float, power,
                transition_steps: int, transition_begin: int = 0
                ) -> Schedule:
    if transition_steps <= 0:
        return lambda count: float(_f32(init_value))
    transition_begin = max(0, transition_begin)

    def schedule(count: int) -> float:
        count = min(max(count - transition_begin, 0), transition_steps)
        frac = _f32(1) - _f32(count) / _f32(transition_steps)
        return float(_f32(init_value - end_value) * frac ** power
                     + _f32(end_value))

    return schedule


def _linear(init_value: float, end_value: float, transition_steps: int
            ) -> Schedule:
    return _polynomial(init_value, end_value, 1, transition_steps)


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0
                  ) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        count = min(_f32(count), _f32(decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(
            _f32(math.pi) * count / _f32(decay_steps)))
        decayed = _f32(1 - alpha) * cosine + _f32(alpha)
        return float(_f32(init_value) * decayed)

    return schedule


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def _piecewise_constant(init_value: float, boundaries_and_scales: dict
                        ) -> Schedule:
    def schedule(count: int) -> float:
        v = _f32(init_value)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v = _f32(scale) * v
        return float(v)

    return schedule


def _exponential_decay(init_value: float, transition_steps: int,
                       decay_rate: float, staircase: bool) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: float(_f32(init_value))

    def schedule(count: int) -> float:
        if count <= 0:
            return float(_f32(init_value))
        p = _f32(count) / _f32(transition_steps)
        if staircase:
            p = np.floor(p)
        return float(_f32(init_value) * np.power(_f32(decay_rate), p))

    return schedule


def linear_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    return _linear(0.0, base_lr, max(1, warmup_steps))


def piecewise_with_warmup(boundaries: list[int], values: list[float],
                          warmup_steps: int = 0) -> Schedule:
    """Step decay: lr = values[i+1] once the global step >= boundaries[i];
    linear warmup from 0 to values[0] over the first warmup_steps.
    Boundaries are GLOBAL steps (the join re-bases the inner schedule's
    step count to the join point, so they shift back by warmup_steps)."""
    assert len(values) == len(boundaries) + 1
    assert all(b > warmup_steps for b in boundaries), \
        "decay boundaries must come after warmup"

    def make_piecewise(offset: int) -> Schedule:
        return _piecewise_constant(
            values[0], {b - offset: values[i + 1] / values[i]
                        for i, b in enumerate(boundaries)})

    if warmup_steps <= 0:
        return make_piecewise(0)
    return _join([linear_warmup(values[0], warmup_steps),
                  make_piecewise(warmup_steps)], [warmup_steps])


def cosine_with_warmup(base_lr: float, total_steps: int,
                       warmup_steps: int = 0, end_lr: float = 0.0
                       ) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, base_lr, warmup_steps,
    max(total_steps, warmup_steps + 1), end_lr), or without warmup
    optax.cosine_decay_schedule(base_lr, total_steps, end_lr/base_lr)."""
    if warmup_steps <= 0:
        return _cosine_decay(base_lr, max(1, total_steps),
                             alpha=end_lr / max(base_lr, 1e-12))
    decay_steps = max(total_steps, warmup_steps + 1)
    alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr
    return _join([_linear(0.0, base_lr, warmup_steps),
                  _cosine_decay(base_lr, decay_steps - warmup_steps,
                                alpha=alpha)], [warmup_steps])


def exponential_with_warmup(base_lr: float, warmup_steps: int,
                            decay_steps: int, decay_rate: float,
                            staircase: bool = True) -> Schedule:
    decay = _exponential_decay(base_lr, decay_steps, decay_rate, staircase)
    if warmup_steps <= 0:
        return decay
    return _join([linear_warmup(base_lr, warmup_steps), decay],
                 [warmup_steps])


def scale_for_world(base_lr: float, base_world: int, world: int) -> float:
    """Linear-scaling rule on elastic resize: lr ∝ global batch size."""
    return base_lr * world / max(1, base_world)
