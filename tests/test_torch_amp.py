"""The port's dynamic loss scaling (edl_tpu_torch/train/amp.py) and the
loss-scaled train step against the JAX package's (edl_tpu/train/amp.py),
case for case with tests/test_amp.py, on the same numpy-seeded inputs.

The scale's rules are exact fp32 arithmetic on both sides (halving,
doubling, the floor and the cap), and unscaling multiplies each fp32
gradient by the fp32 1/scale as JAX does: the scales, and the gradients
of a loss whose backward rounds in a fixed order, are held bit for bit.
The JAX package keeps the whole old state on a non-finite step; the
port decides before its in-place update and does not run the optimizer:
params, moments and the step count are held bit for bit unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.train import amp as jamp
from edl_tpu.train.state import TrainState as JTrainState
from edl_tpu.train.step import make_train_step as j_make_train_step
from edl_tpu_torch.train import amp
from edl_tpu_torch.train import fused_opt as tfo
from edl_tpu_torch.train import state as state_lib
from edl_tpu_torch.train.state import TrainState
from edl_tpu_torch.train.step import make_train_step


class _W(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(
            np.asarray(w, np.float32)).clone())


def _state(w=1.0, tx=None):
    model = _W(w)
    return TrainState.create(model=model, tx=tx or state_lib.sgd(0.1, 0.0))


def _ls(scale, count, interval):
    return (amp.DynamicLossScale(torch.tensor(scale, dtype=torch.float32),
                                 torch.tensor(count, dtype=torch.int32),
                                 interval),
            jamp.DynamicLossScale(jnp.float32(scale), jnp.int32(count),
                                  interval))


def _same_scale(port, jax_ls):
    assert port.scale.dtype == torch.float32
    assert port.scale.numpy().tobytes() == np.asarray(
        jax_ls.scale, np.float32).tobytes()
    assert int(port.growth_count) == int(jax_ls.growth_count)
    assert port.growth_interval == jax_ls.growth_interval


def test_create_matches_jax():
    _same_scale(amp.DynamicLossScale.create(), jamp.DynamicLossScale.create())
    _same_scale(amp.DynamicLossScale.create(1000.0, 7),
                jamp.DynamicLossScale.create(1000.0, 7))


@pytest.mark.parametrize("values,finite", [
    ([1.0, 2.0, 3.0], True), ([1.0, np.inf], False), ([np.nan], False),
    ([-np.inf, 0.0], False)])
def test_all_finite(values, finite):
    x = np.asarray(values, np.float32)
    assert bool(amp.all_finite([torch.from_numpy(x), torch.ones(2)])) \
        == bool(jamp.all_finite({"a": jnp.asarray(x), "b": jnp.ones(2)})) \
        == finite


def test_all_finite_of_nothing_is_true():
    assert bool(amp.all_finite([])) and bool(jamp.all_finite({}))


@pytest.mark.parametrize("scale", [1024.0, 2.0 ** 15, 3.0])
def test_grads_unscaled_back_bitwise(scale):
    """The reported loss is unscaled; the gradient of w^2 at scale s is
    2w s (1/s): the same fp32 bits as the JAX package's."""
    w = np.random.default_rng(0).normal(0, 1, 64).astype(np.float32)
    port_ls, jax_ls = _ls(scale, 0, 2000)
    state = _state(w)
    loss = (state.model.w ** 2).sum()
    grads = amp.scaled_backward(loss, [state.model.w], port_ls)
    (jloss, _), jgrads = jamp.scaled_value_and_grad(
        lambda p: (jnp.sum(p["w"] ** 2), {}), {"w": jnp.asarray(w)}, jax_ls)
    assert loss.item() == float(jloss)
    assert grads[0] is state.model.w.grad
    assert grads[0].numpy().tobytes() == np.asarray(jgrads["w"]).tobytes()


def test_grads_unscaled_back():
    port_ls, _ = _ls(1024.0, 0, 2000)
    state = _state(3.0)
    loss = state.model.w ** 2
    grads = amp.scaled_backward(loss, [state.model.w], port_ls)
    assert loss.item() == 9.0
    assert grads[0].item() == 6.0


@pytest.mark.parametrize("scale,count,interval,finite", [
    (8.0, 0, 2000, False),          # overflow halves, count resets
    (8.0, 5, 2000, True),           # a clean step counts
    (8.0, 1, 2, True),              # grows at the interval
    (1.0, 0, 2000, False),          # the floor
    (2.0 ** 24, 10, 1, True),       # the cap
    (3.0, 1999, 2000, True),        # a non-power-of-two scale grows
])
def test_update_scale_matches_jax(scale, count, interval, finite):
    port_ls, jax_ls = _ls(scale, count, interval)
    g = {"w": jnp.float32(1.0 if finite else jnp.nan)}
    new, old = {"w": jnp.float32(2.0)}, {"w": jnp.float32(1.0)}
    jax_ls2, sel, jfinite = jamp.update_scale_and_select(jax_ls, g, new,
                                                         old)
    assert bool(jfinite) == finite
    assert float(sel["w"]) == (2.0 if finite else 1.0)
    _same_scale(amp.update_scale(port_ls, finite), jax_ls2)


def test_overflow_halves_and_keeps_old():
    port_ls, _ = _ls(8.0, 3, 2000)
    ls2 = amp.update_scale(port_ls, False)
    assert float(ls2.scale) == 4.0 and int(ls2.growth_count) == 0


def test_growth_after_interval():
    port_ls, _ = _ls(8.0, 1, 2)
    ls2 = amp.update_scale(port_ls, True)
    assert float(ls2.scale) == 16.0 and int(ls2.growth_count) == 0


def test_scale_floor_and_cap():
    low, _ = _ls(1.0, 0, 2000)
    assert float(amp.update_scale(low, False).scale) == 1.0
    high, _ = _ls(2.0 ** 24, 10, 1)
    assert float(amp.update_scale(high, True).scale) == 2.0 ** 24


def _regression(state, params, batch):
    pred = params["w"] * batch["x"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def _port_regression(model, batch):
    pred = model.w * batch["x"]
    return ((pred - batch["y"]) ** 2).mean(), {}


def test_trains_like_unscaled_and_like_jax():
    """Ten loss-scaled steps of a regression: the port tracks its own
    unscaled step and the JAX package's loss-scaled one."""
    x = np.arange(1.0, 5.0, dtype=np.float32)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(3.0 * x)}
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(3.0 * x)}
    plain = make_train_step(_port_regression)
    scaled = make_train_step(_port_regression, loss_scale=True)
    jscaled = j_make_train_step(_regression, donate=False, loss_scale=True)
    s_plain, s_amp = _state(0.0), _state(0.0)
    js = JTrainState.create(apply_fn=None, params={"w": jnp.float32(0.0)},
                            tx=optax.sgd(0.1))
    ls, jls = amp.DynamicLossScale.create(), jamp.DynamicLossScale.create()
    for _ in range(10):
        s_plain, _ = plain(s_plain, batch)
        s_amp, m, ls = scaled(s_amp, batch, ls)
        js, jm, jls = jscaled(js, jbatch, jls)
        assert bool(m["finite"]) and bool(jm["finite"])
        assert float(m["loss_scale"]) == float(jm["loss_scale"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(s_amp.model.w.item(), s_plain.model.w.item(),
                               rtol=1e-5)
    np.testing.assert_allclose(s_amp.model.w.item(), float(js.params["w"]),
                               rtol=1e-5)
    assert s_amp.step == int(js.step) == 10
    _same_scale(ls, jls)


def _overflowing(model, batch):
    return model.w.sum() * torch.tensor(float("inf")), {}


@pytest.mark.parametrize("tx", ["sgd", "fused_adam"])
def test_overflow_step_skipped_in_train_step(tx):
    """A non-finite step leaves params, moments and the step count bit
    for bit as they were, halves the scale, reads the finite flag once,
    and the next finite step updates."""
    w = np.random.default_rng(1).normal(0, 1, 300).astype(np.float32)
    opt = (state_lib.sgd(0.1, 0.9) if tx == "sgd"
           else tfo.fused_adam(1e-2, bucket_mb=0.0005))
    state = _state(w, opt)
    good = make_train_step(_port_regression, loss_scale=True)
    bad = make_train_step(_overflowing, loss_scale=True)
    batch = {"x": torch.ones(300), "y": torch.zeros(300)}
    ls = amp.DynamicLossScale.create(init_scale=2.0 ** 15)
    state, m, ls = good(state, batch, ls)          # moments exist now
    before = [t.clone() for t in _state_tensors(state)]
    reads = amp.read_finite.reads
    state, m, ls = bad(state, batch, ls)
    assert not bool(m["finite"]) and float(m["loss_scale"]) == 2.0 ** 14
    assert amp.read_finite.reads == reads + 1
    assert state.step == 1
    after = _state_tensors(state)
    assert len(after) == len(before) > 1
    for a, b in zip(before, after):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    state, m, ls = good(state, batch, ls)
    assert bool(m["finite"]) and state.step == 2
    assert not torch.equal(state.model.w.detach(), before[0])
    # the JAX package's skip on the same shape of step
    jbad = j_make_train_step(
        lambda s, p, b: (jnp.sum(p["w"]) * jnp.float32(jnp.inf), {}),
        donate=False, loss_scale=True)
    js = JTrainState.create(apply_fn=None, params={"w": jnp.asarray(w)},
                            tx=optax.sgd(0.1, 0.9))
    js2, jm, jls = jbad(js, {}, jamp.DynamicLossScale.create(2.0 ** 15))
    assert not bool(jm["finite"]) and float(jls.scale) == 2.0 ** 14
    assert int(js2.step) == 0
    assert np.asarray(js2.params["w"]).tobytes() == w.tobytes()


def _state_tensors(state):
    """The parameter, then every optimizer-state tensor."""
    out = [state.model.w.detach()]
    opt = state.opt_state
    if isinstance(opt, torch.optim.Optimizer):
        out += [t for st in opt.state.values() for t in st.values()
                if isinstance(t, torch.Tensor)]
    else:
        out += [*opt.p, *opt.m, *opt.v]
    return out


def test_loss_scale_excludes_comm():
    from edl_tpu_torch.train.comm import CommConfig

    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(_port_regression, loss_scale=True,
                        comm=CommConfig(compress="int8"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        j_make_train_step(_regression, loss_scale=True, comm=object(),
                          mesh=object())
