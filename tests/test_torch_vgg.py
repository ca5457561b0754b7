"""The port's VGG (edl_tpu_torch.models.vgg) against the JAX package's
on the same numpy inputs and bridged variables, on the CPU.

- Parameter counts of VGG11/13/16/19 equal the JAX package's (at 64 px,
  1000 classes and a narrow fc_dim; VGG16 also at 224 px, where the JAX
  package's full width has the zoo teacher's 138,365,992).
- The eval forward of full-depth, full-width VGG16 at 64 px (the last
  map 2x2 before ``fc0``, so the flatten order shows), batch 2, with
  seeded BatchNorm statistics: fp32 within 1e-4 of max |ref| (measured
  under 3e-6), bf16 activations within 3e-2 of it (the two frameworks
  round bf16 at other places). A control must miss the fp32 bound:
  ``fc0``'s rows in torch's C·H·W flatten order (what an NCHW flatten
  would read); at 32 px that order is flax's, which is why the check
  runs at 64.
- Two momentum-SGD steps of VGG11(dropout=0.0) at 64 px through the
  port's classification step against the JAX package's
  make_classification_step: losses and BatchNorm statistics within
  1e-5, each leaf's update within 2e-2 relative L2 (fp32: a ReLU input
  within rounding of 0 takes the other side in one package). The
  control of that cause: the same steps with float64 activations and
  BatchNorms in both packages hold every update within 1e-5 (1.12e-6
  measured, where the fp32 run measures 9.36e-3).
- The bridge round trip is bitwise, both ways.
- Training with dropout > 0 raises in the port, naming the reference's
  fault, as flax raises InvalidRngError in the JAX package.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import vgg as jvgg
from edl_tpu.train import classification as jcls
from edl_tpu.train.state import TrainState as JTrainState
from edl_tpu_torch import bridge
from edl_tpu_torch.models import get_model
from edl_tpu_torch.models import vgg as tvgg
from edl_tpu_torch.models.resnet import BatchNorm
from edl_tpu_torch.train import classification as tcls
from edl_tpu_torch.train.state import sgd

NAMES = ("VGG11", "VGG13", "VGG16", "VGG19")
LR = 0.01
UPDATE_REL = 2e-2
# float64 control: 1.12e-6 measured (the fp32 storage of the conv and
# dense parameters, the same in both packages, is what is left)
UPDATE_REL_F64 = 1e-5


def _jax_count(name: str, size: int, **kw) -> int:
    shapes = jax.eval_shape(lambda: getattr(jvgg, name)(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", NAMES)
def test_parameter_counts_equal_the_jax_packages(name):
    """Every conv, BatchNorm and FC layer's shapes (a narrow fc_dim keeps
    the build cheap; fc1's and the head's widths follow it)."""
    model = get_model(name)(num_classes=1000, fc_dim=8, image_size=64,
                            device="cpu")
    assert sum(p.numel() for p in model.parameters()) == _jax_count(
        name, 64, fc_dim=8)


def test_vgg16_at_224_px():
    """At the zoo teacher's 224 px: the JAX package's VGG16 has
    138,365,992 parameters, and the port's fc0 reads the 7x7x512 map as
    the JAX package's does (a narrow fc_dim keeps the build cheap; the
    full-width count is chip_smoke's phase 20)."""
    assert _jax_count("VGG16", 224) == 138_365_992
    model = tvgg.VGG16(num_classes=1000, fc_dim=8, device="cpu")
    assert model.fc0.in_features == 7 * 7 * 512
    assert sum(p.numel() for p in model.parameters()) == _jax_count(
        "VGG16", 224, fc_dim=8)


@pytest.fixture(scope="module")
def vgg16_64():
    """JAX VGG16's seeded init at 64 px with seeded BatchNorm
    statistics (numpy leaves), and a batch of 2 images."""
    v = jax.device_get(jax.jit(lambda r: jvgg.VGG16(
        num_classes=1000, dtype=jnp.float32).init(
            r, jnp.zeros((1, 64, 64, 3)), train=False))(
                jax.random.PRNGKey(0)))
    v = flax.core.unfreeze(v)
    rng = np.random.default_rng(1)
    for stats in v["batch_stats"].values():
        stats["mean"] = rng.normal(0, 0.1, stats["mean"].shape).astype(
            np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(
            np.float32)
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    return v, x


def _port_forward(v, x, dtype) -> np.ndarray:
    model = tvgg.VGG16(num_classes=1000, dtype=dtype, image_size=64,
                       device="cpu")
    model.load_state_dict(bridge.flax_variables_to_torch(v))
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def _hwc_to_chw_rows(w: np.ndarray, h: int, c: int = 512) -> np.ndarray:
    """fc0's flax kernel (H·W·C rows) with its rows in C·H·W order: the
    rows an NCHW flatten would read."""
    return w.reshape(h, h, c, -1).transpose(2, 0, 1, 3).reshape(
        h * h * c, -1)


def test_vgg16_eval_forward_fp32_and_flatten_order(vgg16_64):
    v, x = vgg16_64
    ref = np.asarray(jvgg.VGG16(num_classes=1000, dtype=jnp.float32).apply(
        v, x, train=False))
    bound = 1e-4 * float(np.abs(ref).max())
    got = _port_forward(v, x, torch.float32)
    assert got.shape == (2, 1000) and got.dtype == np.float32
    assert float(np.abs(got - ref).max()) <= bound

    wrong = jax.tree_util.tree_map(lambda a: a, v)
    wrong["params"]["fc0"]["kernel"] = _hwc_to_chw_rows(
        v["params"]["fc0"]["kernel"], 2)
    miss = _port_forward(wrong, x, torch.float32)
    assert float(np.abs(miss - ref).max()) > 100 * bound
    # at 32 px the last map is 1x1: both orders are one, nothing shows
    k = np.arange(512 * 8).reshape(512, 8)
    np.testing.assert_array_equal(_hwc_to_chw_rows(k, 1), k)


def test_vgg16_eval_forward_bf16(vgg16_64):
    v, x = vgg16_64
    ref = np.asarray(jvgg.VGG16(num_classes=1000).apply(v, x, train=False))
    got = _port_forward(v, x, torch.bfloat16)
    assert got.dtype == np.float32                # the fp32 head
    assert float(np.abs(got - ref).max()) <= 3e-2 * float(np.abs(ref).max())


def _rel_update_err(ours, before, want) -> float:
    """|our update - JAX's update| / |JAX's update| (L2, one leaf)."""
    d = np.asarray(want, np.float64) - np.asarray(before, np.float64)
    return float(np.linalg.norm(np.asarray(ours, np.float64) - want)
                 / max(np.linalg.norm(d), 1e-30))


def _two_sgd_steps(jdtype, tdtype) -> float:
    """Two momentum-SGD steps of VGG11(dropout=0.0) at 64 px in both
    packages, activations in ``jdtype``/``tdtype``, each step from the JAX
    state; losses and BatchNorm statistics within 1e-5. Returns the worst
    leaf's relative L2 error of the update."""
    rng = np.random.default_rng(3)
    batches = [{"image": rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 4).astype(np.int32)}
               for _ in range(2)]
    jmodel = jvgg.VGG11(num_classes=10, fc_dim=64, dropout=0.0,
                        dtype=jdtype)
    v = flax.core.unfreeze(jax.device_get(jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(4))))
    # the BatchNorms' scale, offset and statistics in the activations'
    # dtype in both packages (flax keeps float64 statistics under
    # jax_enable_x64; a no-op in fp32)
    for name in v["batch_stats"]:
        for tree in (v["params"], v["batch_stats"]):
            tree[name] = jax.tree.map(lambda a: a.astype(jdtype), tree[name])
    # optax.chain(add_decayed_weights, sgd(schedule, momentum)): the
    # optimizer tree the port's torch SGD checkpoints as
    jtx = optax.chain(optax.add_decayed_weights(0.0),
                      optax.sgd(optax.constant_schedule(LR), momentum=0.9))
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=v["params"],
                                tx=jtx, batch_stats=v["batch_stats"])
    jstep = jcls.make_classification_step(10, donate=False)

    model = tvgg.VGG11(num_classes=10, fc_dim=64, dropout=0.0,
                       dtype=tdtype, image_size=64, device="cpu")
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.to(tdtype)
    state = tcls.create_state(model, sgd(LR, momentum=0.9))
    step = tcls.make_classification_step(10)
    worst = 0.0
    for b in batches:
        bridge.flax_to_state(flax.serialization.to_state_dict(
            jax.device_get(jstate)), state)
        before = jax.device_get(jstate.params)
        jstate, jm = jstep(jstate, b)
        state, tm = step(state, {k: torch.from_numpy(a) for k, a in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        ours = bridge.torch_to_flax_variables(model.state_dict())
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jstate.batch_stats)[0]:
            np.testing.assert_allclose(_at(ours["batch_stats"], path),
                                       np.asarray(leaf), atol=1e-5)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jstate.params)[0]:
            if path[-1].key == "bias" and path[0].key.startswith("conv"):
                continue   # a bias under BatchNorm: its gradient is noise
            worst = max(worst, _rel_update_err(
                _at(ours["params"], path), _at(before, path),
                np.asarray(leaf)))
    assert state.step == int(jstate.step) == 2
    return worst


def test_two_sgd_steps_match_make_classification_step():
    """Each step starts from the JAX state (parameters, statistics,
    momentum written into the port's state through the bridge): a ReLU
    input within fp32 rounding of 0 takes the other side in one package
    and moves its gradient discontinuously, and carried over two steps
    such a flip would compare the rounding, not the step. The float64
    control below holds that cause."""
    worst = _two_sgd_steps(jnp.float32, torch.float32)
    assert worst <= UPDATE_REL, worst


def test_two_sgd_steps_in_float64_close_the_update_bound():
    """The control of the fp32 bound's cause: the same two steps with
    float64 activations and BatchNorms (scale, offset, statistics) in
    both packages (jax_enable_x64 for this test only; the conv and dense
    parameters stay fp32, and so does the head, fp32 in both models)
    leave no ReLU input within rounding of 0, and every leaf's update is
    within UPDATE_REL_F64 of JAX's, 2000 times under the fp32 bound."""
    jax.config.update("jax_enable_x64", True)
    try:
        worst = _two_sgd_steps(jnp.float64, torch.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert worst <= UPDATE_REL_F64, worst


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_bridge_round_trip_is_bitwise(vgg16_64):
    v, _ = vgg16_64
    sd = bridge.flax_variables_to_torch(v)
    back = bridge.torch_to_flax_variables(sd)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        assert flat_b[path].tobytes() == np.asarray(leaf).tobytes()
        assert flat_b[path].shape == np.asarray(leaf).shape
    again = bridge.flax_variables_to_torch(back)
    assert sorted(again) == sorted(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    assert sd["conv0_0.weight"].shape == (64, 3, 3, 3)     # OIHW
    assert sd["fc0.weight"].shape == (4096, 2 * 2 * 512)


def test_dropout_in_training_raises_as_the_reference_does():
    model = tvgg.VGG11(num_classes=10, fc_dim=16, image_size=32,
                       dtype=torch.float32, device="cpu")
    x = torch.zeros(2, 32, 32, 3)
    with pytest.raises(NotImplementedError, match="InvalidRngError"):
        model(x)
    assert model.eval()(x).shape == (2, 10)   # eval: dropout is identity
    jmodel = jvgg.VGG11(num_classes=10, fc_dim=16, dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32)
    v = jax.eval_shape(lambda a: jmodel.init(jax.random.PRNGKey(0), a,
                                             train=False), x)
    with pytest.raises(flax.errors.InvalidRngError):
        jax.eval_shape(lambda p, a: jmodel.apply(
            p, a, train=True, mutable=["batch_stats"]), v, x)


def test_zoo_teacher_serves_vgg_from_a_jax_checkpoint(tmp_path):
    """The zoo-teacher builder serves VGG at the served image size (its
    fc0 bound to it, as flax binds it at init) from a JAX trainer's
    checkpoint: bf16 logits within 3e-2 x max(1, max |ref|) of the JAX
    builder's on the same checkpoint (the port's own checkpoints take
    the restore path test_torch_zoo_teacher.py holds for every model)."""
    from edl_tpu.distill.teacher_server import \
        _build_model_predict as jbuild
    from edl_tpu_torch.distill import teacher_server as tts
    from test_torch_zoo_teacher import _fetch, _save

    model = tvgg.VGG11(num_classes=10, dropout=0.0, image_size=32,
                       device="cpu", seed=7)
    with torch.no_grad():    # statistics other than the init's
        for _, _, norm in model.layers():
            norm.running_mean.uniform_(-0.1, 0.1)
            norm.running_var.uniform_(0.5, 2.0)
    _save("jax", model, tmp_path)
    feeds = np.random.default_rng(8).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    args = ("VGG11", 10, str(tmp_path), "image", "logits", (32, 32, 3),
            "float32", 0, "", "")
    jpredict, _ = jbuild(*args)
    predict, _ = tts._build_model_predict(*args, device="cpu")
    want = _fetch(jpredict({"image": feeds}))["logits"]
    got = _fetch(predict({"image": feeds}))["logits"]
    assert got.shape == want.shape == (3, 10) and got.dtype == np.float32
    bound = 3e-2 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound
