"""The port's ResNet (edl_tpu_torch/models/resnet.py) against the flax
model on bridged weights, on the CPU.

ResNetTiny (1 block a stage, 8 base filters), vd and not, at 32 px and at
36 px (odd sizes down the network: the (1, 1) pads of strided convs and
the padded avg_pool of the vd shortcut), batches of 4. BatchNorm scales,
biases and running statistics are drawn away from their init values, so
every normalization does work. Tolerances:

- eval logits (running statistics): 1e-5 (fp32 sums in another order;
  measured under 3e-7);
- train-mode logits and the updated batch_stats: 1e-4 (torch takes the
  batch variance in two passes, flax as E[x^2] - E[x]^2; over 4 rows of
  1x1 in the last stage the normalization magnifies that; measured under
  1.1e-5);
- one classification step's loss 1e-5 and gradients 5e-4 of each leaf's
  largest magnitude (the same statistics, differentiated; measured under
  9e-5 relative);
- bf16: the two frameworks round activations at different places, so
  the yardstick is flax's own bf16 error, its bf16 logits' largest gap
  to its fp32 logits: the port's bf16 logits lie within twice that of
  the fp32 logits and of flax's bf16 logits (measured: 1.6x and 1.4x in
  eval mode, 1.2x and 0.9x in train mode);
- bf16 gradients: rounding the activations of a 4-row batch norm moves
  flax's own bf16 gradients far from its fp32 ones (0.43 and 0.73 in
  relative L2 over all leaves, not vd and vd), so the yardstick is that
  gap again: the port's bf16 gradients lie within 1.25x of it from the
  fp32 gradients and 1.5x of it from flax's bf16 gradients (measured
  1.06x/0.89x and 1.15x/0.86x), and its bf16 loss within 2x of flax's
  bf16 loss gap (measured 1.33x/1.27x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models.resnet import ResNetTiny as JTiny
from edl_tpu.train import classification as jcls
from edl_tpu_torch import bridge
from edl_tpu_torch import models as zoo
from edl_tpu_torch.models import resnet
from edl_tpu_torch.models.resnet import ResNetTiny
from edl_tpu_torch.train import classification as tcls

CLASSES = 10


def _variables(vd: bool, seed: int = 0) -> dict:
    """ResNetTiny's flax variables, drawn with numpy (no init to compile):
    He-normal kernels, BN scales and biases, the Dense bias and the
    running statistics away from their init values, so every
    normalization does work. The shapes do not depend on the image
    size."""
    model = JTiny(num_classes=CLASSES, vd=vd, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        elif name == "scale":
            x = 1.0 + rng.normal(0, 0.1, shape)
        elif name == "var":
            x = rng.uniform(0.8, 1.2, shape)
        else:                                   # bias, mean
            x = rng.normal(0, 0.05, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(size: int, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(4, size, size, 3)).astype(np.float32)


LABELS = np.array([1, 2, 3, 9], np.int32)
_refs: dict = {}


def _reference(vd: bool, size: int, dtype=jnp.float32,
               grads: bool = False) -> dict:
    """flax's eval logits, train-mode logits and updated batch_stats (and
    with ``grads`` the classification loss and its gradients), from one
    jitted function per configuration, cached for the module."""
    key = (vd, size, jnp.dtype(dtype).name, grads)
    if key in _refs:
        return _refs[key]
    model = JTiny(num_classes=CLASSES, vd=vd, dtype=dtype)
    x = _images(size)

    def ref(v):
        out = {"eval": model.apply(v, x, train=False)}
        out["train"], mutated = model.apply(v, x, train=True,
                                            mutable=["batch_stats"])
        out["batch_stats"] = mutated["batch_stats"]
        if grads:
            def loss(params):
                logits, _ = model.apply(
                    {"params": params, "batch_stats": v["batch_stats"]}, x,
                    train=True, mutable=["batch_stats"])
                return jcls.soft_cross_entropy(
                    logits, jcls.smoothed_labels(LABELS, CLASSES, 0.1))
            out["loss"], out["grads"] = jax.value_and_grad(loss)(v["params"])
        return out

    _refs[key] = jax.tree.map(np.asarray, jax.jit(ref)(_variables(vd)))
    return _refs[key]


def _port(vd, dtype=torch.float32):
    model = ResNetTiny(num_classes=CLASSES, vd=vd, dtype=dtype, device="cpu")
    result = model.load_state_dict(
        bridge.flax_variables_to_torch(_variables(vd)))
    assert not result.missing_keys and not result.unexpected_keys
    return model


SHAPES = [(vd, size) for vd in (False, True) for size in (32, 36)]


@pytest.mark.parametrize("vd,size", SHAPES)
def test_eval_logits_match_flax(vd, size):
    want = _reference(vd, size, grads=size == 32)["eval"]
    model = _port(vd).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(_images(size)))
    assert got.dtype == torch.float32 and got.shape == (4, CLASSES)
    # the logits depend on the image (the features are alive)
    assert np.ptp(want, axis=0).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("vd,size", SHAPES)
def test_train_logits_and_batch_stats_match_flax(vd, size):
    ref = _reference(vd, size, grads=size == 32)
    model = _port(vd).train()
    with torch.no_grad():
        got = model(torch.from_numpy(_images(size)))
    np.testing.assert_allclose(got.numpy(), ref["train"], atol=1e-4)
    stats = bridge.torch_to_flax_variables(model.state_dict())["batch_stats"]
    paths = jax.tree_util.tree_flatten_with_path(ref["batch_stats"])[0]
    ours = dict(jax.tree_util.tree_flatten_with_path(stats)[0])
    assert len(ours) == len(paths)
    for path, leaf in paths:
        np.testing.assert_allclose(ours[path], leaf, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("vd", [False, True])
def test_classification_loss_and_grads_match_flax(vd):
    ref = _reference(vd, 32, grads=True)
    model = _port(vd).train()
    loss = tcls.soft_cross_entropy(
        model(torch.from_numpy(_images(32))),
        tcls.smoothed_labels(torch.from_numpy(LABELS), CLASSES, 0.1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref["loss"]), atol=1e-5)
    grads = bridge.torch_to_flax_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"]
    for path, g in jax.tree_util.tree_flatten_with_path(ref["grads"])[0]:
        ours = grads
        for k in path:
            ours = ours[k.key]
        np.testing.assert_allclose(
            ours, g, atol=5e-4 * max(np.abs(g).max(), 1e-6),
            err_msg=jax.tree_util.keystr(path))


def _port_loss_and_grads(vd: bool, dtype) -> tuple[float, np.ndarray]:
    """One train-mode classification loss and its gradients, all leaves
    in the flax flatten order as one vector."""
    model = _port(vd, dtype=dtype).train()
    loss = tcls.soft_cross_entropy(
        model(torch.from_numpy(_images(32))),
        tcls.smoothed_labels(torch.from_numpy(LABELS), CLASSES, 0.1))
    loss.backward()
    grads = bridge.torch_to_flax_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"]
    return loss.item(), _flat(grads)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("vd", [False, True])
def test_bf16_grads_match_flax_bf16(vd):
    ref_fp32 = _reference(vd, 32, grads=True)
    ref_bf16 = _reference(vd, 32, jnp.bfloat16, grads=True)
    loss, got = _port_loss_and_grads(vd, torch.bfloat16)
    want_fp32, want_bf16 = _flat(ref_fp32["grads"]), _flat(ref_bf16["grads"])
    assert got.shape == want_fp32.shape and np.isfinite(got).all()
    flax_gap = _rel(want_bf16, want_fp32)
    assert 0 < flax_gap
    assert _rel(got, want_fp32) <= 1.25 * flax_gap
    assert _rel(got, want_bf16) <= 1.5 * flax_gap
    loss_gap = abs(float(ref_bf16["loss"]) - float(ref_fp32["loss"]))
    assert abs(loss - float(ref_fp32["loss"])) <= 2 * loss_gap


@pytest.mark.parametrize("train", [False, True])
def test_bf16_forward_matches_flax_bf16(train):
    key = "train" if train else "eval"
    want_bf16 = _reference(True, 32, jnp.bfloat16)[key]
    want_fp32 = _reference(True, 32, grads=True)[key]
    model = _port(True, dtype=torch.bfloat16).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(_images(32)))
    assert got.dtype == torch.float32     # the classifier runs in fp32
    got = got.numpy()
    flax_gap = np.abs(want_bf16 - want_fp32).max()
    assert 0 < flax_gap
    assert np.abs(got - want_fp32).max() <= 2 * flax_gap
    assert np.abs(got - want_bf16).max() <= 2 * flax_gap


def test_same_padding_is_flax_s():
    assert resnet.same_pads(32, 3, 2) == (0, 1)      # strided 3x3, even
    assert resnet.same_pads(33, 3, 2) == (1, 1)      # odd
    assert resnet.same_pads(224, 7, 2) == (2, 3)     # the 7x7 stem
    assert resnet.same_pads(32, 3, 1) == (1, 1)
    assert resnet.same_pads(9, 2, 2) == (0, 1)       # vd avg_pool, odd
    assert resnet.same_pads(8, 2, 2) == (0, 0)
    assert resnet.same_pads(32, 1, 2) == (0, 0)      # strided 1x1


def test_init_follows_flax_initializers():
    model = resnet.ResNet(stage_sizes=(1, 1), num_filters=16, vd=True,
                          num_classes=CLASSES, dtype=torch.float32,
                          device="cpu", seed=3)
    w = model.BottleneckBlock_0.Conv_1.weight        # (16, 16, 3, 3)
    std = np.sqrt(2.0 / (16 * 9)) / 0.87962566103423978
    assert w.abs().max() <= 2 * std
    assert abs(w.std().item() - np.sqrt(2.0 / (16 * 9))) < 0.1 * std
    for block in model.blocks():
        assert not block.BatchNorm_2.weight.any()     # zero-init scale
        assert torch.all(block.BatchNorm_0.weight == 1)
    limit = np.sqrt(3.0 / model.Dense_0.in_features)
    assert model.Dense_0.weight.abs().max() <= limit
    assert not model.Dense_0.bias.any()
    again = resnet.ResNet(stage_sizes=(1, 1), num_filters=16, vd=True,
                          num_classes=CLASSES, dtype=torch.float32,
                          device="cpu", seed=3)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)                      # seeded


def test_layout_is_channels_last_and_zoo_names_resolve():
    model = ResNetTiny(num_classes=CLASSES, device="cpu",
                       dtype=torch.float32)
    x = torch.zeros(2, 32, 32, 3).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert model(torch.zeros(2, 32, 32, 3)).shape == (2, CLASSES)
    for name in ("ResNet50", "ResNet101", "ResNet152", "ResNet50_vd",
                 "ResNet101_vd", "ResNet152_vd", "ResNetTiny"):
        assert zoo.get_model(name) is getattr(resnet, name)
    from edl_tpu_torch.models import vgg
    assert zoo.get_model("VGG16") is vgg.VGG16
    with pytest.raises(AttributeError):
        zoo.get_model("VGG17")
