"""Weights bridge (edl_tpu_torch/bridge.py): flax transformer params and
ResNet {params, batch_stats} <-> the port's state_dicts, bitwise both
ways, and the flax flatten order the fused optimizer's buckets follow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from edl_tpu.models.resnet import ResNet as JResNet
from edl_tpu.models.resnet import ResNetTiny as JResNetTiny
from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu_torch.bridge import (flax_named_parameters, flax_path,
                                  flax_to_torch, flax_variables_to_torch,
                                  torch_to_flax, torch_to_flax_variables)
from edl_tpu_torch.models.resnet import ResNet, ResNetTiny
from edl_tpu_torch.models.transformer import Transformer, TransformerConfig

SMALL = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_len=128)


def _flax_params(seed=0):
    model = JTransformer(JConfig(**SMALL, dtype=jnp.float32))
    toks = jnp.zeros((1, SMALL["max_len"]), jnp.int32)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), toks, train=False)
    return jax.tree.map(np.asarray, nn.unbox(variables["params"]))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_flax_round_trip_is_bitwise():
    params = _flax_params()
    back = _flat(torch_to_flax(flax_to_torch(params), SMALL["n_heads"]))
    want = _flat(params)
    assert sorted(back) == sorted(want)
    for key, arr in want.items():
        assert back[key].dtype == arr.dtype, key
        assert back[key].shape == arr.shape, key
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_state_dict_round_trip_is_bitwise():
    model = Transformer(TransformerConfig(**SMALL), device="cpu", seed=3)
    sd = model.state_dict()
    back = flax_to_torch(torch_to_flax(sd, SMALL["n_heads"]))
    assert sorted(back) == sorted(sd)
    for key, t in sd.items():
        assert torch.equal(back[key], t), key


def test_bridged_params_load_into_the_port():
    model = Transformer(TransformerConfig(**SMALL), device="cpu")
    result = model.load_state_dict(flax_to_torch(_flax_params(1)))
    assert not result.missing_keys and not result.unexpected_keys


# -- the ResNet: flax {params, batch_stats} <-> state_dict with buffers ------


def _resnet_variables(vd: bool, seed: int = 0) -> dict:
    """ResNetTiny's variable tree with every leaf drawn at random (so a
    mix-up of any two leaves shows), without compiling an init."""
    model = JResNetTiny(num_classes=10, vd=vd, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("vd", [False, True])
def test_resnet_flax_round_trip_is_bitwise(vd):
    variables = _resnet_variables(vd)
    sd = flax_variables_to_torch(variables)
    model = ResNetTiny(num_classes=10, vd=vd, dtype=torch.float32,
                       device="cpu")
    result = model.load_state_dict(sd)
    assert not result.missing_keys and not result.unexpected_keys
    back = torch_to_flax_variables(model.state_dict())
    assert sorted(back) == ["batch_stats", "params"]
    for coll in ("params", "batch_stats"):
        want, got = _flat(variables[coll]), _flat(back[coll])
        assert sorted(got) == sorted(want)
        for key, arr in want.items():
            assert got[key].dtype == arr.dtype, key
            np.testing.assert_array_equal(got[key], arr, err_msg=key)


@pytest.mark.parametrize("vd", [False, True])
def test_resnet_state_dict_round_trip_is_bitwise(vd):
    model = ResNetTiny(num_classes=10, vd=vd, dtype=torch.float32,
                       device="cpu", seed=4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.add_(torch.rand(buf.shape))
    sd = model.state_dict()
    back = flax_variables_to_torch(torch_to_flax_variables(sd))
    assert sorted(back) == sorted(sd)
    for key, t in sd.items():
        assert torch.equal(back[key], t), key


def test_resnet_layouts():
    """Conv HWIO <-> OIHW, Dense (in, out) <-> (out, in), BN scale <->
    weight and mean/var <-> running_mean/running_var."""
    variables = _resnet_variables(True)
    sd = flax_variables_to_torch(variables)
    kern = variables["params"]["BottleneckBlock_1"]["Conv_1"]["kernel"]
    w = sd["BottleneckBlock_1.Conv_1.weight"]
    assert w.shape == (kern.shape[3], kern.shape[2], *kern.shape[:2])
    assert float(w[5, 3, 0, 2]) == float(kern[0, 2, 3, 5])
    dense = variables["params"]["Dense_0"]["kernel"]
    assert tuple(sd["Dense_0.weight"].shape) == dense.shape[::-1]
    bn = variables["params"]["stem_norm1"]
    assert np.array_equal(sd["stem_norm1.weight"].numpy(), bn["scale"])
    stats = variables["batch_stats"]["BottleneckBlock_0"]["norm_shortcut"]
    assert np.array_equal(
        sd["BottleneckBlock_0.norm_shortcut.running_var"].numpy(),
        stats["var"])
    assert flax_path("BottleneckBlock_0.BatchNorm_2.running_mean") == (
        "BottleneckBlock_0", "BatchNorm_2", "mean")


def test_resnet_flatten_order_matches_jax():
    """ResNet50's block count (16) at 8 filters: sorted keys put
    BottleneckBlock_10 before BottleneckBlock_2, and the fused optimizer's
    buckets follow this order."""
    jmodel = JResNet(stage_sizes=(3, 4, 6, 3), num_filters=8, vd=True,
                     num_classes=10, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    want = [(tuple(k.key for k in path), leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]]
    model = ResNet(stage_sizes=(3, 4, 6, 3), num_filters=8, vd=True,
                   num_classes=10, dtype=torch.float32, device="cpu")
    named = flax_named_parameters(model)
    got = [flax_path(n) for n, _ in named]
    assert got == [path for path, _ in want]
    assert got.index(("BottleneckBlock_10", "BatchNorm_0", "bias")) < \
        got.index(("BottleneckBlock_2", "BatchNorm_0", "bias"))
    for (_, p), (_, shape) in zip(named, want):
        assert p.numel() == int(np.prod(shape))
