"""Weights bridge (edl_tpu_torch/bridge.py): flax transformer params <->
the port's state_dict, bitwise both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu_torch.bridge import flax_to_torch, torch_to_flax
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
