"""The port's transformer (edl_tpu_torch/models/transformer.py) against
edl_tpu.models.transformer.Transformer on the same bridged params.

Both sides compute eval logits for the same numpy-seeded tokens, under
attention "dense" and "flash" (on the CPU the port's flash is its plain
blockwise version; JAX's is its XLA blockwise fallback).

Tolerances: fp32 logits agree to 2e-5 (sums in another order; the
measured gap at these sizes is ~3e-6). bf16
rounds the residual stream and every projection's output to 8 bits of
mantissa at places that differ between the frameworks (bf16 gelu in
XLA, fp32-internal gelu in torch), so a logit of size ~3 may move by a
few bf16 ulps: the bound is 6e-2 absolute, and the top-1 class must
agree on at least 95% of positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu_torch.bridge import flax_to_torch
from edl_tpu_torch.models import get_model
from edl_tpu_torch.models.transformer import Transformer, TransformerConfig

SMALL = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_len=256)
ATOL = {"float32": 2e-5, "bfloat16": 6e-2}


def _tokens(rows, seq, seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (rows, seq)).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    """One flax init serves every case: params are fp32 whatever the
    compute dtype or attention kernel."""
    init = jax.jit(JTransformer(JConfig(**SMALL)).init,
                   static_argnames="train")
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 128), jnp.int32),
                     train=False)
    return jax.tree.map(np.asarray, nn.unbox(variables["params"]))


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(params, dtype, attention, seq):
    jmodel = JTransformer(JConfig(**SMALL, dtype=getattr(jnp, dtype),
                                  attention=attention))
    tmodel = Transformer(TransformerConfig(**SMALL,
                                           dtype=getattr(torch, dtype),
                                           attention=attention),
                         device="cpu")
    tmodel.load_state_dict(flax_to_torch(params))
    toks = _tokens(2, seq)
    want = np.asarray(jax.jit(jmodel.apply, static_argnames="train")(
        {"params": params}, toks, train=False))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL[dtype])
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    assert agree >= (1.0 if dtype == "float32" else 0.95), agree


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_fp16_logits_match_jax(params, attention, seq):
    """fp16 activations (lm_train --fp16) at the bf16 bounds: fp16 rounds
    at the same places, to a finer mantissa."""
    jmodel = JTransformer(JConfig(**SMALL, dtype=jnp.float16,
                                  attention=attention))
    tmodel = Transformer(TransformerConfig(**SMALL, dtype=torch.float16,
                                           attention=attention),
                         device="cpu")
    tmodel.load_state_dict(flax_to_torch(params))
    toks = _tokens(2, seq, seed=4)
    want = np.asarray(jax.jit(jmodel.apply, static_argnames="train")(
        {"params": params}, toks, train=False))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(toks)).numpy()
        hidden = tmodel(torch.from_numpy(toks), return_hidden=True)
    assert got.dtype == np.float32 and hidden.dtype == torch.float16
    np.testing.assert_allclose(got, want, atol=ATOL["bfloat16"])
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.95


def test_auto_attention_rule():
    cfg = TransformerConfig(**SMALL)
    assert not cfg.use_flash(128, "cpu")         # CPU: dense, as JAX on CPU
    assert cfg.use_flash(128, "cuda")            # the kernel on a card
    assert not cfg.use_flash(200, "cuda")        # not 128-divisible
    assert TransformerConfig(**SMALL, attention="flash").use_flash(200, "cpu")
    assert not TransformerConfig(**SMALL, attention="dense").use_flash(
        128, "cuda")


@pytest.mark.parametrize("kw,exc", [
    ({"mesh": object()}, TypeError),          # the port's seam is cfg.sp
    ({"moe": True, "n_experts": 1}, ValueError),
    ({"moe": True, "n_experts": 4, "moe_top_k": 5}, ValueError)])
def test_unported_options_raise(kw, exc):
    """The JAX model's mesh field (its sharding-constraint seam) is not a
    field of the port's config; an MoE config is validated as the JAX
    package's is."""
    with pytest.raises(exc):
        TransformerConfig(**SMALL, **kw)


def test_moe_config_builds_the_expert_blocks():
    model = Transformer(TransformerConfig(**SMALL, moe=True, n_experts=4),
                        device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert "block0.moe_mlp.w_in" in names and "block0.mlp_in.weight" \
        not in names
    assert tuple(model.block0.moe_mlp.w_in.shape) == (
        4, SMALL["d_model"], SMALL["d_ff"])
    assert tuple(model.block0.moe_mlp.router.shape) == (SMALL["d_model"], 4)


def test_get_model_and_seeded_init():
    assert get_model("Transformer") is Transformer
    cfg = TransformerConfig(**SMALL)
    a = Transformer(cfg, device="cpu", seed=5).state_dict()
    b = Transformer(cfg, device="cpu", seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    from edl_tpu_torch.models.vgg import VGG16
    assert get_model("VGG16") is VGG16
    with pytest.raises(AttributeError):
        get_model("VGG17")
