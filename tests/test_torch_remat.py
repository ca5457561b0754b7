"""Per-block activation checkpointing (``TransformerConfig(remat=True)``)
and the remat knob (``choose_remat``/``auto_remat``) of the port's
transformer against the JAX package's.

Remat recomputes each block's forward in the backward: the logits and
every gradient are held bit for bit against the same model without it
(the recompute is the same computation), and the logits within the fp32
parity bound (2e-5, tests/test_torch_transformer.py) of the JAX
package's remat model on bridged weights. The knob is arithmetic: the
port's choice equals the JAX package's on a grid of configs with the
memory given. The one divergence is recorded: the JAX estimate adds the
dense (heads, S, S) scores wherever its backend is not a TPU, because
its auto attention is flash only there; the port's auto attention is
flash on CUDA, so it adds them only off the card. On the CPU both agree.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from edl_tpu.models import transformer as jtr
from edl_tpu_torch import bridge
from edl_tpu_torch.models import transformer as ttr

SMALL = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_len=128)


@pytest.fixture(scope="module")
def params():
    init = jax.jit(jtr.Transformer(jtr.TransformerConfig(**SMALL)).init,
                   static_argnames="train")
    variables = init(jax.random.PRNGKey(3), jnp.zeros((1, 128), jnp.int32),
                     train=False)
    return jax.tree.map(np.asarray, nn.unbox(variables["params"]))


def _tokens(rows=2, seq=128, seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (rows, seq)).astype(np.int32)


def _model(params, remat, attention="flash", dtype=torch.float32):
    model = ttr.Transformer(ttr.TransformerConfig(
        **SMALL, dtype=dtype, attention=attention, remat=remat),
        device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    return model.train()


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("loss", ["dense", "fused"])
def test_remat_logits_and_grads_equal_no_remat(params, attention, loss):
    fn = ttr.lm_loss_fn if loss == "dense" else ttr.lm_loss_fused
    batch = {"tokens": torch.from_numpy(_tokens())}
    out = []
    for remat in (False, True):
        model = _model(params, remat, attention)
        with torch.no_grad():
            logits = model(batch["tokens"])
        value, _ = fn(model, batch)
        value.backward()
        out.append((logits, value.detach(),
                    {n: p.grad for n, p in model.named_parameters()}))
    (l0, v0, g0), (l1, v1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(v0, v1)
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_remat_recomputes_under_grad_only(params, monkeypatch):
    """The backward re-runs each block's forward: a block's forward is
    entered twice a step under remat, once without; inference (no grad)
    runs it once."""
    calls = []
    forward = ttr.Block.forward
    monkeypatch.setattr(ttr.Block, "forward",
                        lambda self, x: calls.append(1) or forward(self, x))
    batch = {"tokens": torch.from_numpy(_tokens())}
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        value, _ = ttr.lm_loss_fn(_model(params, remat), batch)
        value.backward()
        assert len(calls) == want, (remat, len(calls))
    calls.clear()
    with torch.no_grad():
        _model(params, True)(batch["tokens"])
    assert len(calls) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_logits_match_jax(params, dtype):
    toks = _tokens()
    jcfg = jtr.TransformerConfig(**SMALL, dtype=getattr(jnp, dtype),
                                 attention="flash", remat=True)
    want = np.asarray(jtr.Transformer(jcfg).apply({"params": params}, toks,
                                                  train=True))
    model = _model(params, True, dtype=getattr(torch, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want,
                               atol=2e-5 if dtype == "float32" else 6e-2)


def test_remat_grads_match_jax(params):
    """The loss's gradients through remat blocks on both sides (fp32,
    1e-5 as tests/test_torch_train_slice.py)."""
    toks = _tokens()
    jcfg = jtr.TransformerConfig(**SMALL, dtype=jnp.float32,
                                 attention="flash", remat=True)
    apply = jtr.Transformer(jcfg).apply

    def jloss(p):
        logits = apply({"params": p}, toks, train=True)[:, :-1]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(toks)[:, 1:, None], axis=-1))

    want_loss, want = jax.value_and_grad(jloss)(params)
    model = _model(params, True)
    value, _ = ttr.lm_loss_fn(model, {"tokens": torch.from_numpy(toks)})
    value.backward()
    np.testing.assert_allclose(value.item(), float(want_loss), atol=1e-5)
    got = bridge.grads_to_flax(model, SMALL["n_heads"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


_GRID = list(itertools.product(
    [dict(vocab_size=1000, d_model=1024, n_heads=8, n_layers=24, d_ff=4096,
          max_len=2048),
     dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=64),
     dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=8,
          d_ff=4096, max_len=1024)],
    ["float32", "bfloat16", "float16"],
    ["auto", "dense", "flash"],
    [4, 16, 64],
    [1 << 30, 16 * (1 << 30), 80 * 10 ** 9]))


@pytest.mark.parametrize("shape,dtype,attention,batch,hbm", _GRID[::3] +
                         _GRID[1::7])
def test_choose_remat_matches_jax_on_the_cpu(shape, dtype, attention, batch,
                                             hbm):
    jcfg = jtr.TransformerConfig(**shape, dtype=getattr(jnp, dtype),
                                 attention=attention)
    tcfg = ttr.TransformerConfig(**shape, dtype=getattr(torch, dtype),
                                 attention=attention)
    want = jtr.choose_remat(jcfg, batch, hbm_bytes=hbm)
    assert ttr.choose_remat(tcfg, batch, hbm_bytes=hbm, device="cpu") == want
    assert ttr.auto_remat(tcfg, batch, hbm_bytes=hbm,
                          device="cpu").remat == want
    assert jtr.auto_remat(jcfg, batch, hbm_bytes=hbm).remat == want
    for seq in (256, 1000):
        assert ttr.choose_remat(tcfg, batch, seq, hbm, device="cpu") == \
            jtr.choose_remat(jcfg, batch, seq, hbm)


def test_choose_remat_by_footprint():
    """tests/test_fused_opt.py's TestRematKnob on the port."""
    big = ttr.TransformerConfig(vocab_size=1000, d_model=1024, n_heads=8,
                                n_layers=24, d_ff=4096, max_len=2048,
                                dtype=torch.float32)
    tiny = ttr.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                 n_layers=2, d_ff=64, max_len=64,
                                 dtype=torch.float32)
    hbm = 16 * 2**30
    assert ttr.choose_remat(big, batch_size=64, hbm_bytes=hbm, device="cpu")
    assert not ttr.choose_remat(tiny, batch_size=4, hbm_bytes=hbm,
                                device="cpu")
    assert ttr.auto_remat(big, 64, hbm_bytes=hbm, device="cpu").remat
    assert not ttr.auto_remat(tiny, 4, hbm_bytes=hbm, device="cpu").remat


def test_default_memory_on_the_cpu_is_the_jax_package_s():
    """Without hbm_bytes: 16 GiB for the CPU, what the JAX package takes
    where its backend reports no memory."""
    for layers in (8, 24, 48, 96):
        shape = dict(vocab_size=32768, d_model=1024, n_heads=16,
                     n_layers=layers, d_ff=4096, max_len=1024)
        jcfg = jtr.TransformerConfig(**shape, dtype=jnp.bfloat16)
        tcfg = ttr.TransformerConfig(**shape, dtype=torch.bfloat16)
        for batch in (1, 4, 16):
            assert ttr.choose_remat(tcfg, batch, device="cpu") == \
                jtr.choose_remat(jcfg, batch, hbm_bytes=16 * (1 << 30))


def test_on_the_card_auto_attention_counts_no_scores():
    """The divergence: on CUDA the port's auto attention is flash (no
    dense scores in the estimate), which the JAX package's estimate
    matches for attention="flash"; off the card both count them."""
    shape = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=8,
                 d_ff=4096, max_len=1024)
    tcfg = ttr.TransformerConfig(**shape, dtype=torch.bfloat16)
    jflash = jtr.TransformerConfig(**shape, dtype=jnp.bfloat16,
                                   attention="flash")
    jauto = jtr.TransformerConfig(**shape, dtype=jnp.bfloat16)
    flips = 0
    for batch, hbm in itertools.product((4, 16, 64), (1 << 30, 1 << 33,
                                                      1 << 34, 1 << 36)):
        card = ttr.choose_remat(tcfg, batch, hbm_bytes=hbm, device="cuda")
        cpu = ttr.choose_remat(tcfg, batch, hbm_bytes=hbm, device="cpu")
        assert card == jtr.choose_remat(jflash, batch, hbm_bytes=hbm)
        assert cpu == jtr.choose_remat(jauto, batch, hbm_bytes=hbm)
        flips += card != cpu
    assert flips > 0
    # the base config at 16 rows on an 80 GB card: no remat
    assert not ttr.choose_remat(tcfg, 16, hbm_bytes=80 * 10 ** 9,
                                device="cuda")


def test_remat_config_is_accepted_and_dropout_still_raises():
    cfg = ttr.TransformerConfig(**SMALL, remat=True)
    assert cfg.remat
    assert dataclasses.replace(cfg, remat=False).remat is False
    model = ttr.Transformer(dataclasses.replace(cfg, dropout=0.1),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="dropout"):
        model.train()(torch.zeros((1, 128), dtype=torch.int32))
