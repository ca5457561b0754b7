"""The port's streamed-vocab cross-entropy (edl_tpu_torch/ops/fused_xent.py)
and its LM loss ``lm_loss_fused`` against the JAX package's, on the same
numpy-seeded inputs.

Bounds are tests/test_fused_xent.py's: the loss within 2e-6 and the
gradients within 1e-6 of the JAX function (and of the dense oracle), for
chunks that divide the vocab, one chunk, and ragged vocabs (the port
slices the last chunk short where the JAX package clamps and masks it);
logits scaled 100x within rtol 1e-5 (the running max's rescale); bf16
inputs within 0.05 of the fp32 oracle; ``lm_loss_fused`` on bridged
weights within 5e-6 of the JAX package's, its gradients within 2e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu.models.transformer import lm_loss_fused as j_lm_loss_fused
from edl_tpu.train.state import TrainState as JTrainState
from edl_tpu_torch import bridge
from edl_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              lm_loss_fn, lm_loss_fused)

jfx = importlib.import_module("edl_tpu.ops.fused_xent")
tfx = importlib.import_module("edl_tpu_torch.ops.fused_xent")


def _data(n=64, d=32, v=512, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    k = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    return h, k, t


def _oracle(h, k, t):
    logp = jax.nn.log_softmax(jnp.asarray(h) @ jnp.asarray(k))
    return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(t)[:, None],
                                         axis=-1))


def _port(h, k, t, chunk, dtype=torch.float32):
    """The port's loss and (d hidden, d kernel) on torch copies."""
    th = torch.from_numpy(h).to(dtype).requires_grad_()
    tk = torch.from_numpy(k).to(dtype).requires_grad_()
    loss = tfx.streamed_lm_xent(th, tk, torch.from_numpy(t), chunk)
    loss.backward()
    return loss.item(), th.grad.float().numpy(), tk.grad.float().numpy()


def _jax(h, k, t, chunk):
    tj = jnp.asarray(t)
    loss, grads = jax.value_and_grad(
        lambda a, b: jfx.streamed_lm_xent(a, b, tj, chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(k))
    return float(loss), np.asarray(grads[0]), np.asarray(grads[1])


@pytest.mark.parametrize("chunk", [128, 256, 512, 8192])
def test_loss_and_grads_match_jax(chunk):
    h, k, t = _data()
    got, want = _port(h, k, t, chunk), _jax(h, k, t, chunk)
    np.testing.assert_allclose(got[0], want[0], atol=2e-6)
    np.testing.assert_allclose(got[0], float(_oracle(h, k, t)), atol=2e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)


@pytest.mark.parametrize("v,chunk", [(50257 % 997 + 500, 128), (1000, 300),
                                     (513, 128)])
def test_ragged_vocab_matches_jax(v, chunk):
    """Vocabs with no chunk divisor: the port's short last chunk against
    the JAX package's clamped, masked one."""
    h, k, t = _data(v=v)
    got, want = _port(h, k, t, chunk), _jax(h, k, t, chunk)
    np.testing.assert_allclose(got[0], want[0], atol=2e-6)
    np.testing.assert_allclose(got[0], float(_oracle(h, k, t)), atol=2e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_extreme_logits_stable():
    """The running max's rescale survives large logits."""
    h, k, t = _data()
    k = k * 100.0
    got = _port(h, k, t, 128)[0]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(_oracle(h, k, t)), rtol=1e-5)
    np.testing.assert_allclose(got, _jax(h, k, t, 128)[0], rtol=1e-5)


def test_bf16_inputs():
    h, k, t = _data()
    loss, dh, dk = _port(h, k, t, 128, dtype=torch.bfloat16)
    np.testing.assert_allclose(loss, float(_oracle(h, k, t)), atol=0.05)
    want = jfx.streamed_lm_xent(jnp.asarray(h, jnp.bfloat16),
                                jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(t), 128)
    np.testing.assert_allclose(loss, float(want), atol=0.05)


@pytest.mark.parametrize("v,want", [(512, 8192), (32768, 8192),
                                    (1000, 8192), (50257, 8192)])
def test_chunk_fit_agrees(v, want):
    assert tfx._chunks(v, want) == jfx._chunks(v, want)


def test_saves_nothing_of_n_by_v():
    """The forward keeps hidden, kernel, targets and the lse alive for the
    backward, and no tensor of N x V elements."""
    h, k, t = _data(n=64, d=32, v=512)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x.numel()) or x, lambda x: x):
        th = torch.from_numpy(h).requires_grad_()
        tk = torch.from_numpy(k).requires_grad_()
        loss = tfx.streamed_lm_xent(th, tk, torch.from_numpy(t), 128)
    assert sorted(saved) == sorted([64 * 32, 32 * 512, 64, 64])
    assert max(saved) < 64 * 512
    loss.backward()
    assert th.grad.shape == th.shape and tk.grad.shape == tk.shape


def test_targets_of_any_int_dtype():
    h, k, t = _data()
    a = _port(h, k, t, 128)
    b = _port(h, k, t.astype(np.int64), 128)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[2], b[2])


LM = dict(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_len=64)


@pytest.fixture(scope="module")
def lm_case():
    """The JAX package's TestFusedLmLoss model (fp32, dense attention),
    its params and a numpy-seeded batch."""
    cfg = JConfig(**LM, dtype=jnp.float32, attention="dense")
    toks = np.random.default_rng(1).integers(0, 512, (4, 64)).astype(
        np.int32)
    variables = jax.jit(JTransformer(cfg).init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(toks), train=False)
    params = jax.tree.map(np.asarray, nn.unbox(variables["params"]))
    return cfg, params, toks


def _port_lm(params):
    model = Transformer(TransformerConfig(**LM, dtype=torch.float32,
                                          attention="dense"), device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    return model.train()


@pytest.mark.parametrize("chunk", [128, 8192])
def test_lm_loss_fused_matches_jax(lm_case, chunk):
    cfg, params, toks = lm_case
    state = JTrainState.create(apply_fn=JTransformer(cfg).apply,
                               params=params, tx=optax.sgd(0.1))
    batch = {"tokens": jnp.asarray(toks)}
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: j_lm_loss_fused(state, p, batch, chunk=chunk),
        has_aux=True)(params)
    model = _port_lm(params)
    loss, aux = lm_loss_fused(model, {"tokens": torch.from_numpy(toks)},
                              chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=5e-6)
    np.testing.assert_allclose(aux["ppl"].item(), float(jaux["ppl"]),
                               rtol=1e-5)
    got = bridge.grads_to_flax(model, LM["n_heads"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-6)


def test_lm_loss_fused_matches_the_dense_loss(lm_case):
    """Within the port: the streamed loss and every gradient against
    lm_loss_fn's on the same weights; the lm_head gradient keeps the
    weight's (V, d) layout."""
    _, params, toks = lm_case
    batch = {"tokens": torch.from_numpy(toks)}
    out = {}
    for name, fn in (("fused", lm_loss_fused), ("dense", lm_loss_fn)):
        model = _port_lm(params)
        loss, _ = fn(model, batch)
        loss.backward()
        out[name] = (loss.item(), {n: p.grad.clone()
                                   for n, p in model.named_parameters()})
        if name == "fused":
            assert model.lm_head.weight.grad.is_contiguous()
    np.testing.assert_allclose(out["fused"][0], out["dense"][0], atol=5e-6)
    for n, g in out["dense"][1].items():
        np.testing.assert_allclose(out["fused"][1][n].numpy(), g.numpy(),
                                   atol=2e-6, err_msg=n)


def test_return_hidden_skips_the_head(lm_case):
    cfg, params, toks = lm_case
    want = JTransformer(cfg).apply({"params": params}, jnp.asarray(toks),
                                   train=False, return_hidden=True)
    model = _port_lm(params)
    with torch.no_grad():
        got = model(torch.from_numpy(toks), return_hidden=True)
        logits = model(torch.from_numpy(toks))
        head = model.lm_head(got.float())
    assert got.shape == (4, 64, LM["d_model"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    torch.testing.assert_close(head, logits, rtol=0, atol=0)
