"""The port's DeepFM (edl_tpu_torch.models.deepfm) against the JAX
package's on the same numpy inputs and bridged parameters, on the CPU,
at ctr_train's config (vocab 10,000, embed_dim 10, hidden 400 x 3,
batch 64 here).

- The forward logits, the loss and every parameter's gradient within
  1e-5 (fp32 sums in another order; the tables' gradients are DENSE
  (vocab x D), as flax's are, zero on rows no id touched).
- bce_with_logits and auc equal the JAX package's (auc exactly, ties and
  a one-class input included).
- Five Adam steps (the port's train/state.adam, torch.optim.Adam, against
  optax.adam, lr 1e-3) over the same batches: losses within 1e-5 and,
  after the last step, each leaf's gap within 1e-2 of how far the leaf
  moved (relative L2; measured at most 1.7e-3, deep_0's kernel). Adam
  divides by sqrt(v), so a gradient near 0, or one a deep-tower ReLU
  input within rounding of 0 switches, moves its element by up to lr
  whatever its rounding: an elementwise bound would compare roundings.
  optax updates every row of
  both tables every step (moments of untouched rows decay), so a sparse
  embedding or SparseAdam would miss the parameters of rows seen in an
  earlier step only.
- The parameter count at the default vocab of 1,000,000: 11,430,815.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import deepfm as jdf
from edl_tpu_torch import bridge
from edl_tpu_torch.models import deepfm as tdf
from edl_tpu_torch.models import get_model
from edl_tpu_torch.train.state import TrainState, adam

VOCAB, D, HIDDEN, B = 10000, 10, (400, 400, 400), 64
LR = 1e-3
MOVE_REL = 1e-2


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(B, 13)).astype(np.float32),
            "sparse": rng.integers(0, VOCAB, size=(B, 26), dtype=np.int32),
            "label": (rng.random(B) > 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def init():
    jmodel = jdf.DeepFM(vocab_size=VOCAB, embed_dim=D, hidden=HIDDEN)
    params = jax.device_get(jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 13)), jnp.zeros((1, 26), jnp.int32)))(
            jax.random.PRNGKey(0))["params"])
    return jmodel, params


def _port(params) -> tdf.DeepFM:
    model = tdf.DeepFM(vocab_size=VOCAB, embed_dim=D, hidden=HIDDEN,
                       device="cpu")
    model.load_state_dict(bridge.flax_variables_to_torch(
        {"params": params}))
    return model


def _flax_grads(model) -> dict:
    return bridge.torch_to_flax_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"]


def _close(got, want, atol):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        mine = got
        for key in path:
            mine = mine[key.key]
        np.testing.assert_allclose(mine, np.asarray(leaf), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_forward_loss_and_dense_gradients(init):
    jmodel, params = init
    b = _batch(1)

    def loss(p):
        return jdf.bce_with_logits(
            jmodel.apply({"params": p}, b["dense"], b["sparse"]), b["label"])

    jlogits = np.asarray(jmodel.apply({"params": params}, b["dense"],
                                      b["sparse"]))
    jloss, jgrads = jax.value_and_grad(loss)(params)

    model = _port(params)
    logits = model(torch.from_numpy(b["dense"]), torch.from_numpy(b["sparse"]))
    assert logits.shape == (B, 1) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=1e-5)
    tloss = tdf.bce_with_logits(logits, torch.from_numpy(b["label"]))
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5)
    tloss.backward()
    assert not model.sparse_embed.weight.grad.is_sparse
    assert model.sparse_embed.weight.grad.shape == (VOCAB, D)
    untouched = np.setdiff1d(np.arange(VOCAB), b["sparse"])
    assert not model.sparse_embed.weight.grad[untouched].any()
    _close(_flax_grads(model), jax.device_get(jgrads), 1e-5)


def test_bce_with_logits_equals_the_jax_packages():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(257, 1)) * 20).astype(np.float32)
    labels = (rng.random(257) > 0.3).astype(np.float32)
    want = float(jdf.bce_with_logits(jnp.asarray(logits),
                                     jnp.asarray(labels)))
    got = tdf.bce_with_logits(torch.from_numpy(logits),
                              torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("scores,labels", [
    (np.random.default_rng(3).random(500), np.random.default_rng(4)
     .random(500) > 0.6),
    # ties: a few distinct scores, midranks decide
    (np.round(np.random.default_rng(5).random(300), 1),
     np.random.default_rng(6).random(300) > 0.5),
    (np.array([0.5, 0.5, 0.5, 0.5]), np.array([0, 1, 0, 1])),
    (np.array([0.1, 0.9, 0.3]), np.array([1, 1, 1]))])   # one class: nan
def test_auc_equals_the_jax_packages(scores, labels):
    scores = scores.astype(np.float32)
    labels = labels.astype(np.float32)
    want, got = jdf.auc(scores, labels), tdf.auc(scores, labels)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want


def test_five_adam_steps_match_optax(init):
    jmodel, params = init
    batches = [_batch(10 + i) for i in range(5)]
    tx = optax.adam(LR)

    @jax.jit
    def jstep(p, opt, b):
        def loss(p):
            return jdf.bce_with_logits(
                jmodel.apply({"params": p}, b["dense"], b["sparse"]),
                b["label"])
        value, g = jax.value_and_grad(loss)(p)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, value

    model = _port(params)
    state = TrainState.create(model=model, tx=adam(LR))
    jp, jopt = params, tx.init(params)
    for b in batches:
        jp, jopt, jloss = jstep(jp, jopt, b)
        for _, p in state.params:
            p.grad = None
        loss = tdf.bce_with_logits(
            model(torch.from_numpy(b["dense"]),
                  torch.from_numpy(b["sparse"])),
            torch.from_numpy(b["label"]))
        loss.backward()
        state.apply_gradients()
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    ours = bridge.torch_to_flax_variables(model.state_dict())["params"]
    jp = jax.device_get(jp)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        mine, start = ours, params
        for key in path:
            mine, start = mine[key.key], start[key.key]
        moved = np.linalg.norm(np.asarray(leaf, np.float64) - start)
        gap = np.linalg.norm(mine - np.asarray(leaf, np.float64))
        assert gap <= MOVE_REL * moved, jax.tree_util.keystr(path)
    # rows an id touched in step 1 only still moved in steps 2-5 (dense
    # Adam: their moments decay into updates), as optax's did
    first = np.setdiff1d(batches[0]["sparse"],
                         np.concatenate([b["sparse"] for b in batches[1:]]))
    assert first.size
    assert not np.array_equal(ours["sparse_embed"]["embedding"][first],
                              params["sparse_embed"]["embedding"][first])


def test_parameter_count_at_the_default_vocab():
    shapes = jax.eval_shape(lambda: jdf.DeepFM().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 13)),
        jnp.zeros((1, 26), jnp.int32)))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    model = get_model("DeepFM")(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want == 11_430_815
    names = {n for n, _ in model.named_parameters()}
    assert {"sparse_embed.weight", "sparse_linear.weight",
            "dense_linear.weight", "deep_0.weight", "deep_out.bias"} <= names
