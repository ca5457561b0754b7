"""The port's classification losses and pixel ops
(edl_tpu_torch/train/classification.py, edl_tpu_torch/ops/augment.py)
against the JAX package's on the same numpy inputs, on the CPU.

The same fp32 expressions in the same order, evaluated op by op on both
sides: smoothed labels, mixup (fed JAX's own lambda and permutation) and
normalization are bitwise; the cross-entropy within 1e-6 (log-softmax and
the mean reduce in another order); accuracy exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import augment as jaug
from edl_tpu.train import classification as jcls
from edl_tpu_torch.ops import augment as taug
from edl_tpu_torch.train import classification as tcls

RNG = np.random.default_rng(0)
LABELS = RNG.integers(0, 10, 16).astype(np.int32)
LOGITS = RNG.normal(0, 2, (16, 10)).astype(np.float32)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_smoothed_labels(smoothing):
    want = jcls.smoothed_labels(jnp.asarray(LABELS), 10, smoothing)
    got = tcls.smoothed_labels(torch.from_numpy(LABELS), 10, smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_soft_cross_entropy(smoothing):
    targets = np.array(jcls.smoothed_labels(jnp.asarray(LABELS), 10,
                                            smoothing))
    want = jcls.soft_cross_entropy(jnp.asarray(LOGITS), jnp.asarray(targets))
    got = tcls.soft_cross_entropy(torch.from_numpy(LOGITS),
                                  torch.from_numpy(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 5])
def test_accuracy_topk(k):
    want = jcls.accuracy_topk(jnp.asarray(LOGITS), jnp.asarray(LABELS), k)
    got = tcls.accuracy_topk(torch.from_numpy(LOGITS),
                             torch.from_numpy(LABELS), k)
    assert got.item() == float(want)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_mixup_with_jax_draws(dtype):
    """JAX draws lambda and the permutation from its key; the port is fed
    the same draws and must mix bitwise (images in their own dtype,
    targets in fp32)."""
    images = RNG.normal(size=(8, 6, 6, 3)).astype(dtype)
    targets = np.array(jcls.smoothed_labels(jnp.asarray(LABELS[:8]), 10,
                                            0.1))
    key = jax.random.PRNGKey(5)
    want_x, want_y = jaug.mixup(key, jnp.asarray(images),
                                jnp.asarray(targets), 0.4)
    k1, k2 = jax.random.split(key)
    lam = float(jax.random.beta(k1, 0.4, 0.4))
    perm = np.asarray(jax.random.permutation(k2, 8))
    got_x, got_y = taug.mixup(torch.from_numpy(images),
                              torch.from_numpy(targets), 0.4, lam=lam,
                              perm=perm)
    assert got_x.dtype == torch.from_numpy(images).dtype
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_mixup_draws_replay_per_step():
    """The step's draws come from (seed, step): a resumed run replays
    them; another step draws others."""
    images = torch.from_numpy(RNG.normal(size=(8, 4, 4, 3)).astype(
        np.float32))
    targets = tcls.smoothed_labels(torch.from_numpy(LABELS[:8]), 10)
    a = taug.mixup(images, targets, 0.2, rng=tcls.mixup_rng(3, 7))
    b = taug.mixup(images, targets, 0.2, rng=tcls.mixup_rng(3, 7))
    c = taug.mixup(images, targets, 0.2, rng=tcls.mixup_rng(3, 8))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    # soft targets stay a distribution
    np.testing.assert_allclose(a[1].sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("mode", [None, "imagenet", "unit"])
def test_normalize_image(mode):
    pixels = RNG.integers(0, 256, (2, 5, 5, 3)).astype(np.uint8)
    want = jaug.normalize_image(jnp.asarray(pixels), mode)
    got = taug.normalize_image(torch.from_numpy(pixels), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="normalize"):
        taug.normalize_image(torch.from_numpy(pixels), "bogus")
    assert taug.IMAGENET_MEAN == jaug.IMAGENET_MEAN
    assert taug.IMAGENET_STD == jaug.IMAGENET_STD
