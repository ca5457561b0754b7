"""Device crop/flip/normalize (ops/augment.py) against the JAX package's.

Both packages compute the augmentation in plain array ops (jnp under jit,
torch on the device); the decisions differ (threefry against Philox), so
the transforms are held bit for bit with the decisions injected: the host
pipeline's numpy draws (``host_crop_flip_decisions``, shared by both),
fed to ``apply_flip_lr``/``apply_crop`` of each package, for uint8 and
fp32 pixels, several pads and image shapes. The same decisions through
the host transforms (``random_flip_lr`` then ``random_crop``) give the
same pixels too. ``make_device_augment`` replays its draws from (base
seed, batch seed), keeps uint8 until ``normalize_image``, and carries the
other keys through.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import augment as ja
from edl_tpu_torch.data import pipeline as tpipe
from edl_tpu_torch.ops import augment as ta
from test_torch_world import one_torch_thread  # noqa: F401


def images(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=shape)
    return x.astype(dtype) if dtype == np.uint8 else \
        (x / 255.0).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float16])
@pytest.mark.parametrize("shape,pad", [((6, 10, 12, 3), 4),
                                       ((5, 9, 9, 1), 2),
                                       ((3, 16, 8, 3), 7)])
@pytest.mark.parametrize("seed", [0, 11])
def test_flip_and_crop_match_jax(dtype, shape, pad, seed):
    x = images(dtype, shape, seed)
    flip, ys, xs = ta.host_crop_flip_decisions(seed, shape[0], pad)
    want = np.asarray(ja.apply_crop(
        ja.apply_flip_lr(jnp.asarray(x), jnp.asarray(flip)),
        jnp.asarray(ys), jnp.asarray(xs), pad))
    got = ta.apply_crop(ta.apply_flip_lr(torch.from_numpy(x),
                                         torch.from_numpy(flip)),
                        torch.from_numpy(ys), torch.from_numpy(xs),
                        pad).numpy()
    assert got.dtype == want.dtype == dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed,n,pad", [(3, 7, 4), (99, 1, 2)])
def test_decisions_are_the_jax_package_s(seed, n, pad):
    for a, b in zip(ta.host_crop_flip_decisions(seed, n, pad),
                    ja.host_crop_flip_decisions(seed, n, pad)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_the_host_transforms_cut_the_same_pixels(dtype):
    x = images(dtype, (8, 12, 10, 3))
    rng = np.random.default_rng(5)
    host = tpipe.random_crop(tpipe.random_flip_lr({"image": x}, rng), rng)
    flip, ys, xs = ta.host_crop_flip_decisions(5, 8)
    dev = ta.apply_crop(ta.apply_flip_lr(torch.from_numpy(x),
                                         torch.from_numpy(flip)), ys, xs, 4)
    assert dev.numpy().tobytes() == host["image"].tobytes()


def test_device_augment_replays_its_draws():
    x = torch.from_numpy(images(np.uint8, (8, 12, 12, 3)))
    batch = {"image": x, "label": torch.arange(8)}
    aug = ta.make_device_augment(pad=4, base_seed=1)
    a, b = aug(batch, 77), aug(batch, 77)
    assert a["image"].dtype == torch.uint8
    assert torch.equal(a["image"], b["image"])
    assert not torch.equal(a["image"], aug(batch, 78)["image"])
    assert not torch.equal(a["image"],
                           ta.make_device_augment(base_seed=2)(batch,
                                                               77)["image"])
    assert torch.equal(a["label"], batch["label"])
    # the draws: flip, then y, then x, from the (base, batch) generator
    gen = ta.augment_generator(1, 77, x.device)
    flip = torch.rand(8, generator=gen) < 0.5
    ys = torch.randint(0, 9, (8,), generator=gen)
    xs = torch.randint(0, 9, (8,), generator=gen)
    want = ta.apply_crop(ta.apply_flip_lr(x, flip), ys, xs, 4)
    assert torch.equal(a["image"], want)


@pytest.mark.parametrize("mode", ["imagenet", "unit"])
def test_device_augment_normalizes_last(mode):
    x = torch.from_numpy(images(np.uint8, (4, 10, 10, 3)))
    plain = ta.make_device_augment(base_seed=4)({"image": x}, 9)["image"]
    normed = ta.make_device_augment(base_seed=4, normalize=mode)(
        {"image": x}, 9)["image"]
    assert normed.dtype == torch.float32
    assert torch.equal(normed, ta.normalize_image(plain, mode))
    want = np.asarray(ja.normalize_image(jnp.asarray(plain.numpy()), mode))
    np.testing.assert_allclose(normed.numpy(), want, rtol=0, atol=1e-6)


def test_only_flip_or_only_crop():
    x = torch.from_numpy(images(np.float32, (6, 8, 8, 3)))
    flipped = ta.make_device_augment(crop=False)({"image": x}, 1)["image"]
    assert all(torch.equal(f, i) or torch.equal(f, i.flip(1))
               for f, i in zip(flipped, x))
    same = ta.make_device_augment(crop=False, flip=False)({"image": x},
                                                          1)["image"]
    assert torch.equal(same, x)


def test_a_pad_as_large_as_the_image_is_refused():
    x = torch.zeros(2, 4, 4, 3)
    with pytest.raises(ValueError, match="reflect pad"):
        ta.apply_crop(x, [0, 0], [0, 0], 4)
