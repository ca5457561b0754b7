"""Batch augmentation on the device: crop/flip/normalize and mixup
(port of ``edl_tpu.ops.augment``).

The JAX package computes all of this in plain jnp under jit, not in
Pallas; plain torch ops on the device are its port. No kernel is
written for it.

- ``normalize_image`` and ``mixup`` are the ops the classification step
  runs. The JAX package draws mixup's coefficient and partner
  permutation inside its jitted step from ``fold_in(seed, step)``; the
  port takes them from an explicit ``numpy.random.Generator`` (the step
  seeds one from (seed, step), so a resumed run replays the same
  stream), or as given values, which is how the tests feed both
  packages the same draws.
- ``make_device_augment`` is the packed-records path's crop/flip
  (+ normalize): the loader ships raw bytes and the per-step batch seed
  (``DataLoader(emit_batch_seed=True)``), and the augment runs on the
  card on the prefetch thread's side stream. Its draws (flip, then y,
  then x, the host pipeline's order) come from an explicit
  ``torch.Generator`` (Philox on a card) seeded from (``base_seed``, the
  batch seed), so a run, and a resume at any step, replays them. They
  cannot match the JAX package's threefry draws; the transforms
  themselves do: ``apply_flip_lr``/``apply_crop`` given the same
  decisions (``host_crop_flip_decisions`` replays the host pipeline's
  numpy draws) give the JAX package's pixels bit for bit, uint8 staying
  uint8 until ``normalize_image``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# Per-channel ImageNet statistics, scaled to the uint8 range (pixels ship
# as 1 byte a channel and normalize on the device).
IMAGENET_MEAN = (0.485 * 255.0, 0.456 * 255.0, 0.406 * 255.0)
IMAGENET_STD = (0.229 * 255.0, 0.224 * 255.0, 0.225 * 255.0)


def normalize_image(images: torch.Tensor, mode: str | None) -> torch.Tensor:
    """Pixel normalization of NHWC batches.

    None: passthrough (floats already normalized on the host, the npz
    path); 'imagenet': per-channel (x - mean) / std; 'unit':
    x * (2/255) - 1."""
    if mode is None:
        return images
    if mode == "imagenet":
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                            device=images.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                           device=images.device)
        return (images.float() - mean) / std
    if mode == "unit":
        return images.float() * (2.0 / 255.0) - 1.0
    raise ValueError(f"unknown normalize mode {mode!r}")


def mixup(images: torch.Tensor, targets: torch.Tensor, alpha: float, *,
          rng: np.random.Generator | None = None, lam: float | None = None,
          perm=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixup a batch with one Beta(alpha, alpha) coefficient and a random
    permutation of the batch as the mixing partner.

    ``lam``/``perm`` are drawn from ``rng`` unless given. The mix is
    computed in fp32, as JAX promotes it, and the images come back in
    their own dtype.
    """
    n = images.shape[0]
    if lam is None:
        lam = rng.beta(alpha, alpha)
    if perm is None:
        perm = rng.permutation(n)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=images.device)
    perm = torch.as_tensor(np.array(perm), dtype=torch.long,
                           device=images.device)
    x = images.float()
    mixed_x = lam_t * x + (1.0 - lam_t) * x[perm]
    mixed_y = lam_t * targets + (1.0 - lam_t) * targets[perm]
    return mixed_x.to(images.dtype), mixed_y


# -- crop and flip (decision -> pixels) --------------------------------------

def apply_flip_lr(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Per-sample horizontal flip (NHWC) by a boolean mask."""
    flip = torch.as_tensor(flip, device=images.device).bool()
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def _reflect(i: torch.Tensor, size: int) -> torch.Tensor:
    """numpy's "reflect" padding index (the edge is not repeated)."""
    i = i.abs()
    return torch.where(i > size - 1, 2 * (size - 1) - i, i)


def apply_crop(images: torch.Tensor, ys, xs, pad: int) -> torch.Tensor:
    """Pad-and-crop (NHWC) at per-sample offsets (y, x) into the image
    reflect-padded by ``pad``: one gather of the reflected rows and
    columns, so the dtype (uint8 pixels) is kept."""
    n, h, w, _ = images.shape
    if pad >= min(h, w):
        raise ValueError(f"reflect pad {pad} needs images above {pad} "
                         f"pixels a side, got {h}x{w}")
    dev = images.device
    ys = torch.as_tensor(ys, device=dev).long()
    xs = torch.as_tensor(xs, device=dev).long()
    rows = _reflect(ys[:, None] + torch.arange(h, device=dev) - pad, h)
    cols = _reflect(xs[:, None] + torch.arange(w, device=dev) - pad, w)
    batch = torch.arange(n, device=dev)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def host_crop_flip_decisions(batch_seed: int, n: int, pad: int = 4
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host pipeline's draws for one batch (``random_flip_lr`` then
    ``random_crop``: n uniforms, then ys, then xs), which both packages
    share."""
    rng = np.random.default_rng(batch_seed)
    flip = rng.random(n) < 0.5
    ys = rng.integers(0, 2 * pad + 1, size=n)
    xs = rng.integers(0, 2 * pad + 1, size=n)
    return flip, ys.astype(np.int32), xs.astype(np.int32)


def augment_generator(base_seed: int, batch_seed: int,
                      device: torch.device) -> torch.Generator:
    """The generator of one batch's draws, seeded from (base_seed,
    batch_seed): Philox on a card."""
    words = np.random.SeedSequence(
        [int(base_seed) & 0xFFFFFFFF, int(batch_seed) & 0xFFFFFFFF]
    ).generate_state(2, np.uint32)
    seed = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=device).manual_seed(seed)


def make_device_augment(*, pad: int = 4, flip: bool = True,
                        crop: bool = True, normalize: str | None = None,
                        base_seed: int = 0, image_key: str = "image"
                        ) -> Callable:
    """``(batch, seed) -> batch`` on the batch's device: ``seed`` is the
    loader's per-step batch seed, drawn into flip, y and x decisions in
    the host pipeline's order; ``image_key`` is replaced (normalized if
    ``normalize``), every other key is carried through."""

    def augment(batch: dict, seed: int) -> dict:
        images = batch[image_key]
        n = images.shape[0]
        gen = augment_generator(base_seed, seed, images.device)
        if flip:
            u = torch.rand(n, generator=gen, device=images.device)
            images = apply_flip_lr(images, u < 0.5)
        if crop:
            ys = torch.randint(0, 2 * pad + 1, (n,), generator=gen,
                               device=images.device)
            xs = torch.randint(0, 2 * pad + 1, (n,), generator=gen,
                               device=images.device)
            images = apply_crop(images, ys, xs, pad)
        return {**{k: v for k, v in batch.items() if k != image_key},
                image_key: normalize_image(images, normalize)}

    return augment
