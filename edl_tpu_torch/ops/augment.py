"""Pixel normalization and mixup on the device (trimmed port of
``edl_tpu.ops.augment``).

``normalize_image`` and ``mixup`` are the two ops the classification
step runs on the device. The JAX package draws mixup's coefficient and
partner permutation inside its jitted step from ``fold_in(seed, step)``;
the port takes them from an explicit ``numpy.random.Generator`` (the
step seeds one from (seed, step), so a resumed run replays the same
stream), or as given values, which is how the tests feed both packages
the same draws. The device-side crop/flip of the packed-records path
(``make_device_augment``) comes with that data format (ROADMAP Queue 1
item 8).
"""

from __future__ import annotations

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
