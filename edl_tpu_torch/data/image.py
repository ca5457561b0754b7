"""Host-side JPEG decode + augmentation input plane (port of
``edl_tpu.data.image``).

- **uint8 NHWC RGB out, normalize on the device**: the host ships one
  byte a channel, and the step (or the device augment) does the
  mean/std math on the card.
- **Determinism under a thread pool**: every sample's augmentation seed
  is drawn by the loader from its per-(epoch, rank) generator before the
  pool touches the batch, so any thread interleaving gives the same
  batch bytes.
- Transforms are per-sample callables ``(sample_dict, rng) -> dict``;
  ``DataLoader(sample_transforms=...)`` runs them under its decode pool.

cv2 is the decode engine, as in the JAX package. It is imported on
first use, not with this module, and its own threading is turned off
(the loader's pool owns the parallelism); where cv2 is missing the JPEG
plane raises ``EdlDataError``, and every other plane runs.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np

from edl_tpu_torch.utils.exceptions import EdlDataError

_cv2_module = None


def _cv2():
    """cv2, imported once, with its thread pool off."""
    global _cv2_module
    if _cv2_module is None:
        try:
            import cv2
        except ImportError as exc:
            raise EdlDataError(
                "cv2 is required for the JPEG input plane") from exc
        cv2.setNumThreads(0)
        _cv2_module = cv2
    return _cv2_module


def decode_jpeg(buf: bytes | np.ndarray) -> np.ndarray:
    """JPEG/PNG bytes -> RGB uint8 HWC (reference decodes BGR via
    cv2.imread then flips to RGB at normalize time, img_tool.py:133)."""
    cv2 = _cv2()
    arr = np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes, bytearray)) \
        else np.asarray(buf, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
    if img is None:
        raise EdlDataError("cv2 could not decode image bytes")
    return img[:, :, ::-1]  # BGR -> RGB


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """RGB uint8 HWC -> JPEG bytes (synthetic-dataset / test helper)."""
    cv2 = _cv2()
    ok, buf = cv2.imencode(".jpg", np.asarray(img)[:, :, ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    if not ok:
        raise EdlDataError("cv2 could not encode image")
    return bytes(buf)


def random_resized_crop(img: np.ndarray, rng: np.random.Generator,
                        size: int, scale: tuple[float, float] = (0.08, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3)
                        ) -> np.ndarray:
    """The Inception-style crop of the reference (img_tool.py:34-69):
    sample aspect = sqrt(U(ratio)), bound the area scale so the crop
    fits, take a uniform window, resize to (size, size)."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    aspect = math.sqrt(rng.uniform(*ratio))
    cw, ch = aspect, 1.0 / aspect
    bound = min((w / h) / (cw * cw), (h / w) / (ch * ch))
    scale_max = min(scale[1], bound)
    scale_min = min(scale[0], bound)
    target_area = h * w * rng.uniform(scale_min, scale_max)
    target = math.sqrt(target_area)
    # int() truncation keeps the window inside the image (the bound
    # guarantees the exact-real window fits); clamp for 1-pixel edges
    cw = min(max(1, int(target * cw)), w)
    ch = min(max(1, int(target * ch)), h)
    i = rng.integers(0, h - ch + 1)
    j = rng.integers(0, w - cw + 1)
    return cv2.resize(img[i:i + ch, j:j + cw], (size, size),
                      interpolation=cv2.INTER_LINEAR)


def random_flip_lr_sample(img: np.ndarray, rng: np.random.Generator
                          ) -> np.ndarray:
    """Horizontal flip with p=0.5 (img_tool.py:128-129)."""
    return img[:, ::-1] if rng.random() < 0.5 else img


def random_rotate(img: np.ndarray, rng: np.random.Generator,
                  max_deg: float = 10.0) -> np.ndarray:
    """Rotate about the center by U(-max_deg, max_deg)
    (img_tool.py:24-31 `rotate_image`, the reference's --rotate flag)."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    angle = float(rng.uniform(-max_deg, max_deg))
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    return cv2.warpAffine(img, m, (w, h))


def resize_short(img: np.ndarray, target: int) -> np.ndarray:
    """Scale so the SHORT side equals target (img_tool.py:77-86)."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    percent = target / min(h, w)
    return cv2.resize(img, (int(round(w * percent)),
                            int(round(h * percent))),
                      interpolation=cv2.INTER_LINEAR)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Central (size, size) window (img_tool.py:89-103 center=True)."""
    h, w = img.shape[:2]
    i = (h - size) // 2
    j = (w - size) // 2
    return img[i:i + size, j:j + size]


def train_image_transform(size: int = 224,
                          scale: tuple[float, float] = (0.08, 1.0),
                          ratio: tuple[float, float] = (3 / 4, 4 / 3),
                          rotate: bool = False,
                          key: str = "jpeg", out: str = "image"):
    """Per-sample train path: decode -> [rotate] -> random-resized-crop
    -> flip (the order of process_image, img_tool.py:119-131; rotate is
    the reference's off-by-default --rotate flag).

    Returns a `(sample, rng) -> sample` callable for
    `DataLoader(sample_transforms=...)`. Output is uint8 (size, size, 3)
    RGB under `out`; the raw bytes key is dropped."""

    def transform(sample: dict, rng: np.random.Generator) -> dict:
        img = decode_jpeg(sample[key])
        if rotate:
            img = random_rotate(img, rng)
        img = random_resized_crop(img, rng, size, scale, ratio)
        img = random_flip_lr_sample(img, rng)
        rest = {k: v for k, v in sample.items() if k != key}
        return {**rest, out: np.ascontiguousarray(img)}

    return transform


def eval_image_transform(size: int = 224, short: int = 256,
                         key: str = "jpeg", out: str = "image"):
    """Per-sample eval path: decode -> resize-short -> center-crop
    (img_tool.py:134-137, resize_short_size=256 for crop 224)."""

    def transform(sample: dict, rng: np.random.Generator) -> dict:
        del rng  # eval is augmentation-free
        img = decode_jpeg(sample[key])
        img = center_crop(resize_short(img, short), size)
        rest = {k: v for k, v in sample.items() if k != key}
        return {**rest, out: np.ascontiguousarray(img)}

    return transform


class JpegFileListSource:
    """Random-access source over a `path label` file list of JPEGs.

    The reference's file-list contract (reader_cv2.py:39-88: one
    `<relpath> <int label>` pair per line, paths relative to a data
    root). `samples(idx)` returns per-sample dicts with RAW bytes —
    decode happens in the loader's transform pool, where it
    parallelizes; this class only does I/O.
    """

    def __init__(self, list_file: str | None = None, root: str = "",
                 entries: Sequence[tuple[str, int]] | None = None):
        if (list_file is None) == (entries is None):
            raise EdlDataError(
                "JpegFileListSource needs exactly one of list_file/entries")
        if list_file is not None:
            entries = []
            with open(list_file) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    path, label = line.rsplit(None, 1)
                    entries.append((path, int(label)))
        if not entries:
            raise EdlDataError("empty JPEG file list")
        self.root = root
        self.entries = list(entries)

    def __len__(self) -> int:
        return len(self.entries)

    def samples(self, idx: np.ndarray) -> list[dict]:
        out = []
        for i in idx:
            path, label = self.entries[int(i)]
            with open(os.path.join(self.root, path), "rb") as f:
                out.append({"jpeg": f.read(),
                            "label": np.int32(label)})
        return out


def make_synthetic_jpeg_dataset(directory: str, n: int, *,
                                classes: int = 1000,
                                hw: tuple[int, int] = (360, 480),
                                seed: int = 0,
                                quality: int = 90) -> str:
    """Write n random JPEGs + train.txt under `directory`; returns the
    list-file path. Sizes jitter around `hw` so crop paths see varied
    shapes (real ImageNet is variable-sized)."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        h = int(hw[0] * rng.uniform(0.8, 1.25))
        w = int(hw[1] * rng.uniform(0.8, 1.25))
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        name = f"img_{i:06d}.jpg"
        with open(os.path.join(directory, name), "wb") as f:
            f.write(encode_jpeg(img, quality))
        lines.append(f"{name} {int(rng.integers(0, classes))}")
    list_file = os.path.join(directory, "train.txt")
    with open(list_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    return list_file
