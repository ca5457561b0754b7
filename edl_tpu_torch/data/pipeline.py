"""Sharded, deterministic input pipeline (trimmed copy of
``edl_tpu.data.pipeline``: ``epoch_indices``, ``FileSource``,
``materialize_batch`` and ``DataLoader`` inline, with batch transforms,
and the host image transforms ``random_flip_lr``/``random_crop``).

The same (seed, epoch, rank, world) gives the same batches, bit for bit,
as the JAX package's loader:

- **seed-per-pass determinism**: the epoch's global order is
  `default_rng(seed + epoch)`; a restart replays the identical order.
- **shard-by-rank on the GLOBAL order**: rank r of world W takes indices
  `perm[r::W]`.
- **static shapes**: drop_remainder truncates to a whole number of batches
  per shard.

Batches are host numpy; the train loop places them on the device
(a pinned, non-blocking copy).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Iterator, Sequence

import numpy as np

from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.exceptions import EdlDataError


def epoch_indices(n: int, epoch: int, seed: int = 0,
                  shuffle: bool = True) -> np.ndarray:
    """The epoch's deterministic global sample order (seed-per-pass)."""
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(seed + epoch).permutation(n)


def _npz_meta(path: str, first_only: bool = False
              ) -> dict[str, tuple[tuple[int, ...], np.dtype]]:
    """{key: (shape, dtype)} of an .npz shard from the members' .npy
    HEADERS only (NpzFile.__getitem__ would decompress whole members —
    at dataset scale that's a full read of every shard just to size the
    index). `first_only` stops after one member — all a row count needs."""
    import zipfile

    from numpy.lib import format as npy_format

    out: dict[str, tuple[tuple[int, ...], np.dtype]] = {}
    with zipfile.ZipFile(path) as zf:
        names = [n for n in zf.namelist() if n.endswith(".npy")]
        if not names:
            raise EdlDataError(f"{path}: no arrays in npz")
        for name in names[:1] if first_only else names:
            with zf.open(name) as f:
                version = npy_format.read_magic(f)
                try:
                    shape, _, dtype = npy_format._read_array_header(
                        f, version)
                except AttributeError:  # private API moved: full read
                    with np.load(path) as z:
                        arr = z[name[:-4]]
                        shape, dtype = arr.shape, arr.dtype
            out[name[:-4]] = (tuple(shape), np.dtype(dtype))
    return out


def _npz_rows(path: str) -> int:
    """Row count of an .npz shard (header of the first member only)."""
    shape = next(iter(_npz_meta(path, first_only=True).values()))[0]
    if not shape:
        raise EdlDataError(f"{path}: scalar array cannot be a data shard")
    return int(shape[0])


class FileSource:
    """Random-access source over .npz shard files (file-backed ArraySource).

    The file-backed input path of the reference's reader stack (a cv2/
    DALI-class reader walks an image file list, reader_cv2.py) for the
    deterministic loader: an index maps global row -> (file, local row);
    whole shards load lazily on first touch and stay in a small LRU so a
    shuffled epoch doesn't thrash (with shuffle, touches cluster by the
    permutation's locality; size the cache to a few shards).

    Files must share keys; per-file row counts come from reading only the
    first member's .npy header (`_npz_rows`) so constructing the index
    never loads shard data.
    """

    def __init__(self, files: Sequence[str], cache_files: int = 4):
        if not files:
            raise EdlDataError("FileSource needs at least one file")
        if cache_files < 1:
            raise EdlDataError(f"cache_files must be >= 1, got {cache_files}")
        self.files = list(files)
        self._counts = [_npz_rows(f) for f in self.files]
        self._starts = np.cumsum([0] + self._counts)
        # insertion/recency-ordered LRU: hits refresh via O(1)
        # move_to_end (the old list.remove hit path was O(cache) under
        # the lock — measurable with many concurrent DataServer readers)
        self._cache: OrderedDict[int, dict[str, np.ndarray]] = \
            OrderedDict()  # guarded-by: _cache_lock
        self._meta: dict[str, tuple[tuple[int, ...], np.dtype]] | None = None
        self.cache_files = cache_files
        # DataServer serves one source from a thread per connection; the
        # LRU bookkeeping must not race across concurrent batch() calls.
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return int(self._starts[-1])

    def _shard(self, fi: int) -> dict[str, np.ndarray]:
        with self._cache_lock:
            arrays = self._cache.get(fi)
            if arrays is not None:
                self._cache.move_to_end(fi)  # refresh recency on hit
        if arrays is not None:
            return arrays  # slicing happens in batch(), lock released
        with np.load(self.files[fi]) as z:  # disk read outside the lock
            arrays = {k: z[k] for k in z.files}
        with self._cache_lock:
            racer = self._cache.get(fi)
            if racer is not None:  # another thread loaded it first
                self._cache.move_to_end(fi)
                arrays = racer
            else:
                self._cache[fi] = arrays
                while len(self._cache) > self.cache_files:
                    self._cache.popitem(last=False)
        return arrays

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        idx = np.asarray(idx)
        if len(idx) == 0:
            # Empty request (e.g. a remote DataServer client asking for
            # zero rows) gets empty arrays of the right shapes/dtypes,
            # not an IndexError from parts[0] below. Header-only scan,
            # parsed once — loading a shard here would churn the LRU
            # for zero rows.
            if self._meta is None:
                self._meta = _npz_meta(self.files[0])
            return {k: np.empty((0,) + shape[1:], dtype)
                    for k, (shape, dtype) in self._meta.items()}
        fis = np.searchsorted(self._starts, idx, side="right") - 1
        locals_ = idx - self._starts[fis]
        if fis[0] == fis[-1] and (fis == fis[0]).all():
            # Whole batch inside ONE shard (always true for single-file
            # sources, common under the permutation's locality): one
            # fancy-index gather per key, in request order — no
            # per-part slicing, no second collation buffer.
            shard = self._shard(int(fis[0]))
            return {k: v[locals_] for k, v in shard.items()}
        out: dict[str, list] = {}
        # group by file so each shard is touched once per batch
        order = np.argsort(fis, kind="stable")
        parts = []
        for fi in np.unique(fis):
            sel = order[fis[order] == fi]
            shard = self._shard(int(fi))
            parts.append((sel, {k: v[locals_[sel]]
                                for k, v in shard.items()}))
        keys = parts[0][1].keys()
        n = len(idx)
        for k in keys:
            first = parts[0][1][k]
            buf = np.empty((n,) + first.shape[1:], first.dtype)
            for sel, arrs in parts:
                buf[sel] = arrs[k]
            out[k] = buf
        return out


def materialize_batch(source, idx: np.ndarray,
                      transforms: Sequence[Callable],
                      batch_seed: int | None) -> dict[str, np.ndarray]:
    """Compute one batch from a descriptor: the rows ``idx`` of
    ``source``, then the post-collation ``transforms`` with a generator
    seeded by ``batch_seed`` (drawn by the loader in step order, so the
    batch bytes are a pure function of the descriptor)."""
    batch = source.batch(idx)
    if transforms:
        brng = np.random.default_rng(batch_seed)
        for t in transforms:
            batch = t(batch, brng)
    return batch


class DataLoader:
    """Deterministic sharded batch iterator.

    Args:
      source: FileSource, or anything with __len__ + batch(indices)->dict.
      batch_size: per-RANK batch size.
      rank/world: this trainer's shard of the global order.
      seed: base shuffle seed; epoch is folded in per pass.
      transforms: callables (batch_dict, np.random.Generator) -> batch_dict,
        run on host after collation (augmentation hook); the generator is
        seeded per (epoch, rank, step) so augmentation replays after a
        restart.
      num_workers: PROCESS pool width. Only 0 (inline) is ported; None
        reads the `EDL_TPU_LOADER_WORKERS` env contract, and a width
        above 0 raises (the shared-memory mp loader is ROADMAP Queue 1
        item 8).

    The JAX loader's per-sample transforms with their decode thread pool
    and its device-augmentation seed are not ported yet (item 8).
    """

    def __init__(self, source, batch_size: int, *, rank: int = 0,
                 world: int = 1, seed: int = 0, shuffle: bool = True,
                 drop_remainder: bool = True,
                 transforms: Sequence[Callable] = (),
                 num_workers: int | None = None):
        if world < 1 or not (0 <= rank < world):
            raise EdlDataError(f"bad shard rank={rank} world={world}")
        if num_workers is None:
            num_workers = int(config.env_float("EDL_TPU_LOADER_WORKERS", 0))
        if num_workers < 0:
            raise EdlDataError(f"num_workers must be >= 0, got {num_workers}")
        if num_workers > 0:
            raise NotImplementedError(
                f"num_workers={num_workers}: the shared-memory mp loader "
                "is not ported yet (ROADMAP Queue 1 item 8); use 0")
        self.source = source
        self.batch_size = batch_size
        self.rank = rank
        self.world = world
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.transforms = list(transforms)

    def steps_per_epoch(self) -> int:
        shard = len(self.source) // self.world if self.drop_remainder \
            else -(-len(self.source) // self.world)
        if self.drop_remainder:
            return shard // self.batch_size
        return -(-shard // self.batch_size)

    def _epoch_descriptors(self, epoch: int, start_step: int):
        """(step, indices, batch_seed) for steps >= start_step — with
        every seed draw made in step order from the per-(epoch, rank)
        generator, INCLUDING the skipped steps', so a mid-epoch resume
        replays the identical remainder."""
        perm = epoch_indices(len(self.source), epoch, self.seed,
                             self.shuffle)
        mine = perm[self.rank::self.world]
        n_steps = self.steps_per_epoch()
        if n_steps == 0:
            # An empty epoch is always a config bug (batch bigger than the
            # shard); yielding nothing turns it into a silent hang for
            # any epoch-looping consumer.
            raise EdlDataError(
                f"shard of {len(mine)} samples yields 0 batches of "
                f"{self.batch_size} (world={self.world})")
        rng = np.random.default_rng(
            (self.seed + 1) * 1_000_003 + epoch * 4093 + self.rank)
        descs = []
        for i in range(n_steps):
            idx = mine[i * self.batch_size:(i + 1) * self.batch_size]
            if len(idx) == 0:
                break
            bseed = int(rng.integers(0, 2**63)) if self.transforms else None
            if i >= start_step:
                descs.append((i, idx, bseed))
        return descs

    def epoch(self, epoch: int, start_step: int = 0
              ) -> Iterator[dict[str, np.ndarray]]:
        """The epoch's batch stream from the `start_step` cursor
        (seed-per-pass: the same (epoch, start_step) always replays the
        same remainder — the elastic stop-resume contract)."""
        for _step, idx, bseed in self._epoch_descriptors(epoch, start_step):
            yield materialize_batch(self.source, idx, self.transforms, bseed)

    def __call__(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        # TrainLoop's data_fn signature.
        return self.epoch(epoch)


# -- host-side image augmentation (the JAX loader's batch transforms) -------

def random_flip_lr(batch: dict, rng: np.random.Generator,
                   key: str = "image") -> dict:
    """Per-sample horizontal flip with p=0.5 (NHWC)."""
    imgs = batch[key]
    flip = rng.random(len(imgs)) < 0.5
    out = imgs.copy()
    out[flip] = out[flip, :, ::-1]
    return {**batch, key: out}


def random_crop(batch: dict, rng: np.random.Generator, *, pad: int = 4,
                key: str = "image") -> dict:
    """Pad-and-random-crop (NHWC): reflect padding, then each image's
    (y, x) window, picked by one gather over a sliding-window view. The
    draws (ys, then xs) and windows are the JAX loader's."""
    imgs = batch[key]
    n, h, w, c = imgs.shape
    padded = np.pad(imgs, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect")
    ys = rng.integers(0, 2 * pad + 1, size=n)
    xs = rng.integers(0, 2 * pad + 1, size=n)
    windows = np.lib.stride_tricks.sliding_window_view(
        padded, (h, w), axis=(1, 2))          # (n, 2p+1, 2p+1, c, h, w)
    out = np.ascontiguousarray(
        windows[np.arange(n), ys, xs].transpose(0, 2, 3, 1))
    return {**batch, key: out}
