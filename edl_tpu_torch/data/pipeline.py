"""Sharded, deterministic, prefetching input pipeline (port of
``edl_tpu.data.pipeline``).

The same (seed, epoch, rank, world) gives the same batches, bit for bit,
as the JAX package's loader, in every execution mode (inline, a decode
thread pool, or forked worker processes handing batches back through a
shared-memory ring, data/mp_loader.py):

- **seed-per-pass determinism**: the epoch's global order is
  `default_rng(seed + epoch)`; a restart replays the identical order, so
  the train loop's step cursor skips exactly the batches already
  consumed;
- **shard-by-rank on the GLOBAL order**: rank r of world W takes indices
  `perm[r::W]`;
- **static shapes**: drop_remainder truncates to a whole number of batches
  per shard;
- **prefetch onto the card** (`prefetch_to_device`): a staging thread
  copies each batch into pinned memory and onto the device on a side
  stream (and runs the device augment there), so the copy of batch i+1
  overlaps step i; the consumer's stream waits on the batch's event
  before using it.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

from edl_tpu_torch.utils.exceptions import EdlDataError

AUGMENT_SEED_KEY = "augment_seed"


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
                      sample_transforms: Sequence[Callable],
                      transforms: Sequence[Callable],
                      sample_seeds: np.ndarray | None,
                      batch_seed: int | None,
                      pool=None, emit_seed: bool = False
                      ) -> dict[str, np.ndarray]:
    """Compute one batch from a descriptor.

    The loader's determinism contract, shared by the inline, thread-pool
    and worker-process modes: every random input is an argument
    (``sample_seeds`` per sample, ``batch_seed`` for the post-collation
    transforms), drawn by the parent in step order, so the batch bytes
    are a pure function of the descriptor wherever it runs. numpy only:
    forked workers run it beside a CUDA context they never touch.

    ``emit_seed`` attaches ``batch_seed`` to the batch as a 0-d uint32
    under ``"augment_seed"``, the device augment's draw.
    """
    if sample_transforms:
        samples = source.samples(idx)

        def work(args):
            sample, seed = args
            srng = np.random.default_rng(seed)
            for t in sample_transforms:
                sample = t(sample, srng)
            return sample

        done = list(pool.map(work, zip(samples, sample_seeds))) if pool \
            else [work(a) for a in zip(samples, sample_seeds)]
        batch = {k: np.stack([d[k] for d in done]) for k in done[0]}
    else:
        batch = source.batch(idx)
    if transforms:
        brng = np.random.default_rng(batch_seed)
        for t in transforms:
            batch = t(batch, brng)
    if emit_seed:
        batch = {**batch,
                 AUGMENT_SEED_KEY: np.asarray(batch_seed & 0xFFFFFFFF,
                                              dtype=np.uint32)}
    return batch


def _close_mp_pool(pool) -> None:
    # weakref.finalize target: must not reference the DataLoader
    pool.close()


class DataLoader:
    """Deterministic sharded batch iterator.

    Args:
      source: FileSource, PackedSource or anything with __len__ +
        batch(indices) -> dict; with ``sample_transforms``, a source with
        ``samples(indices) -> list[dict]`` (e.g. JPEG bytes).
      batch_size: per-RANK batch size.
      rank/world: this trainer's shard of the global order.
      seed: base shuffle seed; epoch is folded in per pass.
      transforms: callables (batch_dict, np.random.Generator) -> batch_dict
        run on the host after collation; the generator is seeded per
        (epoch, rank, step), so augmentation replays after a restart.
      sample_transforms: callables (sample_dict, np.random.Generator) ->
        sample_dict run per sample before collation under a
        ``decode_threads``-wide thread pool; every sample's seed is drawn
        up front, so scheduling cannot change the stream.
      num_workers: PROCESS pool width (0 = inline/threads; None = the
        ``EDL_TPU_LOADER_WORKERS`` env contract). Workers are forked at
        the first batch and hand batches back through a shared-memory
        slot ring in strict step order (data/mp_loader.py), bit for bit
        the inline stream. Those batches are views over the ring, valid
        until the following ``next()``: ``prefetch_to_device`` copies
        them before that.
      emit_batch_seed: attach the per-step batch seed to each batch as a
        0-d uint32 ``"augment_seed"`` for the device augment
        (``ops/augment.make_device_augment``).

    A DataLoader is a context manager; ``close()`` joins the decode pool
    and the worker processes and unlinks every shm segment. TrainLoop
    closes the loader it drives; GC of an abandoned loader also tears its
    pool down.
    """

    def __init__(self, source, batch_size: int, *, rank: int = 0,
                 world: int = 1, seed: int = 0, shuffle: bool = True,
                 drop_remainder: bool = True,
                 transforms: Sequence[Callable] = (),
                 sample_transforms: Sequence[Callable] = (),
                 decode_threads: int = 0,
                 num_workers: int | None = None,
                 emit_batch_seed: bool = False):
        if world < 1 or not (0 <= rank < world):
            raise EdlDataError(f"bad shard rank={rank} world={world}")
        if sample_transforms and not hasattr(source, "samples"):
            raise EdlDataError(
                "sample_transforms need a source with samples(indices)")
        if num_workers is None:
            from edl_tpu_torch.data.mp_loader import default_num_workers
            num_workers = default_num_workers()
        if num_workers < 0:
            raise EdlDataError(f"num_workers must be >= 0, got {num_workers}")
        self.source = source
        self.batch_size = batch_size
        self.rank = rank
        self.world = world
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.transforms = list(transforms)
        self.sample_transforms = list(sample_transforms)
        self.decode_threads = decode_threads
        self.num_workers = num_workers
        self.emit_batch_seed = emit_batch_seed
        self._pool = None
        self._mp_pool = None
        self._mp_finalizer = None

    def _decode_pool(self):
        if self._pool is None and self.decode_threads > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.decode_threads,
                thread_name_prefix="data-decode")
        return self._pool

    def _ensure_mp_pool(self, probe_batch: dict[str, np.ndarray]):
        """The worker pool, (re)built lazily and reused across epochs;
        ``probe_batch`` sizes the shm slots."""
        if self._mp_pool is not None and not (self._mp_pool.closed
                                              or self._mp_pool.broken):
            return self._mp_pool
        from edl_tpu_torch.data import mp_loader
        pool = mp_loader.MpLoaderPool(
            self.source, self.sample_transforms, self.transforms,
            self.num_workers, mp_loader.probe_slot_bytes(probe_batch),
            emit_seed=self.emit_batch_seed)
        self._mp_pool = pool
        self._mp_finalizer = weakref.finalize(self, _close_mp_pool, pool)
        return pool

    def close(self) -> None:
        """Join the decode pool and worker processes, unlink the shm ring
        (idempotent; pools rebuild lazily on the next epoch)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._mp_pool is not None:
            self._mp_pool.close()
            if self._mp_finalizer is not None:
                self._mp_finalizer.detach()
                self._mp_finalizer = None
            self._mp_pool = None

    def __enter__(self) -> "DataLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def steps_per_epoch(self) -> int:
        shard = len(self.source) // self.world if self.drop_remainder \
            else -(-len(self.source) // self.world)
        if self.drop_remainder:
            return shard // self.batch_size
        return -(-shard // self.batch_size)

    def _epoch_descriptors(self, epoch: int, start_step: int):
        """(step, indices, sample_seeds, batch_seed) for steps >=
        start_step, with every seed draw made in step order from the
        per-(epoch, rank) generator, the skipped steps' included, so a
        mid-epoch resume replays the identical remainder."""
        perm = epoch_indices(len(self.source), epoch, self.seed,
                             self.shuffle)
        mine = perm[self.rank::self.world]
        n_steps = self.steps_per_epoch()
        if n_steps == 0:
            # an empty epoch is a config bug (batch bigger than the shard)
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
            sseeds = rng.integers(0, 2**63, size=len(idx)) \
                if self.sample_transforms else None
            bseed = int(rng.integers(0, 2**63)) \
                if self.transforms or self.emit_batch_seed else None
            if i >= start_step:
                descs.append((i, idx, sseeds, bseed))
        return descs

    def epoch(self, epoch: int, start_step: int = 0
              ) -> Iterator[dict[str, np.ndarray]]:
        """The epoch's batch stream from the ``start_step`` cursor (the
        same (epoch, start_step) always replays the same remainder)."""
        descs = self._epoch_descriptors(epoch, start_step)
        if self.num_workers > 0:
            yield from self._epoch_mp(descs)
            return
        pool = self._decode_pool()
        for _step, idx, sseeds, bseed in descs:
            yield materialize_batch(self.source, idx,
                                    self.sample_transforms,
                                    self.transforms, sseeds, bseed, pool,
                                    emit_seed=self.emit_batch_seed)

    def _epoch_mp(self, descs) -> Iterator[dict[str, np.ndarray]]:
        if not descs:
            return
        if self._mp_pool is None or self._mp_pool.closed \
                or self._mp_pool.broken:
            # first mp epoch: batch 0 in the parent (the same descriptor,
            # the same bytes) sizes the ring, then the workers fork
            step0, idx0, sseeds0, bseed0 = descs[0]
            probe = materialize_batch(self.source, idx0,
                                      self.sample_transforms,
                                      self.transforms, sseeds0, bseed0,
                                      emit_seed=self.emit_batch_seed)
            yield probe
            pool = self._ensure_mp_pool(probe)
            descs = descs[1:]
        else:
            pool = self._mp_pool
        yield from pool.imap(descs)

    def __call__(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        # TrainLoop's data_fn signature.
        return self.epoch(epoch)


_END = object()


def prefetch(it: Iterable, size: int = 2,
             place: Callable[[Any], Any] | None = None) -> Iterator:
    """Run ``it`` (and ``place`` on each item) in a daemon thread, keeping
    up to ``size`` items ready. Closing the returned generator (or
    abandoning it, as a stop mid-epoch does) stops the worker and drains
    the queued items."""
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    err: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(place(item) if place else item):
                    return
        except BaseException as exc:  # re-raised on the consumer side
            err.append(exc)
        finally:
            _put(_END)

    def gen():
        # the worker starts at the first next(): a generator closed
        # before it ever runs skips its finally, so an eager thread could
        # never be stopped
        thread = threading.Thread(target=worker, daemon=True,
                                  name="data-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            # drain and join: the worker may be inside next(it), and the
            # caller must not close that iterator while it runs
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.1)
                if not thread.is_alive() or time.monotonic() > deadline:
                    break

    return gen()


def place_array(x, device):
    """A host array as a tensor on ``device``, with the ring-view aliasing
    guard: an array that does not own its memory (the mp loader's shm-ring
    views) is copied before its slot can recycle. On a card every array
    is copied into pinned memory (``pin_memory``, which is that copy) and
    sent with a non-blocking copy on the current stream."""
    import torch

    if isinstance(x, torch.Tensor):       # placed upstream
        return x.to(device, non_blocking=True)
    x = np.ascontiguousarray(x)
    if torch.device(device).type == "cuda":
        return torch.from_numpy(x).pin_memory().to(device,
                                                   non_blocking=True)
    if not x.flags["OWNDATA"]:
        x = np.array(x)
    return torch.from_numpy(x)


def pop_augment_seed(batch, augment) -> tuple:
    """Split a loader batch into (payload, seed) for the device augment.
    A seed with no augment configured, or the reverse, is a wiring bug
    and raises."""
    has_seed = isinstance(batch, dict) and AUGMENT_SEED_KEY in batch
    if augment is None:
        if has_seed:
            raise EdlDataError(
                "loader emitted augment_seed but no device augment fn is "
                "configured (pass augment= / TrainLoop(augment_fn=...), "
                "or drop DataLoader(emit_batch_seed=True))")
        return batch, None
    if not has_seed:
        raise EdlDataError(
            "device augment configured but the batch carries no "
            "augment_seed; construct the DataLoader with "
            "emit_batch_seed=True")
    batch = dict(batch)
    return batch, int(batch.pop(AUGMENT_SEED_KEY))


def prefetch_to_device(it: Iterable, device, size: int = 2,
                       augment: Callable | None = None) -> Iterator:
    """Prefetch onto ``device``: a staging thread pops each batch's
    augment seed, places its arrays (``place_array``) and runs
    ``augment(batch, seed)`` (``ops.augment.make_device_augment``), all
    on a side CUDA stream, and records an event there. The consumer's
    stream waits on that event before the batch is used, and every
    tensor is marked used on it (``record_stream``), so the caching
    allocator does not hand its memory out early. On the CPU the same
    runs without streams."""
    import torch

    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def place(batch):
        batch, seed = pop_augment_seed(batch, augment)
        if side is None:
            placed = {k: place_array(v, device) for k, v in batch.items()}
            return (augment(placed, seed) if augment else placed), None
        with torch.cuda.device(device), torch.cuda.stream(side):
            placed = {k: place_array(v, device) for k, v in batch.items()}
            if augment is not None:
                placed = augment(placed, seed)
            ready = torch.cuda.Event()
            ready.record(side)
        return placed, ready

    def gen():
        staged = prefetch(it, size=size, place=place)
        try:
            for placed, ready in staged:
                if ready is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(ready)
                    for t in placed.values():
                        t.record_stream(stream)
                yield placed
        finally:
            staged.close()

    return gen()


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
