"""The port's input planes on the CPU: the shared-memory mp loader, the
decode thread pool, prefetch and device placement.

- The batch stream is a pure function of (seed, epoch, rank, step): the
  port's loader gives the JAX package's batch bytes inline, with a
  decode thread pool and with forked worker processes (1 and 2), with
  host transforms and with the emitted device-augment seed.
- A SIGKILL'd worker loses nothing: the epoch finishes, in order, each
  batch exactly once; the death of every worker raises instead of
  hanging; a poisoned sample surfaces the worker's traceback at its
  step's turn.
- ``close`` (and the context manager, and TrainLoop's teardown) unlinks
  every /dev/shm segment.
- prefetch / prefetch_to_device: order, errors, an early close, the
  ring-view aliasing guard, and the augment-seed wiring checks.
"""

import contextlib
import os
import signal

import numpy as np
import pytest
import torch

from edl_tpu.data import pipeline as jpipe
from edl_tpu_torch.data import pipeline as tpipe
from edl_tpu_torch.data import shm_ring
from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
from edl_tpu_torch.utils.exceptions import EdlDataError
from test_torch_world import one_torch_thread  # noqa: F401


class ArraySource:
    """A dict of equal-length arrays as a loader source."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def batch(self, idx):
        return {k: v[idx] for k, v in self.arrays.items()}


def arrays(n=64, hw=12):
    rng = np.random.default_rng(0)
    return {"image": rng.integers(0, 256, size=(n, hw, hw, 3),
                                  dtype=np.uint8),
            "label": np.arange(n, dtype=np.int32)}


def shm_segments() -> set:
    prefix = f"edl_mp_{os.getpid()}_"
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith(prefix)}
    except FileNotFoundError:
        return set()


@contextlib.contextmanager
def deadline(seconds: int):
    """Fail, not hang, past ``seconds``."""

    def fire(signum, frame):
        raise TimeoutError(f"test exceeded {seconds}s deadline")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def copy_stream(it):
    return [{k: np.array(v) for k, v in b.items()} for b in it]


def assert_streams_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), k


def _aug(pkg):
    return (pkg.random_flip_lr, lambda b, r: pkg.random_crop(b, r, pad=2))


@pytest.mark.parametrize("mode", [dict(num_workers=0),
                                  dict(num_workers=1),
                                  dict(num_workers=2)],
                         ids=["inline", "1-worker", "2-workers"])
@pytest.mark.parametrize("emit", [False, True], ids=["host", "emit-seed"])
def test_every_mode_gives_the_jax_loader_s_bytes(mode, emit):
    data = arrays()
    with deadline(120):
        want = copy_stream(jpipe.DataLoader(
            jpipe.ArraySource(data), 4, seed=3, transforms=_aug(jpipe),
            emit_batch_seed=emit, num_workers=0).epoch(1))
        with tpipe.DataLoader(ArraySource(data), 4, seed=3,
                              transforms=_aug(tpipe), emit_batch_seed=emit,
                              **mode) as ld:
            got = copy_stream(ld.epoch(1))
    assert_streams_equal(want, got)
    assert ("augment_seed" in got[0]) == emit
    assert not shm_segments()


@pytest.mark.parametrize("rank", [0, 1])
def test_mid_epoch_cursor_replays_the_remainder(rank):
    data = arrays()
    with deadline(120):
        with tpipe.DataLoader(ArraySource(data), 4, seed=9, rank=rank,
                              world=2, transforms=_aug(tpipe)) as inline:
            full = copy_stream(inline.epoch(2))
        with tpipe.DataLoader(ArraySource(data), 4, seed=9, rank=rank,
                              world=2, transforms=_aug(tpipe),
                              num_workers=2) as ld:
            rest = copy_stream(ld.epoch(2, start_step=3))
    assert_streams_equal(full[3:], rest)
    assert not shm_segments()


def test_pool_survives_epochs_and_streams_differ_by_epoch():
    with deadline(120), tpipe.DataLoader(
            ArraySource(arrays()), 4, seed=3, transforms=_aug(tpipe),
            num_workers=2) as ld:
        a = copy_stream(ld.epoch(0))
        pool = ld._mp_pool
        b = copy_stream(ld.epoch(1))
        assert ld._mp_pool is pool
    assert not np.array_equal(a[0]["image"], b[0]["image"])
    assert not shm_segments()


def test_a_killed_worker_loses_nothing():
    """SIGKILL one of two workers mid-epoch: its in-flight batches are
    re-dispatched once and the epoch arrives whole, in order."""
    data = arrays(n=96)
    with deadline(120):
        want = copy_stream(tpipe.DataLoader(
            ArraySource(data), 4, seed=1, transforms=_aug(tpipe)).epoch(0))
        with tpipe.DataLoader(ArraySource(data), 4, seed=1,
                              transforms=_aug(tpipe), num_workers=2) as ld:
            got = []
            for i, b in enumerate(ld.epoch(0)):
                got.append({k: np.array(v) for k, v in b.items()})
                if i == 3:
                    os.kill(ld._mp_pool._procs[0].pid, signal.SIGKILL)
            assert ld._mp_pool.stats()["workers_alive"] == 1
    assert_streams_equal(want, got)
    assert not shm_segments()


def test_every_worker_dead_raises_instead_of_hanging():
    with deadline(120), tpipe.DataLoader(
            ArraySource(arrays(n=96)), 4, seed=1, num_workers=1) as ld:
        with pytest.raises(EdlDataError):
            for i, _ in enumerate(ld.epoch(0)):
                if i == 2:
                    os.kill(ld._mp_pool._procs[0].pid, signal.SIGKILL)
    assert not shm_segments()


def test_a_poisoned_sample_surfaces_the_worker_traceback():
    def poison(batch, rng):
        if 7 in batch["label"]:
            raise RuntimeError("bad sample 7")
        return batch

    with deadline(120), tpipe.DataLoader(
            ArraySource(arrays()), 4, seed=3, shuffle=False,
            transforms=(poison,), num_workers=2) as ld:
        seen = []
        with pytest.raises(EdlDataError, match="bad sample 7") as exc:
            for b in ld.epoch(0):
                seen.append(int(b["label"][0]))
    assert seen == [0]          # batch 0 in order, then batch 1 fails
    assert "Traceback" in str(exc.value)
    assert not shm_segments()


def test_close_is_idempotent_and_the_loop_closes_its_loader():
    ld = tpipe.DataLoader(ArraySource(arrays()), 4, seed=3, num_workers=2)
    with deadline(120):
        copy_stream(ld.epoch(0))
        assert shm_segments()
        ld.close()
        ld.close()
        assert not shm_segments()
        copy_stream(ld.epoch(1))       # the pool rebuilds lazily
        assert shm_segments()

        def step(state, batch):
            return state, {"loss": batch["image"].float().mean()}

        data_fn = ld.epoch
        loop = TrainLoop(step, object(), device="cpu",
                         config=LoopConfig(num_epochs=1))
        wrapped = (lambda e: data_fn(e))
        wrapped.close = ld.close
        loop.run(wrapped)
    assert not shm_segments()


def test_shm_ring_round_trip_keeps_0d_and_alignment():
    ring = shm_ring.ShmRing(4096, 2)
    try:
        batch = {"a": np.arange(10, dtype=np.float32).reshape(2, 5),
                 "seed": np.asarray(7, np.uint32),
                 "b": np.ones((3,), np.int8)}
        meta = shm_ring.write_batch(ring.buf(1), batch)
        got = shm_ring.read_batch(ring.buf(1), meta)
        for k, v in batch.items():
            assert got[k].shape == v.shape and np.array_equal(got[k], v)
        assert all(off % 64 == 0 for *_, off in meta)
        assert shm_ring.write_batch(ring.buf(0), {
            "x": np.zeros(8192, np.uint8)}) is None
        del got
    finally:
        ring.close()
        ring.close()


def test_prefetch_keeps_order_errors_and_stops_early():
    assert list(tpipe.prefetch(iter(range(10)), size=3)) == list(range(10))

    def boom():
        yield 1
        raise ValueError("upstream")

    it = tpipe.prefetch(boom(), size=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="upstream"):
        next(it)
    consumed = []

    def slow():
        for i in range(1000):
            consumed.append(i)
            yield i

    it = tpipe.prefetch(slow(), size=2)
    assert next(it) == 0
    it.close()
    assert len(consumed) < 10


def test_placement_copies_ring_views():
    """A borrowed view (OWNDATA false, as the mp loader's ring batches
    are) is copied before placement; owned arrays are not."""
    base = np.arange(12, dtype=np.float32)
    view = base[2:8]
    t = tpipe.place_array(view, "cpu")
    base[:] = -1
    assert torch.equal(t, torch.arange(2, 8, dtype=torch.float32))
    owned = np.arange(4, dtype=np.int32)
    assert tpipe.place_array(owned, "cpu").data_ptr() == \
        owned.__array_interface__["data"][0]


def test_prefetch_to_device_places_and_augments_on_the_cpu():
    seen = []

    def augment(batch, seed):
        seen.append(seed)
        return {**batch, "image": batch["image"] + 1}

    batches = [{"image": np.full((2, 3), i, np.float32),
                "augment_seed": np.asarray(100 + i, np.uint32)}
               for i in range(4)]
    out = list(tpipe.prefetch_to_device(iter(batches), "cpu",
                                        augment=augment))
    assert [float(b["image"][0, 0]) for b in out] == [1.0, 2.0, 3.0, 4.0]
    assert seen == [100, 101, 102, 103]
    assert all(isinstance(b["image"], torch.Tensor) and
               "augment_seed" not in b for b in out)


def test_augment_seed_wiring_errors():
    with pytest.raises(EdlDataError, match="no device augment"):
        tpipe.pop_augment_seed({"x": 1, "augment_seed": 3}, None)
    with pytest.raises(EdlDataError, match="emit_batch_seed"):
        tpipe.pop_augment_seed({"x": 1}, lambda b, s: b)
    batch, seed = tpipe.pop_augment_seed(
        {"x": 1, "augment_seed": np.asarray(5, np.uint32)}, lambda b, s: b)
    assert batch == {"x": 1} and seed == 5


def test_the_loop_places_and_augments_host_batches():
    """TrainLoop(augment_fn=...) pops each host batch's seed, places it
    and augments it, inline and with prefetch_batches."""
    src = ArraySource(arrays(n=16))
    for prefetch in (0, 2):
        seen = []

        def step(state, batch):
            seen.append((tuple(sorted(batch)), batch["image"].dtype))
            return state, {"loss": torch.zeros(())}

        loader = tpipe.DataLoader(src, 4, seed=0, emit_batch_seed=True)
        loop = TrainLoop(step, object(), device="cpu",
                         config=LoopConfig(prefetch_batches=prefetch),
                         augment_fn=lambda b, s: {**b, "image":
                                                  b["image"].float()})
        loop.run(loader)
        assert seen == [(("image", "label"), torch.float32)] * 4
