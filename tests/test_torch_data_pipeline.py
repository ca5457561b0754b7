"""The port's input pipeline (edl_tpu_torch/data/pipeline.py) against the
JAX package's: for the same files, seed, rank and world, the same
batches bit for bit, epoch after epoch and from a mid-epoch cursor."""

import os

import numpy as np
import pytest

from edl_tpu.data import pipeline as jpipe
from edl_tpu.examples.lm_train import \
    make_synthetic_shards as j_make_synthetic_shards
from edl_tpu_torch.data import pipeline as tpipe
from edl_tpu_torch.examples.lm_train import make_synthetic_shards
from edl_tpu_torch.utils.exceptions import EdlDataError


@pytest.fixture(scope="module")
def shard_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    make_synthetic_shards(str(d), n_files=3, rows=40, seq_len=16, vocab=64,
                          seed=2)
    return sorted(str(d / f) for f in os.listdir(d) if f.startswith("train-"))


def test_synthetic_shards_are_the_jax_packages(shard_files, tmp_path):
    j_make_synthetic_shards(str(tmp_path), n_files=3, rows=40, seq_len=16,
                            vocab=64, seed=2)
    for f in shard_files + [os.path.join(os.path.dirname(shard_files[0]),
                                         "val.npz")]:
        with np.load(f) as a, np.load(tmp_path / os.path.basename(f)) as b:
            assert np.array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("seed", [0, 5])
def test_batches_equal_the_jax_loaders(shard_files, seed, rank, world):
    kw = dict(rank=rank, world=world, seed=seed, num_workers=0)
    mine = tpipe.DataLoader(tpipe.FileSource(shard_files, cache_files=2), 7,
                            **kw)
    theirs = jpipe.DataLoader(jpipe.FileSource(shard_files, cache_files=2),
                              7, **kw)
    assert mine.steps_per_epoch() == theirs.steps_per_epoch() > 0
    for epoch in (0, 1):
        got, want = list(mine.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == mine.steps_per_epoch()
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                       for k in a)
    resumed = list(mine.epoch(1, start_step=2))
    assert all(np.array_equal(a["tokens"], b["tokens"])
               for a, b in zip(resumed, list(theirs.epoch(1))[2:]))


def test_transforms_follow_the_jax_stream(shard_files):
    def flip(batch, rng):
        return {k: v[:, ::-1] if rng.random() < 0.5 else v
                for k, v in batch.items()}

    kw = dict(seed=3, num_workers=0, transforms=[flip])
    mine = tpipe.DataLoader(tpipe.FileSource(shard_files), 9, **kw)
    theirs = jpipe.DataLoader(jpipe.FileSource(shard_files), 9, **kw)
    for a, b in zip(mine.epoch(0), theirs.epoch(0)):
        assert all(np.array_equal(a[k], b[k]) for k in b)


def test_epoch_indices():
    for epoch in range(3):
        assert np.array_equal(tpipe.epoch_indices(50, epoch, seed=4),
                              jpipe.epoch_indices(50, epoch, seed=4))
    assert np.array_equal(tpipe.epoch_indices(5, 0, shuffle=False),
                          np.arange(5))


def test_unported_and_bad_settings_raise(shard_files, monkeypatch):
    src = tpipe.FileSource(shard_files)
    monkeypatch.setenv("EDL_TPU_LOADER_WORKERS", "3")
    assert tpipe.DataLoader(src, 4).num_workers == 3
    with pytest.raises(EdlDataError, match="num_workers"):
        tpipe.DataLoader(src, 4, num_workers=-1)
    with pytest.raises(EdlDataError, match="rank"):
        tpipe.DataLoader(src, 4, rank=2, world=2, num_workers=0)
    with pytest.raises(EdlDataError, match="0 batches"):
        list(tpipe.DataLoader(src, 1000, num_workers=0).epoch(0))
    empty = src.batch(np.array([], dtype=np.int64))
    assert empty["tokens"].shape == (0, 16)


@pytest.mark.parametrize("seed", [0, 5])
def test_image_transforms_match_jax(seed):
    """random_flip_lr and random_crop draw and cut as the JAX loader's
    do: the same generator state gives the same pixels, bit for bit."""
    imgs = np.random.default_rng(9).normal(size=(6, 10, 12, 3)).astype(
        np.float16)
    for jt, tt in ((jpipe.random_flip_lr, tpipe.random_flip_lr),
                   (jpipe.random_crop, tpipe.random_crop)):
        want = jt({"image": imgs, "label": np.arange(6)},
                  np.random.default_rng(seed))
        got = tt({"image": imgs, "label": np.arange(6)},
                 np.random.default_rng(seed))
        assert got["image"].dtype == imgs.dtype
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["label"], want["label"])
