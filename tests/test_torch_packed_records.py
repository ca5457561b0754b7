"""Packed pre-decoded records: the port's writer and reader against the
JAX package's.

A file the port packs is byte for byte the file the JAX package packs
from the same shards (and from the same JPEG list, through the same
cv2), each package reads the other's, and the loader streams the same
batches from it in every mode. A truncated or foreign file is refused.
"""

import json
import os

import numpy as np
import pytest

from edl_tpu.data import packed_records as jpr
from edl_tpu.data import pipeline as jpipe
from edl_tpu_torch.data import packed_records as tpr
from edl_tpu_torch.data import pipeline as tpipe
from edl_tpu_torch.utils.exceptions import EdlDataError
from test_torch_mp_loader import assert_streams_equal, copy_stream


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(0)
    files = []
    for i in range(2):
        path = str(d / f"train-{i}.npz")
        np.savez(path,
                 image=rng.integers(0, 256, size=(20, 8, 8, 3),
                                    dtype=np.uint8),
                 label=rng.integers(0, 10, size=20).astype(np.int32),
                 weight=rng.normal(size=(20, 2)).astype(np.float16))
        files.append(path)
    return files


@pytest.mark.parametrize("batch", [7, 64])
def test_packed_file_is_the_jax_package_s(shards, tmp_path, batch):
    ours = str(tmp_path / "ours.pack")
    theirs = str(tmp_path / "theirs.pack")
    info = tpr.pack_npz(shards, ours, batch_size=batch)
    assert info == jpr.pack_npz(shards, theirs, batch_size=batch)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert tpr.read_header(ours) == jpr.read_header(theirs)


def test_each_package_reads_the_other_s(shards, tmp_path):
    ours = str(tmp_path / "ours.pack")
    theirs = str(tmp_path / "theirs.pack")
    tpr.pack_npz(shards, ours)
    jpr.pack_npz(shards, theirs)
    idx = np.array([5, 0, 39, 12, 12])
    want = tpipe.FileSource(shards).batch(idx)
    for src in (tpr.PackedSource(theirs), jpr.PackedSource(ours)):
        got = src.batch(idx)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
            assert got[k].flags["OWNDATA"]
    assert tpr.PackedSource(theirs).fields == jpr.PackedSource(ours).fields


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_streams_over_a_packed_file_match_jax(shards, tmp_path,
                                                     workers):
    path = str(tmp_path / "t.pack")
    tpr.pack_npz(shards, path)
    want = copy_stream(jpipe.DataLoader(
        jpr.PackedSource(path), 8, seed=4, emit_batch_seed=True,
        num_workers=0).epoch(3))
    with tpipe.DataLoader(tpr.PackedSource(path), 8, seed=4,
                          emit_batch_seed=True,
                          num_workers=workers) as ld:
        got = copy_stream(ld.epoch(3))
    assert_streams_equal(want, got)


def test_writer_contract(tmp_path):
    path = str(tmp_path / "w.pack")
    fields = {"x": ((2,), np.float32)}
    with pytest.raises(EdlDataError, match="n > 0"):
        tpr.PackedWriter(path, 0, fields)
    with pytest.raises(EdlDataError, match="fixed-stride"):
        with tpr.PackedWriter(path, 4, fields) as w:
            w.add({"x": np.zeros((2, 3), np.float32)})
    assert not os.path.exists(path)     # an aborted pack leaves nothing
    w = tpr.PackedWriter(path, 4, fields)
    w.add({"x": np.ones((3, 2), np.float32)})
    with pytest.raises(EdlDataError, match="overflow"):
        w.add({"x": np.ones((2, 2), np.float32)})
    with pytest.raises(EdlDataError, match="3/4"):
        w.close()


@pytest.mark.parametrize("damage", ["magic", "truncate", "version"])
def test_damaged_files_are_refused(shards, tmp_path, damage):
    path = str(tmp_path / "d.pack")
    tpr.pack_npz(shards, path)
    raw = bytearray(open(path, "rb").read())
    if damage == "magic":
        raw[:8] = b"NOTAPACK"
    elif damage == "truncate":
        raw = raw[:tpr.HEADER_BLOCK + 100]
    else:
        hlen = int(np.frombuffer(bytes(raw[8:12]), np.uint32)[0])
        header = json.loads(bytes(raw[12:12 + hlen]))
        header["version"] = 2
        blob = json.dumps(header).encode().ljust(hlen)
        raw[12:12 + hlen] = blob[:hlen]
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(EdlDataError):
        tpr.PackedSource(path)


def test_cli_pack_info_and_selftest(shards, tmp_path, capsys):
    out = str(tmp_path / "cli.pack")
    assert tpr.main(["pack", "--out", out, "--npz", *shards]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "n"] == 40
    assert tpr.main(["info", out]) == 0
    assert json.loads(capsys.readouterr().out)["n"] == 40
    assert tpr.main(["selftest"]) == 0
    assert "FAIL" not in capsys.readouterr().out
