"""The port's record server and remote source
(edl_tpu_torch.data.data_server): the cases of tests/test_data_server.py
against the port (protocol ops, error frames, garbage bytes, the loader
over a remote source, two ranks over one server, a reconnect after a
bounce), the wire both ways with the JAX package (the port's
RemoteSource against the JAX DataServer, the JAX RemoteSource against the
port's server: batches bitwise the served arrays), and the CLI as its own
process.
"""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from edl_tpu.data import data_server as jds
from edl_tpu.utils.exceptions import EdlDataError as JEdlDataError
from edl_tpu_torch.data import DataServer as ExportedServer
from edl_tpu_torch.data import RemoteSource as ExportedSource
from edl_tpu_torch.data.data_server import DataServer, RemoteSource
from edl_tpu_torch.data.pipeline import ArraySource, DataLoader, FileSource
from edl_tpu_torch.utils.exceptions import EdlDataError

ROOT = Path(__file__).resolve().parent.parent


def _data():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(64, 5)).astype(np.float32),
            "y": np.arange(64, dtype=np.int32),
            "h": rng.normal(size=(64, 2, 3)).astype(np.float16)}


@pytest.fixture
def served():
    data = _data()
    server = DataServer(ArraySource(data), host="127.0.0.1").start()
    yield server, data
    server.stop()


def test_exported_from_the_data_package():
    assert ExportedServer is DataServer and ExportedSource is RemoteSource


def test_len_and_ping(served):
    server, _ = served
    src = RemoteSource(f"127.0.0.1:{server.port}")
    try:
        assert len(src) == 64
        assert src._call({"op": "ping"})[0]["ok"]
        stats = server.stats()
        assert stats["records"] == 64 and stats["requests"] >= 2
    finally:
        src.close()


@pytest.mark.parametrize("bad,match", [
    (np.array([999]), "bad indices"), (np.array([-1]), "bad indices"),
    (np.array([[0, 1]]), "bad indices")])
def test_bad_indices_surface_as_errors(served, bad, match):
    server, _ = served
    src = RemoteSource(f"127.0.0.1:{server.port}")
    try:
        with pytest.raises(EdlDataError, match=match):
            src.batch(bad)
        # the connection is still usable after an error reply
        assert len(src.batch(np.array([0]))["y"]) == 1
    finally:
        src.close()


def test_unknown_op(served):
    server, _ = served
    src = RemoteSource(f"127.0.0.1:{server.port}")
    try:
        with pytest.raises(EdlDataError, match="unknown op"):
            src._call({"op": "nope"})
        with pytest.raises(EdlDataError, match="idx tensor"):
            src._call({"op": "batch"})
    finally:
        src.close()


def test_corrupt_shard_surfaces_as_error(tmp_path):
    """A shard that turns unreadable after indexing comes back as an
    error frame with the server-side cause, not a silent disconnect."""
    p = str(tmp_path / "s.npz")
    np.savez(p, y=np.arange(8, dtype=np.int32))
    src = FileSource([p], cache_files=1)
    with open(p, "wb") as f:
        f.write(b"corrupt")
    server = DataServer(src, host="127.0.0.1").start()
    remote = RemoteSource(f"127.0.0.1:{server.port}")
    try:
        with pytest.raises(EdlDataError, match="BadZipFile|zip|ValueError"):
            remote.batch(np.array([0]))
    finally:
        remote.close()
        server.stop()


def test_garbage_bytes_do_not_kill_server(served):
    server, _ = served
    s = socket.create_connection(("127.0.0.1", server.port))
    s.sendall(b"NOT A FRAME AT ALL")
    s.close()
    src = RemoteSource(f"127.0.0.1:{server.port}")
    try:
        assert len(src) == 64
    finally:
        src.close()


def test_remote_loader_identical_to_local(served):
    server, data = served
    local = DataLoader(ArraySource(data), 16, seed=5)
    remote = DataLoader(RemoteSource(f"127.0.0.1:{server.port}"), 16, seed=5)
    n = 0
    for lb, rb in zip(local.epoch(1), remote.epoch(1)):
        for k in data:
            np.testing.assert_array_equal(lb[k], rb[k])
        n += 1
    assert n == 4


def test_sharded_remote_consumers_partition(served):
    """Two ranks over one server: disjoint shards covering the epoch."""
    server, _ = served
    seen = []

    def consume(rank):
        src = RemoteSource(f"127.0.0.1:{server.port}")
        ld = DataLoader(src, 8, rank=rank, world=2, seed=2)
        seen.append([int(y) for b in ld.epoch(0) for y in b["y"]])
        src.close()

    ts = [threading.Thread(target=consume, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert len(seen) == 2
    a, b = map(set, seen)
    assert a.isdisjoint(b) and len(a | b) == 64


def test_reconnect_after_server_bounce():
    data = {"y": np.arange(16, dtype=np.int32)}
    server = DataServer(ArraySource(data), host="127.0.0.1").start()
    port = server.port
    src = RemoteSource(f"127.0.0.1:{port}")
    assert len(src.batch(np.array([1]))["y"]) == 1
    server.stop()
    server2 = None
    for _ in range(50):  # old connections may hold the port briefly
        try:
            server2 = DataServer(ArraySource(data), host="127.0.0.1",
                                 port=port).start()
            break
        except OSError:
            time.sleep(0.1)
    assert server2 is not None, "could not rebind the port"
    try:
        got = src.batch(np.array([2]))  # the reconnect-and-retry path
        assert int(got["y"][0]) == 2
    finally:
        src.close()
        server2.stop()


def test_a_dead_server_raises_after_one_retry():
    data = {"y": np.arange(4, dtype=np.int32)}
    server = DataServer(ArraySource(data), host="127.0.0.1").start()
    src = RemoteSource(f"127.0.0.1:{server.port}", timeout=2.0)
    assert len(src) == 4
    server.stop()
    with pytest.raises(OSError):
        src.batch(np.array([0]))


# -- the wire both ways with the JAX package ---------------------------------

IDX = np.array([3, 60, 7, 7, 0, 63])


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("jax", "port"), ("port", "jax")])
def test_batches_bitwise_across_the_packages(server_pkg, client_pkg):
    data = _data()
    server_cls = jds.DataServer if server_pkg == "jax" else DataServer
    client_cls = jds.RemoteSource if client_pkg == "jax" else RemoteSource
    server = server_cls(ArraySource(data), host="127.0.0.1").start()
    src = client_cls(f"127.0.0.1:{server.port}")
    try:
        assert len(src) == 64
        got = src.batch(IDX)
        assert sorted(got) == sorted(data)
        for k, v in data.items():
            assert got[k].dtype == v.dtype
            assert got[k].tobytes() == v[IDX].tobytes()
        err = EdlDataError if client_pkg == "port" else JEdlDataError
        with pytest.raises(err, match="unknown op"):
            src._call({"op": "nope"})
        assert len(src.batch(np.array([1]))["y"]) == 1
    finally:
        src.close()
        server.stop()


def test_cli_serves_a_directory_of_shards(tmp_path):
    """``python -m edl_tpu_torch.data.data_server``: the shards of a
    directory in name order, to the JAX package's client too."""
    for i in range(2):
        np.savez(tmp_path / f"part-{i}.npz",
                 y=np.arange(i * 4, i * 4 + 4, dtype=np.int32))
    (tmp_path / "notes.txt").write_text("skipped")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.data.data_server",
         "--data-dir", str(tmp_path), "--host", "127.0.0.1", "--port",
         str(port)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        src = jds.RemoteSource(f"127.0.0.1:{port}", timeout=5.0)
        deadline = time.monotonic() + 60
        while True:
            try:
                n = len(src)
                break
            except OSError:
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.2)
        assert n == 8
        assert src.batch(np.array([7, 0]))["y"].tolist() == [7, 0]
        src.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
