"""Sharded checkpoints: the JAX package's chunk + index format in the port.

A JAX TrainState (ResNetTiny, fused momentum-SGD with fp32 or int8
momentum) is placed on the 8-device CPU mesh that tests/conftest.py sets
up, every leaf whose first axis divides over the mesh sharded along it
(over 4 devices and over 8), and saved by the JAX package's
``CheckpointManager(sharded=True)``: leaves in several chunks. The port
restores it whole, bit for bit, through its own manager into its own
state. A port sharded save (one chunk a leaf, rank 0's) restores in the
JAX package bit for bit, and names its leaves as ``jax.tree_util.keystr``
does. A chunk that fails its crc32 raises ``EdlCheckpointCorrupt``; a
chunk table that leaves a region uncovered raises.
"""

import json
import os

import jax
import numpy as np
import pytest
from flax import serialization as fser
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from edl_tpu.train import checkpoint as jckpt
from edl_tpu.train import sharded_checkpoint as jsc
from edl_tpu.train.state import TrainStatus as JTrainStatus
from edl_tpu_torch import bridge
from edl_tpu_torch.train import sharded_checkpoint as sc
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.serialization import to_state_dict
from edl_tpu_torch.train.state import TrainStatus
from edl_tpu_torch.utils.exceptions import EdlCheckpointCorrupt
from test_torch_checkpoint import jax_state, leaves_equal, port_state
from test_torch_world import one_torch_thread  # noqa: F401

MODES = ["fp32", "int8"]


@pytest.fixture(scope="module")
def hosts():
    return {m: jax_state("resnet", "sgdm", m) for m in MODES}


def shard_over(host, n: int):
    """``host`` on an n-device mesh: a leaf whose first axis divides by n
    is split along it, any other leaf replicated."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("fsdp",))

    def place(x):
        x = np.asarray(x)
        spec = P("fsdp") if x.ndim and x.shape[0] % n == 0 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, host)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_jax_sharded_save_restores_in_the_port(hosts, mode, n, tmp_path):
    host = hosts[mode]
    placed = shard_over(host, n)
    mgr = jckpt.CheckpointManager(str(tmp_path), sharded=True,
                                  process_index=0)
    mgr.save(placed, JTrainStatus(epoch=0, step=2, world_size=n))
    mgr.close()
    index = json.loads((tmp_path / "ckpt-0" / "index.0.json").read_text())
    assert max(len(leaf["chunks"]) for leaf in index["leaves"]) == n
    raw = sc.restore_state_dict(str(tmp_path / "ckpt-0"))
    assert not leaves_equal(raw, fser.to_state_dict(host))
    state = port_state("resnet", "sgdm", mode, seed=4)
    _, status = CheckpointManager(str(tmp_path)).restore(state)
    assert status.world_size == n and status.step == 2
    assert not leaves_equal(to_state_dict(bridge.state_to_flax(state)),
                            fser.to_state_dict(host))


@pytest.mark.parametrize("mode", MODES)
def test_port_sharded_save_restores_in_jax(hosts, mode, tmp_path):
    host = hosts[mode]
    state = port_state("resnet", "sgdm", mode, seed=4)
    bridge.flax_to_state(fser.to_state_dict(host), state)
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(state, TrainStatus(epoch=0, step=2))
    mgr.close()
    meta = json.loads((tmp_path / "ckpt-0" / "meta.json").read_text())
    assert meta["format"] == "sharded"
    got, status = jckpt.CheckpointManager(
        str(tmp_path), process_index=0).restore(
            jax_state("resnet", "sgdm", mode, steps=0))
    assert status.step == 2
    assert not leaves_equal(fser.to_state_dict(got),
                            fser.to_state_dict(host))


@pytest.mark.parametrize("mode", MODES)
def test_leaf_keys_are_jax_keystr(hosts, mode, tmp_path):
    """The port's chunk table names and orders its leaves as the JAX
    package's (``jax.tree_util.keystr`` in flatten order)."""
    host = hosts[mode]
    jsc.save_sharded(str(tmp_path / "j"), host)
    want = [leaf["key"] for leaf in json.loads(
        (tmp_path / "j" / "index.0.json").read_text())["leaves"]]
    state = port_state("resnet", "sgdm", mode)
    bridge.flax_to_state(fser.to_state_dict(host), state)
    got = [k for k, _ in sc.keyed_leaves(bridge.state_to_flax(state))]
    assert got == want
    sc.save_tree(str(tmp_path / "t"), bridge.state_to_flax(state))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))


@pytest.mark.parametrize("key,path", [
    (".step", ("step",)),
    (".params['Dense_0']['kernel']", ("params", "Dense_0", "kernel")),
    (".opt_state.m[12].q", ("opt_state", "m", "12", "q")),
    (".opt_state[1][0].trace['a']", ("opt_state", "1", "0", "trace", "a")),
    ('.x["k"]', ("x", "k"))])
def test_key_paths(key, path):
    assert sc.key_path(key) == path


@pytest.mark.parametrize("key", ["", "params", ".a[", ".a]['b']", "[x]"])
def test_bad_keys_raise(key):
    with pytest.raises(ValueError):
        sc.key_path(key)


def test_a_corrupt_chunk_raises(hosts, tmp_path):
    jsc.save_sharded(str(tmp_path), shard_over(hosts["fp32"], 4))
    chunk = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npy"))[5]
    raw = bytearray((tmp_path / chunk).read_bytes())
    raw[-2] ^= 0x10
    (tmp_path / chunk).write_bytes(bytes(raw))
    with pytest.raises(EdlCheckpointCorrupt, match=chunk):
        sc.restore_state_dict(str(tmp_path))


def test_incomplete_coverage_raises(hosts, tmp_path):
    jsc.save_sharded(str(tmp_path), shard_over(hosts["fp32"], 4))
    index = json.loads((tmp_path / "index.0.json").read_text())
    leaf = next(x for x in index["leaves"] if len(x["chunks"]) == 4)
    leaf["chunks"].pop(2)
    (tmp_path / "index.0.json").write_text(json.dumps(index))
    with pytest.raises(ValueError, match="unwritten"):
        sc.restore_state_dict(str(tmp_path), threads=1)
