"""Peer-to-peer state migration in the port (edl_tpu_torch.collective.
migration): the cases of tests/test_state_migration.py and, across the
packages, both directions on bridged weights.

- A state restored from a live donor over the tensor wire is bit for bit
  the same version restored from disk, replicated and sharded format,
  fp32 and int8 momentum (ResNetTiny's port TrainState).
- Across the packages: the port's ``restore_from_peers`` assembles a
  JAX package donor's sealed snapshot (replicated, and sharded over 4
  and 8 CPU devices) into the port's state, equal bit for bit to the
  bridged JAX state; the JAX package's ``restore_from_peers`` assembles a
  port donor's snapshot into the JAX state, equal bit for bit.
- Every failure degrades to the disk path: a donor dying mid-transfer, a
  chunk garbled on the wire, a TrainLoop whose migration plane fails,
  stale donors fenced by the local disk version, a donor resealing
  mid-restore, no donors, mismatched leaf shapes.
- Sealed retention: the newest sealed save is served, an older one
  handed out stays intact across the next seal; sync and sharded saves
  retain too.
- ``publish_resize_epoch``'s document is the JAX package's; the
  ``UtilizationPublisher`` record written through the port's store server
  is read by the JAX package's client as its ``Collector`` parses it.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch
from flax import serialization as fser

from edl_tpu.collective import migration as jmig
from edl_tpu.coord import client as jclient
from edl_tpu.coord.collector import Collector
from edl_tpu.train import checkpoint as jckpt
from edl_tpu.train.state import TrainStatus as JTrainStatus
from edl_tpu_torch import bridge
from edl_tpu_torch.collective import migration as mig
from edl_tpu_torch.collective import register as reg
from edl_tpu_torch.collective.cluster import Pod
from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.coord.collector import UtilizationPublisher, util_key
from edl_tpu_torch.coord.server import StoreServer
from edl_tpu_torch.coord.store import InMemStore
from edl_tpu_torch.train import ckpt_io
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
from edl_tpu_torch.train.serialization import to_state_dict
from edl_tpu_torch.train.state import TrainStatus
from test_torch_checkpoint import (_train, jax_state, leaves_equal,
                                   port_batch, port_state)
from test_torch_sharded_checkpoint import shard_over
from test_torch_world import one_torch_thread  # noqa: F401

JOB = "mjob"
MODES = ["fp32", "int8"]


def wait_until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    pytest.fail(f"timeout waiting for {what}")


def make_service(store, ckpt=None, pod="pod0"):
    svc = mig.MigrationService(store, JOB, pod, addr="127.0.0.1")
    if ckpt is not None:
        svc.attach(ckpt)
    return svc


def flax_of(state) -> dict:
    return to_state_dict(bridge.state_to_flax(state))


def trained(mode: str, seed: int = 0):
    return _train(port_state("resnet", "sgdm", mode, seed), steps=2,
                  seed=seed)


@pytest.fixture(scope="module")
def hosts():
    return {m: jax_state("resnet", "sgdm", m) for m in MODES}


# -- peer restore == disk restore ---------------------------------------------


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated",
                                                        "sharded"])
@pytest.mark.parametrize("mode", MODES)
def test_peer_restore_is_the_disk_restore_bit_for_bit(mode, sharded,
                                                      tmp_path):
    store = InMemStore()
    mgr = CheckpointManager(str(tmp_path / "c"), sharded=sharded)
    svc = make_service(store, mgr)
    try:
        state = trained(mode)
        mgr.save(state, TrainStatus(epoch=2, step=41, step_in_epoch=3))
        wait_until(lambda: mig.live_donors(store, JOB), what="donor advert")
        [advert] = mig.live_donors(store, JOB)
        peer, pstatus, stats = mig.restore_from_peers(
            store, JOB, port_state("resnet", "sgdm", mode, seed=5))
        disk, dstatus = mgr.restore(port_state("resnet", "sgdm", mode,
                                               seed=6))
        assert not leaves_equal(flax_of(peer), flax_of(disk))
        assert not leaves_equal(flax_of(peer), flax_of(state))
        assert pstatus.to_dict() == dstatus.to_dict()
        assert stats["bytes_from_peers"] == advert["nbytes"] > 0
        assert stats["version"] == advert["version"] == 0
        assert stats["donors"] == ["pod0"]
    finally:
        svc.shutdown(linger=False)


def test_a_failed_peer_restore_leaves_the_target_as_it_was(tmp_path):
    """Nothing is written into the target until every chunk has arrived:
    a donor dying mid-transfer leaves the live state untouched."""
    store = InMemStore()
    server = _FetchDropsServer(host="127.0.0.1")
    try:
        publish_donor(store, server, serveable(trained("fp32")))
        target = port_state("resnet", "sgdm", "fp32", seed=9)
        before = flax_of(target)
        with pytest.raises(mig.PeerRestoreError):
            mig.restore_from_peers(store, JOB, target)
        assert not leaves_equal(flax_of(target), before)
    finally:
        server.stop()


# -- across the packages --------------------------------------------------------


@pytest.mark.parametrize("n", [0, 4, 8], ids=["replicated", "sharded4",
                                              "sharded8"])
@pytest.mark.parametrize("mode", MODES)
def test_port_restores_from_a_jax_package_donor(hosts, mode, n, tmp_path):
    """The JAX package's MigrationService serves its sealed snapshot (a
    replicated save, or a save sharded over n devices: several chunks a
    leaf); the port assembles it into its state bit for bit."""
    host = hosts[mode]
    store = InMemStore()
    jmgr = jckpt.CheckpointManager(str(tmp_path / "j"), process_index=0,
                                   sharded=bool(n))
    jsvc = jmig.MigrationService(store, JOB, "jpod", addr="127.0.0.1")
    jsvc.attach(jmgr)
    try:
        jmgr.save(shard_over(host, n) if n else host,
                  JTrainStatus(epoch=1, step=2, step_in_epoch=0,
                               samples_seen=16, world_size=max(n, 1)))
        wait_until(lambda: mig.live_donors(store, JOB), what="JAX advert")
        state = port_state("resnet", "sgdm", mode, seed=4)
        got, status, stats = mig.restore_from_peers(store, JOB, state)
        assert got is state
        assert not leaves_equal(flax_of(state), fser.to_state_dict(host))
        assert status.to_dict() == {"epoch": 1, "step": 2,
                                    "step_in_epoch": 0, "samples_seen": 16,
                                    "world_size": max(n, 1)}
        assert stats["bytes_from_peers"] \
            == mig.live_donors(store, JOB)[0]["nbytes"] > 0
    finally:
        jsvc.shutdown(linger=False)


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated",
                                                        "sharded"])
@pytest.mark.parametrize("mode", MODES)
def test_jax_package_restores_from_a_port_donor(hosts, mode, sharded,
                                                tmp_path):
    """The port's donor serves the bridged state; the JAX package's
    restore_from_peers assembles the JAX state from it bit for bit."""
    host = hosts[mode]
    state = port_state("resnet", "sgdm", mode, seed=4)
    bridge.flax_to_state(fser.to_state_dict(host), state)
    store = InMemStore()
    mgr = CheckpointManager(str(tmp_path / "c"), sharded=sharded)
    svc = make_service(store, mgr)
    try:
        mgr.save(state, TrainStatus(epoch=0, step=2, step_in_epoch=2))
        wait_until(lambda: jmig.live_donors(store, JOB), what="advert")
        got, status, stats = jmig.restore_from_peers(
            store, JOB, jax_state("resnet", "sgdm", mode, steps=0))
        assert not leaves_equal(fser.to_state_dict(got),
                                fser.to_state_dict(host))
        assert status.step == 2 and status.step_in_epoch == 2
        assert stats["bytes_from_peers"] > 0
    finally:
        svc.shutdown(linger=False)


# -- fallback and fencing -------------------------------------------------------


class _FetchDropsServer(mig.MigrationServer):
    """A donor that dies mid-transfer: the manifest, then the connection
    dropped on the first chunk fetch."""

    def _handle(self, conn, meta):
        if meta.get("op") == "fetch":
            conn.close()
            raise OSError("donor died mid-transfer")
        super()._handle(conn, meta)


class _ResealsServer(mig.MigrationServer):
    """A donor that seals a NEWER version between manifest and fetch."""

    def _handle(self, conn, meta):
        if meta.get("op") == "fetch":
            newer = dict(self.snapshot())
            newer["version"] = newer["version"] + 1
            self.publish(newer)
        super()._handle(conn, meta)


class _GarblesServer(mig.MigrationServer):
    """A donor whose chunks arrive garbled (their crc32 fails)."""

    def _handle(self, conn, meta):
        if meta.get("op") == "fetch":
            snap = dict(self.snapshot())
            snap["chunks"] = {k: np.ascontiguousarray(v[::-1]) if v.ndim
                              else v for k, v in snap["chunks"].items()}
            self.publish(snap)
        super()._handle(conn, meta)


def publish_donor(store, server, snap, pod="pod0"):
    server.publish(snap)
    store.put(mig.donor_key(JOB, pod), json.dumps(
        {"pod_id": pod, "addr": "127.0.0.1", "port": server.port,
         "version": snap["version"]}))


def serveable(state, version=0, step=9):
    from edl_tpu_torch.train import sharded_checkpoint as sc
    snap = sc.snapshot_host_tree(bridge.state_to_flax(state))
    return {"version": version, "status": TrainStatus(step=step).to_dict(),
            "process_index": 0, "leaves": snap["leaves"],
            "chunks": dict(snap["chunks"])}


def test_donor_death_mid_transfer_falls_back_to_disk(tmp_path):
    store = InMemStore()
    state = trained("fp32")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(state, TrainStatus(step=9))
    server = _FetchDropsServer(host="127.0.0.1")
    try:
        publish_donor(store, server, serveable(state))
        with pytest.raises(mig.PeerRestoreError):
            mig.restore_from_peers(store, JOB, port_state(
                "resnet", "sgdm", "fp32", seed=3))
        disk, status = mgr.restore(port_state("resnet", "sgdm", "fp32",
                                              seed=3))
        assert not leaves_equal(flax_of(disk), flax_of(state))
        assert status.step == 9
    finally:
        server.stop()


def test_a_chunk_garbled_on_the_wire_is_refused(tmp_path):
    store = InMemStore()
    server = _GarblesServer(host="127.0.0.1")
    try:
        publish_donor(store, server, serveable(trained("fp32")))
        with pytest.raises(mig.PeerRestoreError, match="integrity"):
            mig.restore_from_peers(store, JOB, port_state(
                "resnet", "sgdm", "fp32", seed=3))
    finally:
        server.stop()


def test_loop_try_restore_survives_a_peer_failure(tmp_path):
    """TrainLoop.try_restore: a failing migration plane degrades to the
    disk path (restore_source records it)."""
    state = port_state("resnet", "sgdm", "fp32")
    from edl_tpu_torch.train import classification as tcls
    step = tcls.make_classification_step(10, smoothing=0.1)
    batches = [port_batch("resnet", i) for i in range(3)]
    loop = TrainLoop(step, state, device="cpu",
                     config=LoopConfig(num_epochs=1, ckpt_dir=str(tmp_path)))
    loop.run(lambda e: iter(batches))
    loop2 = TrainLoop(step, port_state("resnet", "sgdm", "fp32", seed=2),
                      device="cpu",
                      config=LoopConfig(num_epochs=1,
                                        ckpt_dir=str(tmp_path)))

    class _BrokenMigration:
        def restore_from_peers(self, target, **kw):
            raise mig.PeerRestoreError("no live donors advertised")
    loop2._migration = _BrokenMigration()
    assert loop2.try_restore()
    assert loop2.restore_source == "disk"
    assert loop2.status.step == 3
    assert not leaves_equal(flax_of(loop2.state), flax_of(loop.state))


def test_stale_donors_are_fenced_by_the_local_disk_version(tmp_path):
    store = InMemStore()
    state = trained("fp32")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(state, TrainStatus(step=1))   # ckpt-0
    mgr.save(state, TrainStatus(step=2))   # ckpt-1
    server = mig.MigrationServer(host="127.0.0.1")
    try:
        publish_donor(store, server, serveable(state, version=0))
        with pytest.raises(mig.PeerRestoreError, match="stale"):
            mig.restore_from_peers(
                store, JOB, port_state("resnet", "sgdm", "fp32"),
                local_version=mgr.latest_version())
    finally:
        server.stop()


def test_a_donor_resealing_mid_restore_is_fenced():
    store = InMemStore()
    server = _ResealsServer(host="127.0.0.1")
    try:
        publish_donor(store, server, serveable(trained("fp32"), version=3))
        with pytest.raises(mig.PeerRestoreError, match="mid-restore"):
            mig.restore_from_peers(store, JOB,
                                   port_state("resnet", "sgdm", "fp32"))
    finally:
        server.stop()


def test_no_donors_raises():
    with pytest.raises(mig.PeerRestoreError, match="no live donors"):
        mig.restore_from_peers(InMemStore(), JOB,
                               port_state("resnet", "sgdm", "fp32"))
    with pytest.raises(mig.PeerRestoreError, match="among"):
        mig.restore_from_peers(InMemStore(), JOB,
                               port_state("resnet", "sgdm", "fp32"),
                               pods=["podX"])


def test_mismatched_leaf_shapes_raise():
    t1 = [{"key": "w", "shape": [4], "dtype": "float32", "chunks": []}]
    t2 = [{"key": "w", "shape": [8], "dtype": "float32", "chunks": []}]
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_io.merge_leaf_tables([t1, t2])
    # a donor of another model: the target refuses it, disk is the path
    store = InMemStore()
    server = mig.MigrationServer(host="127.0.0.1")
    try:
        publish_donor(store, server, serveable(trained("fp32")))
        with pytest.raises(mig.PeerRestoreError):
            mig.restore_from_peers(store, JOB,
                                   port_state("lm", "adam", "fp32"))
    finally:
        server.stop()


# -- sealed retention ------------------------------------------------------------


def test_async_saves_retain_the_newest_sealed_snapshot(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.retain_sealed = True
    state = trained("fp32")
    mgr.save_async(state, TrainStatus(step=1))
    mgr.close()
    snap = mgr.sealed_snapshot()
    assert snap is not None and snap["version"] == 0
    assert snap["status"]["step"] == 1
    assert all("crc32" in c for leaf in snap["leaves"]
               for c in leaf["chunks"])
    # a snapshot handed out survives the next seals intact: a retained
    # arena never goes back to the staging pool
    name = snap["leaves"][-1]["chunks"][0]["file"]
    kept = np.array(snap["chunks"][name])
    for i in range(3):
        state = _train(state, steps=1, seed=10 + i)
        mgr.save_async(state, TrainStatus(step=2 + i))
        mgr.close()
    assert mgr.sealed_snapshot()["version"] == 3
    assert np.array_equal(snap["chunks"][name], kept), \
        "an older retained snapshot was overwritten while serveable"
    assert not np.array_equal(mgr.sealed_snapshot()["chunks"][name], kept)


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated",
                                                        "sharded"])
def test_sync_saves_retain_a_copy(sharded, tmp_path):
    mgr = CheckpointManager(str(tmp_path), sharded=sharded)
    mgr.retain_sealed = True
    state = trained("int8")
    mgr.save(state, TrainStatus(step=3))
    snap = mgr.sealed_snapshot()
    assert snap["version"] == 0
    from edl_tpu_torch.train.sharded_checkpoint import snapshot_nbytes
    assert snapshot_nbytes(snap) == sum(
        np.asarray(a).nbytes for a in jax.tree.leaves(flax_of(state)))
    assert mgr.sealed_snapshot() is snap   # built once a seal
    assert CheckpointManager(str(tmp_path / "off")).sealed_snapshot() is None


# -- the resize epoch and the utilization record --------------------------------


def test_resize_epoch_document_is_the_jax_package_s():
    store = InMemStore()
    store.put(mig.donor_key("j", "podA"), json.dumps(
        {"pod_id": "podA", "addr": "127.0.0.1", "port": 1234,
         "version": 5, "generation": 2, "nbytes": 10}))
    ours = mig.publish_resize_epoch(store, "j", epoch=1, desired=3, prev=2)
    theirs = jmig.publish_resize_epoch(store, "j", epoch=1, desired=3,
                                       prev=2)
    ours.pop("ts"), theirs.pop("ts")
    assert ours == theirs == {
        "epoch": 1, "from": 2, "desired": 3,
        "donors": [{"pod_id": "podA", "addr": "127.0.0.1", "port": 1234,
                    "version": 5, "generation": 2}]}
    assert set(json.loads(store.get(mig.epoch_key("j")).value)) \
        == {"epoch", "ts", "from", "desired", "donors"}


def test_utilization_record_reads_in_the_jax_collector():
    """The port's publisher writes through the port's store server; the
    JAX package's client reads the record, and its Collector lists it as
    the pod's utilization."""
    class _Loop:
        class status:
            samples_seen = 128

    with StoreServer(port=0, host="127.0.0.1", sweep_interval=0.05) as srv:
        ours = StoreClient(f"127.0.0.1:{srv.port}", timeout=5.0)
        theirs = jclient.StoreClient(f"127.0.0.1:{srv.port}", timeout=5.0)
        register = reg.PodRegister(ours, "uj", Pod(
            pod_id="podU", addr="127.0.0.1", port=1), max_nodes=2, ttl=5.0)
        register.claim()
        pub = UtilizationPublisher(ours, "uj", "podU", rank=0,
                                   generation=3, world_size=2,
                                   min_interval=0.0)
        try:
            pub(_Loop, 1, 10)
            assert pub.flush(timeout=5.0)
            rec = theirs.get(util_key("uj", "podU"))
            assert rec is not None and rec.lease
            doc = json.loads(rec.value)
            assert {k: doc[k] for k in ("pod_id", "rank", "epoch", "step",
                                        "samples_seen", "world_size",
                                        "generation")} == {
                "pod_id": "podU", "rank": 0, "epoch": 1, "step": 10,
                "samples_seen": 128, "world_size": 2, "generation": 3}
            job = Collector(theirs, "uj").snapshot()["job"]
            assert [p["utilization"] for p in job["pods"]] == [doc]
        finally:
            pub.stop()
            register.release()
            theirs.close()
        # the lease was revoked at stop: the record is gone at once
        assert ours.get(util_key("uj", "podU")) is None
        ours.close()
