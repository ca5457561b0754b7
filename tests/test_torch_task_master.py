"""The port's task dispenser (edl_tpu_torch.data.task_master,
edl_tpu_torch.data.task_loader): the cases of tests/test_task_master.py
against the port, then the two packages together. The task records are
the same bytes through every transition (a fixed clock on both sides),
and one JAX TaskDataLoader and one port TaskDataLoader, on one store
server (either package's) through each package's StoreClient, split an
epoch exactly once: every record is read by one trainer, and every task
is done by one.
"""

import json
import threading
import time

import numpy as np
import pytest

from edl_tpu.coord import client as jclient
from edl_tpu.coord import server as jserver
from edl_tpu.coord.store import InMemStore as JInMemStore
from edl_tpu.data import task_loader as jloader
from edl_tpu.data import task_master as jmaster
from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.coord.server import StoreServer
from edl_tpu_torch.coord.store import InMemStore
from edl_tpu_torch.data import TaskMaster as ExportedTaskMaster
from edl_tpu_torch.data.task_loader import (TaskDataLoader, npz_loader,
                                            text_loader)
from edl_tpu_torch.data.task_master import (EdlTaskError, TaskMaster,
                                            file_list_specs)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def store():
    return InMemStore()


def master(store, owner, clock=None, **kw):
    kw.setdefault("lease_timeout", 10.0)
    return TaskMaster(store, "job", owner, clock=clock or time.time, **kw)


def specs(n):
    return [{"file": f"f{i}"} for i in range(n)]


def test_exported_from_the_data_package():
    assert ExportedTaskMaster is TaskMaster


def test_dispense_finish_epoch_done(store):
    m = master(store, "podA")
    with pytest.raises(EdlTaskError):
        m.get_task()                      # no epoch installed
    assert m.init_epoch(0, specs(3))
    assert not m.init_epoch(0, specs(3))  # idempotent
    seen = []
    while True:
        t = m.get_task()
        if t is None:
            break
        seen.append(t.spec["file"])
        assert m.finished(t)
    assert sorted(seen) == ["f0", "f1", "f2"]
    assert m.counts() == {"todo": 0, "pending": 0, "done": 3, "failed": 0}
    assert m.epoch_done()


def test_new_epoch_replaces_table(store):
    m = master(store, "podA")
    m.init_epoch(0, specs(2))
    assert m.init_epoch(1, specs(4))
    assert m.current_epoch() == 1
    assert m.counts() == {"todo": 4, "pending": 0, "done": 0, "failed": 0}
    assert not m.init_epoch(1, specs(4))
    assert not m.init_epoch(0, specs(2))  # can't go back


def test_lease_timeout_requeue_counts_failure(store):
    clock = Clock()
    a = master(store, "podA", clock, lease_timeout=5.0)
    b = master(store, "podB", clock, lease_timeout=5.0)
    a.init_epoch(0, specs(1))
    ta = a.get_task()
    assert ta is not None
    assert b.get_task() is None          # still leased
    clock.t += 6.0                        # lease expires
    tb = b.get_task()
    assert tb is not None and tb.spec == ta.spec
    assert tb.failures == 1               # timeout counted against the task
    assert b.finished(tb)
    assert not a.finished(ta)             # the dead pod's late finish
    assert b.counts()["done"] == 1


def test_expired_task_fails_past_max(store):
    clock = Clock()
    m = master(store, "podA", clock, lease_timeout=1.0, max_failures=2)
    m.init_epoch(0, specs(1))
    for expected_failures in (0, 1, 2):
        t = m.get_task()
        assert t is not None and t.failures == expected_failures
        clock.t += 2.0  # abandon
    assert m.get_task() is None
    assert m.counts() == {"todo": 0, "pending": 0, "done": 0, "failed": 1}
    assert m.epoch_done()  # failed tasks don't wedge the epoch


def test_errored_requeues_then_fails(store):
    m = master(store, "podA", max_failures=1)
    m.init_epoch(0, specs(1))
    t = m.get_task()
    m.errored(t, "boom")
    assert m.counts()["todo"] == 1
    t = m.get_task()
    assert t.failures == 1
    m.errored(t, "boom again")
    assert m.counts() == {"todo": 0, "pending": 0, "done": 0, "failed": 1}


def test_heartbeat_extends_lease(store):
    clock = Clock()
    a = master(store, "podA", clock, lease_timeout=5.0)
    b = master(store, "podB", clock, lease_timeout=5.0)
    a.init_epoch(0, specs(1))
    t = a.get_task()
    clock.t += 4.0
    assert a.heartbeat(t)
    clock.t += 4.0                        # 8 s in all, the lease renewed
    assert b.get_task() is None
    assert a.finished(t)
    assert not a.heartbeat(t)             # done: the lease is gone


def test_contending_consumers_get_disjoint_tasks(store):
    n = 40
    master(store, "pod0").init_epoch(0, specs(n))
    results = {w: [] for w in range(4)}

    def worker(w):
        m = master(store, f"pod{w}")
        while True:
            t = m.get_task()
            if t is None:
                if m.epoch_done():
                    return
                time.sleep(0.01)
                continue
            if m.finished(t):
                results[w].append(t.spec["file"])

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    got = sum(results.values(), [])
    assert sorted(got) == sorted(s["file"] for s in specs(n))  # exactly once


def test_claims_amortize_prefix_scans(store):
    """N sequential claims do not do N full prefix scans (the claim
    cache)."""
    n = 50
    m = master(store, "pod0")
    m.init_epoch(0, specs(n))
    scans = {"n": 0}
    orig = store.get_prefix

    def counting(prefix):
        if "/task/" in prefix:
            scans["n"] += 1
        return orig(prefix)

    store.get_prefix = counting
    claimed = 0
    while True:
        t = m.get_task()
        if t is None:
            break
        m.finished(t)
        claimed += 1
    assert claimed == n
    assert scans["n"] <= 3, scans["n"]


def test_cache_invalidated_on_new_epoch(store):
    m = master(store, "pod0")
    m.init_epoch(0, specs(4))
    assert m.get_task() is not None  # populates the epoch-0 cache
    m.init_epoch(1, specs(2))
    t = m.get_task()
    assert t is not None and t.epoch == 1  # stale keys never served


@pytest.mark.parametrize("files,kw,want", [
    (["a", "b"], {}, [{"file": "a"}, {"file": "b"}]),
    (["a"], {"records_per_task": 4, "counts": [10]},
     [{"file": "a", "start": 0, "stop": 4},
      {"file": "a", "start": 4, "stop": 8},
      {"file": "a", "start": 8, "stop": 10}])])
def test_file_list_specs_equal_the_jax_packages(files, kw, want):
    assert file_list_specs(files, **kw) == want
    assert jmaster.file_list_specs(files, **kw) == want


# -- TaskDataLoader over real files -----------------------------------------

def write_npz_dataset(tmp_path, n_files=4, rows=8):
    files = []
    for i in range(n_files):
        path = tmp_path / f"shard{i}.npz"
        np.savez(path,
                 x=np.arange(i * rows, (i + 1) * rows, dtype=np.int64),
                 y=np.full((rows,), i, dtype=np.int32))
        files.append(str(path))
    return files


@pytest.mark.parametrize("drop_remainder,sizes", [
    (False, [3, 3, 2] * 4), (True, [3, 3] * 4)])
def test_task_loader_consumes_all_records_exactly_once(
        tmp_path, store, drop_remainder, sizes):
    files = write_npz_dataset(tmp_path)
    m = master(store, "podA")
    m.init_epoch(0, file_list_specs(files))
    loader = TaskDataLoader(m, npz_loader, batch_size=3,
                            drop_remainder=drop_remainder)
    batches = list(loader.epoch(0))
    assert sorted(len(b["x"]) for b in batches) == sorted(sizes)
    seen = np.concatenate([b["x"] for b in batches])
    if drop_remainder:   # each file's last 2 rows dropped
        want = [r for r in range(32) if r % 8 < 6]
    else:
        want = list(range(32))
    assert sorted(seen.tolist()) == want
    assert loader.tasks_completed == 4 and loader.tasks_lost == 0
    assert m.epoch_done()


def test_task_loader_seeded_transforms_and_record_ranges(tmp_path, store):
    """The in-task transforms get the epoch's seeded rng; record-range
    tasks load only their rows."""
    files = write_npz_dataset(tmp_path, n_files=1, rows=8)
    m = master(store, "podA")
    m.init_epoch(0, file_list_specs(files, records_per_task=4, counts=[8]))
    draws = []

    def note(batch, rng):
        draws.append(rng.integers(1 << 30))
        return batch

    loader = TaskDataLoader(m, npz_loader, batch_size=4, transforms=[note],
                            seed=3)
    seen = sorted(np.concatenate([b["x"] for b in loader(0)]).tolist())
    assert seen == list(range(8))
    rng = np.random.default_rng(3 * 1_000_003 + 0)
    assert draws == [rng.integers(1 << 30) for _ in range(2)]


def test_task_loader_errored_task_requeued_and_raised(tmp_path, store):
    m = master(store, "podA")
    m.init_epoch(0, [{"file": str(tmp_path / "missing.npz")}])
    loader = TaskDataLoader(m, npz_loader, batch_size=4)
    with pytest.raises(FileNotFoundError):
        list(loader.epoch(0))
    assert m.counts()["todo"] == 1


def test_text_loader(tmp_path):
    p = tmp_path / "data.txt"
    p.write_bytes(b"r0\nr1\nr2\nr3\n")
    arrays = text_loader({"file": str(p), "start": 1, "stop": 3})
    assert arrays["line"].tolist() == [b"r1", b"r2"]
    want = jloader.text_loader({"file": str(p), "start": 1, "stop": 3})
    assert arrays["line"].tolist() == want["line"].tolist()


def test_killed_pod_shards_redispensed_no_loss_no_double(tmp_path, store):
    """A pod dies holding claimed shards; the survivor re-serves exactly
    those shards after lease expiry."""
    files = write_npz_dataset(tmp_path, n_files=6, rows=4)
    dead = master(store, "dead", lease_timeout=0.5)
    dead.init_epoch(0, file_list_specs(files))
    t1 = dead.get_task()
    t2 = dead.get_task()
    assert t1 is not None and t2 is not None
    survivor = master(store, "live", lease_timeout=0.5)
    loader = TaskDataLoader(survivor, npz_loader, batch_size=4, poll=0.05)
    seen = np.concatenate([b["x"] for b in loader.epoch(0)])
    assert sorted(seen.tolist()) == list(range(24))
    assert loader.tasks_completed == 6
    assert survivor.counts()["done"] == 6
    assert not dead.finished(t1)          # the zombie finish is rejected


def test_lost_lease_stops_the_task_and_counts_it_lost(tmp_path, store):
    """A consumer that stalls past its lease stops yielding the task at
    its next heartbeat and counts it lost, not completed."""
    clock = Clock()
    files = write_npz_dataset(tmp_path, n_files=1, rows=8)
    m = master(store, "slow", clock, lease_timeout=5.0)
    m.init_epoch(0, file_list_specs(files))
    loader = TaskDataLoader(m, npz_loader, batch_size=2, heartbeat_every=0.0)
    it = loader.epoch(0)
    next(it)
    clock.t += 6.0
    other = master(store, "fast", clock, lease_timeout=5.0)
    stolen = other.get_task()
    assert stolen is not None and stolen.failures == 1
    assert other.finished(stolen)
    assert list(it) == []
    assert loader.tasks_lost == 1 and loader.tasks_completed == 0


# -- the two packages together ----------------------------------------------

def _records(store) -> dict[str, str]:
    recs, _ = store.get_prefix("/")
    return {r.key: r.value for r in recs}


def test_task_records_are_the_jax_packages_bytes():
    """The same transitions on a JAX and a port store under one fixed
    clock leave byte-identical records at every step."""
    ours, theirs = InMemStore(), JInMemStore()
    clock = Clock()
    table = file_list_specs(["a.npz", "b.npz"], records_per_task=3,
                            counts=[5, 2])
    t_m = TaskMaster(ours, "j", "pod", clock=clock, lease_timeout=4.0,
                     max_failures=1)
    j_m = jmaster.TaskMaster(theirs, "j", "pod", clock=clock,
                             lease_timeout=4.0, max_failures=1)
    steps = []
    for m in (t_m, j_m):
        m.init_epoch(0, table)
    steps.append((_records(ours), _records(theirs)))
    # claim every task (the set of claims is the same whatever the order)
    tt = [t_m.get_task() for _ in table]
    jt = [j_m.get_task() for _ in table]
    steps.append((_records(ours), _records(theirs)))
    key = {t._key: t for t in tt}
    jkey = {t._key: t for t in jt}
    assert sorted(key) == sorted(jkey)
    first, second, _ = sorted(key)
    clock.t += 1.0
    t_m.heartbeat(key[first])
    j_m.heartbeat(jkey[first])
    t_m.finished(key[first])
    j_m.finished(jkey[first])
    t_m.errored(key[second], "x")
    j_m.errored(jkey[second], "x")
    steps.append((_records(ours), _records(theirs)))
    # the errored task is claimed again; then its lease and the third's
    # expire: one fails (past max_failures), the other is re-claimed
    for _ in range(2):
        clock.t += 10.0
        assert t_m.get_task()._key == j_m.get_task()._key
        steps.append((_records(ours), _records(theirs)))
    for a, b in steps:
        assert a == b
    assert t_m.counts() == j_m.counts()


@pytest.fixture(params=["port_server", "jax_server"])
def store_server(request):
    if request.param == "port_server":
        srv = StoreServer(port=0, host="127.0.0.1", sweep_interval=0.05)
    else:
        srv = jserver.StoreServer(port=0, host="127.0.0.1",
                                  sweep_interval=0.05)
    with srv:
        yield f"127.0.0.1:{srv.port}"


def test_jax_and_port_trainers_split_one_epoch_exactly_once(tmp_path,
                                                            store_server):
    files = write_npz_dataset(tmp_path, n_files=12, rows=8)
    table = file_list_specs(files)
    j_store = jclient.StoreClient(store_server)
    t_store = StoreClient(store_server)
    try:
        j_m = jmaster.TaskMaster(j_store, "mixed", "jax-trainer",
                                 lease_timeout=10.0)
        t_m = TaskMaster(t_store, "mixed", "port-trainer",
                         lease_timeout=10.0)
        assert t_m.init_epoch(0, table)
        assert not j_m.init_epoch(0, table)   # one table, either installs
        def pace(batch, rng):
            # each trainer waits a little per batch, so both take tasks
            time.sleep(0.01)
            return batch

        loaders = {
            "jax": jloader.TaskDataLoader(j_m, jloader.npz_loader, 4,
                                          transforms=[pace], poll=0.05),
            "port": TaskDataLoader(t_m, npz_loader, 4, transforms=[pace],
                                   poll=0.05)}
        rows = {k: [] for k in loaders}

        def run(name):
            for batch in loaders[name].epoch(0):
                rows[name].extend(np.asarray(batch["x"]).tolist())

        threads = [threading.Thread(target=run, args=(k,)) for k in loaders]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert sorted(rows["jax"] + rows["port"]) == list(range(96))
        assert rows["jax"] and rows["port"]       # both trained
        done = (loaders["jax"].tasks_completed
                + loaders["port"].tasks_completed)
        assert done == 12
        assert t_m.counts(0) == j_m.counts(0) == {
            "todo": 0, "pending": 0, "done": 12, "failed": 0}
        owners = {json.loads(r.value)["owner"]
                  for r in t_store.get_prefix("/mixed/data/e0/task/")[0]}
        assert owners == {"jax-trainer", "port-trainer"}
    finally:
        j_store.close()
        t_store.close()
