"""The port's elastic launcher components (edl_tpu_torch.collective) on
the port's InMemStore, no processes: the cases of tests/test_collective.py,
the cluster document and the trainer env block byte for byte the JAX
package's, a launcher run through every restart reason with a fake
trainer, and the launcher's live branch (EDL_TPU_RESIZE_P2P=1, the
default): ``wait_adopted`` and a trainer that never adopts, released as
a donor and reaped at its deadline.
"""

import dataclasses
import json
import os
import sys
import threading
import time

import pytest

from edl_tpu.collective import cluster as jax_cluster
from edl_tpu.collective import job_env as jax_job_env
from edl_tpu_torch.collective import barrier as bar
from edl_tpu_torch.collective import cluster as port_cluster
from edl_tpu_torch.collective import launch
from edl_tpu_torch.collective import migration as mig
from edl_tpu_torch.collective import register as reg
from edl_tpu_torch.collective.cluster import Cluster, Pod, form_cluster
from edl_tpu_torch.collective.job_env import (JobEnv, TrainerEnv,
                                              slice_of_rank, trainer_environ)
from edl_tpu_torch.collective.watcher import ClusterWatcher
from edl_tpu_torch.coord.store import InMemStore
from edl_tpu_torch.utils import config

JOB = "testjob"


def make_pod(i: int, **kw) -> Pod:
    kw.setdefault("addr", "127.0.0.1")
    kw.setdefault("port", 20000 + i)
    return Pod(pod_id=f"pod{i}", **kw)


def test_cluster_round_trip_and_ranks():
    pods = [make_pod(2, claimed_rank=7), make_pod(1, claimed_rank=3)]
    c = form_cluster(JOB, 1, pods)
    assert [p.pod_id for p in c.pods] == ["pod1", "pod2"]  # by claimed rank
    assert [p.rank for p in c.pods] == [0, 1]              # dense
    c2 = Cluster.from_json(c.to_json())
    assert c2.pod_ids() == {"pod1", "pod2"}
    assert c2.rank_of("pod2") == 1
    assert c2.coordinator == "127.0.0.1:20001"
    assert c2.same_membership(c)


def test_rank_claim_smallest_free_slot():
    store = InMemStore()
    r0 = reg.PodRegister(store, JOB, make_pod(0), ttl=5.0)
    r1 = reg.PodRegister(store, JOB, make_pod(1), ttl=5.0)
    assert r0.claim() == 0
    assert r1.claim() == 1
    r0.release()
    r2 = reg.PodRegister(store, JOB, make_pod(2), ttl=5.0)
    assert r2.claim() == 0  # hole filled
    for r in (r1, r2):
        r.release()


def test_rank_claim_concurrent_unique():
    store = InMemStore()
    results, regs = [], []

    def claim(i):
        r = reg.PodRegister(store, JOB, make_pod(i), ttl=5.0)
        results.append(r.claim())
        regs.append(r)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(6)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert sorted(results) == list(range(6))
    [r.release() for r in regs]


def test_claim_expires_on_lease_timeout():
    store = InMemStore()
    r0 = reg.PodRegister(store, JOB, make_pod(0), ttl=0.3)
    r0.claim()
    r0._keeper.stop(revoke=False)  # simulate pod death (no keepalive)
    time.sleep(0.7)
    pods, _ = reg.live_pods(store, JOB)
    assert pods == []


def test_barrier_three_pods_one_leader():
    store = InMemStore()
    regs = []
    for i in range(3):
        r = reg.PodRegister(store, JOB, make_pod(i), ttl=5.0)
        r.claim()
        regs.append(r)
    out = {}

    def wait(i):
        out[i] = bar.cluster_barrier(store, JOB, f"pod{i}",
                                     stable_secs=0.2, timeout=10.0)

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(3)]
    [t.start() for t in threads]
    [t.join(15.0) for t in threads]
    assert len(out) == 3
    versions = {c.version for c in out.values()}
    assert versions == {1}
    assert all(c.world_size == 3 for c in out.values())
    ranks = sorted(out[i].rank_of(f"pod{i}") for i in range(3))
    assert ranks == [0, 1, 2]
    [r.release() for r in regs]


def test_barrier_resize_bumps_version():
    store = InMemStore()
    regs = [reg.PodRegister(store, JOB, make_pod(i), ttl=5.0)
            for i in range(2)]
    [r.claim() for r in regs]
    c1 = bar.cluster_barrier(store, JOB, "pod0", stable_secs=0.1,
                             timeout=10.0)
    assert c1.version == 1 and c1.world_size == 2

    regs[1].release()  # pod1 departs
    c2 = bar.cluster_barrier(store, JOB, "pod0", after_version=c1.version,
                             stable_secs=0.1, timeout=10.0)
    assert c2.version == 2
    assert c2.pod_ids() == {"pod0"}
    assert c2.rank_of("pod0") == 0
    regs[0].release()


def test_barrier_waits_for_min_nodes():
    store = InMemStore()
    r = reg.PodRegister(store, JOB, make_pod(0), ttl=5.0)
    r.claim()
    with pytest.raises(Exception):
        bar.cluster_barrier(store, JOB, "pod0", min_nodes=2,
                            stable_secs=0.1, timeout=1.0)
    r.release()


def test_watcher_fires_on_change():
    store = InMemStore()
    regs = [reg.PodRegister(store, JOB, make_pod(i), ttl=5.0)
            for i in range(2)]
    [r.claim() for r in regs]
    cluster = bar.cluster_barrier(store, JOB, "pod0", stable_secs=0.1,
                                  timeout=10.0)
    w = ClusterWatcher(store, cluster, interval=0.1).start()
    assert not w.changed.wait(0.4)
    regs[1].release()
    assert w.changed.wait(3.0)
    w.stop()
    regs[0].release()


def test_watcher_fires_on_new_generation_without_membership_blip():
    # A pod that crashes and rejoins between two watcher polls produces no
    # membership diff; peers must still notice the new cluster generation.
    store = InMemStore()
    regs = [reg.PodRegister(store, JOB, make_pod(i), ttl=5.0)
            for i in range(2)]
    [r.claim() for r in regs]
    cluster = bar.cluster_barrier(store, JOB, "pod0", stable_secs=0.1,
                                  timeout=10.0)
    w = ClusterWatcher(store, cluster, interval=0.1).start()
    assert not w.changed.wait(0.4)
    # Same membership, newer version published (as the rejoined pod's
    # barrier would do).
    pods, _ = reg.live_pods(store, JOB)
    nxt = form_cluster(JOB, cluster.version + 1, pods)
    store.put(reg.cluster_key(JOB), nxt.to_json())
    assert w.changed.wait(3.0)
    w.stop()
    [r.release() for r in regs]


def test_trainer_environ_round_trip(monkeypatch):
    pods = [make_pod(0, claimed_rank=0, n_devices=4),
            make_pod(1, claimed_rank=1, n_devices=4)]
    cluster = form_cluster(JOB, 3, pods)
    job = JobEnv(job_id=JOB, checkpoint_path="/tmp/ckpt",
                 store_endpoints="127.0.0.1:2379")
    env = trainer_environ(cluster, "pod1", job)
    for k, v in env.items():
        if k.startswith("EDL_TPU_"):
            monkeypatch.setenv(k, v)
    te = TrainerEnv.from_environ()
    assert te.rank == 1 and te.world_size == 2
    assert te.coordinator == "127.0.0.1:20000"
    assert te.cluster_version == 3
    assert te.cluster.n_devices == 8
    assert not te.is_leader
    assert te.checkpoint_path == "/tmp/ckpt"


def test_job_env_nodes_range(monkeypatch):
    monkeypatch.setenv("EDL_TPU_NODES_RANGE", "2:8")
    job = JobEnv.from_environ()
    assert (job.min_nodes, job.max_nodes) == (2, 8)
    assert job.pod_id  # auto-generated


# -- byte for byte the JAX package's -----------------------------------------

def _pods(mod, n=3):
    return [mod.Pod(pod_id=f"pod{i}", addr=f"10.0.0.{i}", port=20000 + i,
                    n_devices=1 + i % 2, claimed_rank=(7 * i + 3) % 5)
            for i in range(n)]


@pytest.mark.parametrize("n", [1, 3])
def test_cluster_json_is_the_jax_package_s(n):
    ours = form_cluster(JOB, 4, _pods(port_cluster, n))
    theirs = jax_cluster.form_cluster(JOB, 4, _pods(jax_cluster, n))
    assert ours.to_json() == theirs.to_json()
    assert ours.pods[0].to_json() == theirs.pods[0].to_json()
    back = Cluster.from_json(theirs.to_json())
    assert back.to_json() == theirs.to_json() and back.coordinator == \
        theirs.coordinator


@pytest.mark.parametrize("slices", [0, 3])
def test_trainer_environ_is_the_jax_package_s(monkeypatch, slices):
    monkeypatch.setenv("EDL_TPU_SOMETHING_ELSE", "kept")
    kw = dict(job_id=JOB, pod_id="pod2", checkpoint_path="/tmp/ckpt",
              store_endpoints="10.0.0.9:2379,10.0.0.8:2379", slices=slices)
    ours = trainer_environ(
        form_cluster(JOB, 2, _pods(port_cluster)), "pod2",
        JobEnv(**kw))
    theirs = jax_job_env.trainer_environ(
        jax_cluster.form_cluster(JOB, 2, _pods(jax_cluster)), "pod2",
        jax_job_env.JobEnv(**kw))
    assert ours == theirs
    assert ours["EDL_TPU_SOMETHING_ELSE"] == "kept"


def test_job_env_fields_env_names_and_defaults_are_the_jax_package_s(
        monkeypatch):
    """Every field of the JAX package's JobEnv, in order, under its env
    name and default (``job_server``, EDL_TPU_JOBSERVER, too since the
    job server is ported), each knob declared."""
    for f in dataclasses.fields(jax_job_env.JobEnv):
        monkeypatch.delenv(f.metadata["env"], raising=False)
    ours = dataclasses.fields(JobEnv)
    theirs = dataclasses.fields(jax_job_env.JobEnv)
    assert [(f.name, f.metadata.get("env")) for f in ours] == \
        [(f.name, f.metadata.get("env")) for f in theirs]
    a = dataclasses.asdict(JobEnv(pod_id="p"))
    b = dataclasses.asdict(jax_job_env.JobEnv(pod_id="p"))
    assert a == b
    assert a["resize_p2p"] is True and a["job_server"] == ""
    assert {f.metadata["env"] for f in ours} <= set(config.ENV_VARS)
    for rank, world, n in ((0, 4, 2), (3, 4, 2), (0, 2, 4), (1, 1, 0)):
        assert slice_of_rank(rank, world, n) == \
            jax_job_env.slice_of_rank(rank, world, n)


# -- the launcher -------------------------------------------------------------

def test_wait_adopted_takes_only_an_adoption_at_the_generation():
    """True only for an "adopted" ack at the awaited generation or later;
    a restore ack or an older generation times out into False, and an ack
    that lands while the launcher waits wakes it."""
    store = InMemStore()
    key = mig.ack_key(JOB, "pod0")
    assert not mig.wait_adopted(store, JOB, "pod0", 3, timeout=0.3)
    for doc in ({"mode": "peers", "generation": 3},
                {"mode": "adopted", "generation": 2}):
        store.put(key, json.dumps(doc))
        assert not mig.wait_adopted(store, JOB, "pod0", 3, timeout=0.3)
    timer = threading.Timer(0.2, store.put, (key, json.dumps(
        {"mode": "adopted", "generation": 4})))
    timer.start()
    t0 = time.monotonic()
    assert mig.wait_adopted(store, JOB, "pod0", 3, timeout=10.0)
    assert time.monotonic() - t0 < 3.0
    timer.join()


def test_wait_adopted_gives_up_at_once_on_a_dead_trainer():
    t0 = time.monotonic()
    assert not mig.wait_adopted(InMemStore(), JOB, "pod0", 1, timeout=30.0,
                                is_alive=lambda: False)
    assert time.monotonic() - t0 < 2.0


TRAINER_BY_GENERATION = (
    "import os, signal, sys, time\n"
    "v = os.environ['EDL_TPU_CLUSTER_VERSION']\n"
    "open(os.path.join(sys.argv[1], 'v' + v), 'w').write(str(os.getpid()))\n"
    "if v == '1':\n"
    "    signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
    "    time.sleep(120)\n"
    "time.sleep(7)\n")


def _gone_or_zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_unadopting_trainer_is_released_as_a_donor_and_reaped(tmp_path):
    """Live migration on (the default): a second pod joins; the running
    trainer never acks an adoption, so after EDL_TPU_ADOPT_TIMEOUT the
    launcher releases it (SIGTERM, no wait), spawns the new generation's
    trainer at once in the world it has already re-formed, and SIGKILLs
    the old one (which ignores SIGTERM) at its linger deadline
    (EDL_TPU_DONOR_LINGER + 5 s), while the new one still runs."""
    store = InMemStore()
    job = JobEnv(job_id=JOB, pod_id="pod0", barrier_stable_secs=0.1,
                 rejoin_delay_secs=0.1, lease_ttl=5.0,
                 adopt_timeout_secs=0.5, donor_linger_secs=0.2,
                 log_dir=str(tmp_path / "log"))
    assert job.resize_p2p
    trainer = [sys.executable, "-c", TRAINER_BY_GENERATION, str(tmp_path)]
    rc = []
    t = threading.Thread(target=lambda: rc.append(launch.launch(
        job, trainer, store=store, poll=0.05)), daemon=True)
    t.start()
    other = None
    try:
        deadline = time.monotonic() + 30
        while not (tmp_path / "v1").exists():
            assert time.monotonic() < deadline, "first trainer never ran"
            time.sleep(0.05)
        other = reg.PodRegister(store, JOB, make_pod(1), max_nodes=4,
                                ttl=5.0)
        other.claim()
        t.join(timeout=60)
        donor = int((tmp_path / "v1").read_text())
        assert rc == [0] and not t.is_alive()
        assert (tmp_path / "v2").read_text() != str(donor)
        assert _gone_or_zombie(donor), "the lingering donor was never reaped"
    finally:
        if other is not None:
            other.release()
        if (tmp_path / "v1").exists():
            pid = int((tmp_path / "v1").read_text())
            if not _gone_or_zombie(pid):
                os.kill(pid, 9)
    assert store.get(reg.complete_key(JOB)) is not None
    assert bar.read_cluster(store, JOB).world_size == 2
    logs = "".join(p.read_text() for p in (tmp_path / "log").iterdir())
    assert logs.count("==== start rank=") == 2


def test_launcher_runs_to_complete_through_a_crash(tmp_path):
    """launch() in process with a trainer that crashes once, then exits
    0: a crash generation (claim released and re-claimed), then complete;
    the store holds /<job>/complete and no claim."""
    store = InMemStore()
    marker = tmp_path / "crashed"
    trainer = [sys.executable, "-c",
               "import os, sys; p = sys.argv[1]\n"
               "if not os.path.exists(p):\n"
               "    open(p, 'w').close(); sys.exit(3)\n"
               "print(os.environ['EDL_TPU_CLUSTER_VERSION'])", str(marker)]
    job = JobEnv(job_id=JOB, pod_id="solo", resize_p2p=False,
                 barrier_stable_secs=0.1, rejoin_delay_secs=0.1,
                 lease_ttl=5.0, log_dir=str(tmp_path / "log"))
    assert launch.launch(job, trainer, store=store, poll=0.05) == 0
    assert store.get(reg.complete_key(JOB)) is not None
    assert reg.live_pods(store, JOB)[0] == []
    assert bar.read_cluster(store, JOB).version == 2
    log = (tmp_path / "log" / "workerlog.0").read_text()
    assert log.count("==== start rank=0") == 2 and log.rstrip()[-1] == "2"


def test_launcher_aborts_a_crash_loop(tmp_path):
    store = InMemStore()
    job = JobEnv(job_id=JOB, pod_id="solo", resize_p2p=False,
                 barrier_stable_secs=0.05, rejoin_delay_secs=0.05,
                 log_dir=str(tmp_path / "log"))
    rc = launch.launch(job, [sys.executable, "-c", "raise SystemExit(1)"],
                       store=store, poll=0.05, max_consecutive_crashes=2)
    assert rc == 1 and store.get(reg.complete_key(JOB)) is None
    assert reg.live_pods(store, JOB)[0] == []
