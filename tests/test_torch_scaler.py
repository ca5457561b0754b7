"""The port's autoscaler against the JAX package's: ThroughputPolicy and
FairSharePolicy proposals, SimCluster trajectories, the controller's
journal entries, leader takeover and the measured-downtime feedback.

Decisions are pure Python, so they are held EXACTLY: the same JobView
sequences (drawn from a seeded numpy generator) go into both packages'
policies, and the same utilization script (with the clock injected)
into both controllers, each on its own package's store.
"""

import json
import time

import numpy as np
import pytest

from edl_tpu.collective import job_server as jax_js
from edl_tpu.coord.store import InMemStore as JaxStore
from edl_tpu.scaler import controller as jax_ctl
from edl_tpu.scaler import policy as jax_pol
from edl_tpu.scaler import simulator as jax_sim
from edl_tpu_torch.collective import job_server as pt_js
from edl_tpu_torch.coord.store import InMemStore as PtStore
from edl_tpu_torch.scaler import controller as pt_ctl
from edl_tpu_torch.scaler import policy as pt_pol
from edl_tpu_torch.scaler import simulator as pt_sim

PACKAGES = {"jax": (jax_pol, jax_sim, jax_ctl, jax_js, JaxStore),
            "port": (pt_pol, pt_sim, pt_ctl, pt_js, PtStore)}


def view_script(seed: int, ticks: int = 40, jobs: int = 3):
    """Per tick, one JobView field dict a job, from a seeded generator:
    worlds, rates, freshness and in-flight desireds all vary."""
    rng = np.random.default_rng(seed)
    script = []
    for t in range(ticks):
        views = []
        for j in range(jobs):
            world = int(rng.integers(1, 7))
            desired = world if rng.random() < 0.8 \
                else int(rng.integers(1, 7))
            views.append(dict(job_id=f"j{j}", world_size=world,
                              throughput=float(rng.uniform(20, 400)),
                              min_nodes=1, max_nodes=6,
                              downtime_s=float(rng.choice([0.5, 1.5, 4.0])),
                              generation=t, desired=desired,
                              fresh=bool(rng.random() < 0.85)))
        script.append((10.0 * t, views))
    return script


def drive(pol_mod, policy, script, fair: bool):
    out = []
    for now, fields in script:
        views = [pol_mod.JobView(**f) for f in fields]
        props = policy.decide(views, now)
        for p in props:
            if p.is_resize:
                policy.notify_resized(p.job_id, p.desired, now)
        out.append([(p.job_id, p.current, p.desired, p.reason,
                     p.predicted_gain) for p in props])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["throughput", "fairshare"])
def test_policies_propose_what_the_jax_package_proposes(kind, seed):
    script = view_script(seed)
    runs = []
    for pol_mod, *_ in PACKAGES.values():
        if kind == "throughput":
            policy = pol_mod.ThroughputPolicy(gain_threshold=0.05,
                                              cooldown_s=15.0,
                                              horizon_s=60.0)
        else:
            policy = pol_mod.FairSharePolicy(10, gain_threshold=0.05,
                                             cooldown_s=15.0,
                                             horizon_s=60.0)
        runs.append(drive(pol_mod, policy, script, kind == "fairshare"))
    assert runs[0] == runs[1]
    assert any(p[1] != p[2] for tick in runs[0] for p in tick)


def test_policy_restore_replays_like_the_jax_package():
    entries = [
        {"job_id": "j", "world_size": 1, "throughput": 100.0,
         "fresh": True, "action": "hold", "ts": 960.0},
        {"job_id": "j", "world_size": 2, "throughput": 200.0,
         "fresh": True, "action": "resize", "ts": 995.0}]
    got = []
    for pol_mod, *_ in PACKAGES.values():
        pol = pol_mod.ThroughputPolicy(gain_threshold=0.05, cooldown_s=15.0,
                                       horizon_s=60.0)
        pol.restore(entries)
        view = pol_mod.JobView("j", 2, 200.0, 1, 8, downtime_s=1.0)
        got.append([(p.desired, p.reason) for now in (1000.0, 1060.0)
                    for p in pol.decide([view], now)])
    assert got[0] == got[1] == [(2, "cooldown"), (3, "probe-up")]


CURVES = {"concave": lambda m: m.concave(100, 0.5),
          "flat": lambda m: m.flat(100),
          "knee": lambda m: m.knee(100, 4),
          "linear": lambda m: m.linear(100)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_run_policy_trajectories_equal(curve, seed):
    outs = []
    for pol_mod, sim_mod, *_ in PACKAGES.values():
        sim = sim_mod.SimCluster(
            [sim_mod.SimJob("j", CURVES[curve](sim_mod), 1, 8, nodes=2,
                            noise=0.02),
             sim_mod.SimJob("k", sim_mod.concave(80, 0.3), 1, 8, nodes=5,
                            noise=0.02)],
            tick_s=5.0, downtime_s=1.2, seed=seed)
        single = pol_mod.ThroughputPolicy(gain_threshold=0.05,
                                          cooldown_s=15.0, horizon_s=60.0)
        out = sim_mod.run_policy(sim, single, ticks=150, settle_ticks=50)
        sim2 = sim_mod.SimCluster(
            [sim_mod.SimJob("j", CURVES[curve](sim_mod), 1, 8, nodes=2,
                            noise=0.02),
             sim_mod.SimJob("k", sim_mod.concave(80, 0.3), 1, 8, nodes=5,
                            noise=0.02)],
            tick_s=5.0, downtime_s=1.2, seed=seed)
        fair = sim_mod.run_policy(
            sim2, pol_mod.FairSharePolicy(9, gain_threshold=0.05,
                                          cooldown_s=15.0, horizon_s=60.0),
            ticks=150, settle_ticks=50)
        outs.append((out, {j: s.resize_ticks for j, s in sim.jobs.items()},
                     fair, {j: s.resize_ticks for j, s in sim2.jobs.items()}))
    assert outs[0] == outs[1]
    assert outs[0][1]["j"] or outs[0][1]["k"]


# -- the controller ------------------------------------------------------


def seed_job(pkg, store, job="j1", world=2, rate=120.0, now=None):
    """A live job in the store: rank claims + cluster + fresh util, in
    ``pkg``'s key layout (the packages share it)."""
    if pkg == "jax":
        from edl_tpu.collective.cluster import Cluster, Pod
        from edl_tpu.collective.register import cluster_key, rank_key
        from edl_tpu.coord.collector import util_key
    else:
        from edl_tpu_torch.collective.cluster import Cluster, Pod
        from edl_tpu_torch.collective.register import cluster_key, rank_key
        from edl_tpu_torch.coord.collector import util_key
    now = time.time() if now is None else now
    pods = []
    for i in range(world):
        pod_id = f"pod{i}"
        store.put(rank_key(job, i),
                  Pod(pod_id=pod_id, addr=f"10.0.0.{i}", n_devices=1,
                      claimed_rank=i, rank=i).to_json(),
                  lease=store.lease_grant(30.0))
        store.put(util_key(job, pod_id),
                  json.dumps({"pod_id": pod_id, "step": 10,
                              "examples_per_sec": rate / world,
                              "world_size": world,
                              "published_unix": now}),
                  lease=store.lease_grant(30.0))
        pods.append(Pod(pod_id=pod_id, addr=f"10.0.0.{i}", rank=i))
    store.put(cluster_key(job),
              Cluster(job_id=job, version=world, pods=pods).to_json())


def controller(pkg, store, state, clock, owner="ctl", **kw):
    pol_mod, _, ctl_mod, _, _ = PACKAGES[pkg]
    kw.setdefault("config", ctl_mod.ScalerConfig(
        interval=0.1, cooldown_s=20.0, downtime_s=1.5, staleness_s=30.0,
        min_nodes=state.min_nodes, max_nodes=state.max_nodes,
        leader_ttl=0.5))
    return ctl_mod.ScalerController(
        store, [state.job_id],
        pol_mod.ThroughputPolicy(gain_threshold=0.05, cooldown_s=20.0,
                                 horizon_s=60.0),
        actuate=lambda _job, desired: state.resize(desired),
        clock=clock, owner=owner, **kw)


# per tick: (seconds since t0, the world the job is at, its total rate)
UTIL_SCRIPT = [(0.0, 2, 120.0), (3.0, 2, 120.0), (4.0, 3, 170.0),
               (6.0, 3, 171.0), (26.0, 3, 169.0), (30.0, 4, 181.0),
               (33.0, 4, 182.0), (52.0, 4, 180.0), (60.0, 3, 170.0),
               (62.0, 3, 170.0), (90.0, 3, 171.0), (95.0, 3, 170.5)]


def run_script(pkg, tmp_path):
    *_, js_mod, store_cls = PACKAGES[pkg]
    store = store_cls()
    t0 = 1_700_000_000.0
    now = [t0]
    state = js_mod.JobState("j1", 1, 6, desired=2)
    ctl = controller(pkg, store, state, lambda: now[0], elect=False,
                     journal_path=str(tmp_path / f"{pkg}.jsonl"))
    entries = []
    for dt, world, rate in UTIL_SCRIPT:
        now[0] = t0 + dt
        seed_job(pkg, store, world=world, rate=rate, now=now[0])
        entries += ctl.tick()
    ctl.stop()
    recs, _ = store.get_prefix(ctl_mod_prefix(pkg)("j1"))
    stored = [json.loads(r.value) for r in recs]
    lines = [json.loads(x) for x in
             (tmp_path / f"{pkg}.jsonl").read_text().splitlines()]
    return entries, stored, lines, state.resize_log


def ctl_mod_prefix(pkg):
    return PACKAGES[pkg][2].journal_prefix


def test_controller_journals_what_the_jax_controller_journals(tmp_path):
    """The same utilization script through both controllers, each on its
    own package's store, with the clock injected: the journal entries
    (returned, in the store and in the file) are equal field for field,
    a measured downtime among them."""
    jax_run = run_script("jax", tmp_path)
    port_run = run_script("port", tmp_path)
    assert port_run == jax_run
    entries = port_run[0]
    assert [e["action"] for e in entries].count("resize") >= 2
    assert any(e["observed_downtime_s"] is not None for e in entries)
    assert entries[-1]["downtime_s"] != 1.5


def test_leader_takeover_replays_the_cooldown():
    """Controller A (leader) resizes and dies WITHOUT resigning; B takes
    over after the lease expires, replays A's journal, and honors A's
    cooldown instead of resizing again (the JAX package's handoff case,
    on the port's store, lock and job state)."""
    store = PtStore()
    seed_job("port", store, world=2)
    state = pt_js.JobState("j1", 1, 4, desired=2)
    a = controller("port", store, state, time.time, owner="A")
    b = controller("port", store, state, time.time, owner="B")
    try:
        assert a.election.campaign(timeout=5.0)
        entries = a.tick()
        assert entries and entries[0]["action"] == "resize"
        assert state.desired == 3
        assert b.tick() == []          # B cannot act while A leads
        a.election.lock.abandon()      # A dies: the lease runs out
        assert b.election.campaign(timeout=10.0)
        assert b.is_leader()
        seed_job("port", store, world=3)
        (entry,) = b.tick()
        assert entry["action"] == "hold"
        assert entry["reason"] in ("cooldown", "settling-after-resize")
        assert state.desired == 3 and entry["leader"] == "B"
        recs, _ = store.get_prefix(pt_ctl.journal_prefix("j1"))
        seqs = [json.loads(r.value)["seq"] for r in recs]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    finally:
        a.stop()
        b.stop()


class TestMeasuredDowntimeFeedback:
    def _controller(self, pkg, store, state, clock):
        pol_mod, _, ctl_mod, _, _ = PACKAGES[pkg]
        return ctl_mod.ScalerController(
            store, [state.job_id],
            pol_mod.ThroughputPolicy(gain_threshold=0.05, cooldown_s=1.0,
                                     horizon_s=60.0),
            config=ctl_mod.ScalerConfig(cooldown_s=1.0, downtime_s=1.5,
                                        staleness_s=3600.0),
            actuate=lambda _job, desired: state.resize(desired),
            elect=False, clock=clock)

    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_observed_downtime_replaces_configured_constant(self, pkg):
        """Actuation -> first fresh utilization at the new world closes
        the probe; the EWMA lands in later JobViews and the journal."""
        *_, js_mod, store_cls = PACKAGES[pkg]
        store = store_cls()
        t0 = time.time()
        now = [t0]
        seed_job(pkg, store, world=2, now=t0)
        state = js_mod.JobState("j1", 1, 4, desired=2)
        ctl = self._controller(pkg, store, state, clock=lambda: now[0])
        (entry,) = ctl.tick()
        assert entry["action"] == "resize" and entry["applied"] == 3
        assert entry["downtime_s"] == 1.5
        now[0] = t0 + 0.4
        seed_job(pkg, store, world=3, rate=150.0, now=now[0])
        view = ctl.observe("j1", now=now[0])
        assert view.downtime_s == pytest.approx(0.4, abs=1e-6)
        now[0] = t0 + 1.3
        (entry,) = ctl.tick()
        assert entry["downtime_s"] == pytest.approx(0.4, abs=0.01)
        assert entry["observed_downtime_s"] == pytest.approx(0.4, abs=0.01)
        if pkg == "port":
            assert ctl.downtime_source["j1"] == "probe"
        ctl.stop()

    def test_the_acked_gap_is_the_measured_downtime(self):
        """With the trainers' migration acks in the store, the probe
        takes the worst acked ``downtime_s`` written after the actuation
        (an older ack and an ack without a gap are ignored), and a
        takeover controller's journal replay reseeds it."""
        from edl_tpu_torch.collective import migration as mig
        store = PtStore()
        t0 = time.time()
        now = [t0]
        seed_job("port", store, world=2, now=t0)
        store.put(mig.ack_key("j1", "old"), json.dumps(
            {"pod_id": "old", "mode": "adopted", "ts": t0 - 5.0,
             "downtime_s": 9.0}))
        state = pt_js.JobState("j1", 1, 4, desired=2)
        ctl = self._controller("port", store, state, clock=lambda: now[0])
        (entry,) = ctl.tick()
        assert entry["action"] == "resize"
        for pod, gap in (("pod0", 0.21), ("pod1", 0.08), ("pod2", None)):
            store.put(mig.ack_key("j1", pod), json.dumps(
                {"pod_id": pod, "mode": "adopted" if gap else "peers",
                 "ts": t0 + 0.3, "downtime_s": gap}))
        now[0] = t0 + 2.0
        seed_job("port", store, world=3, rate=150.0, now=now[0])
        assert ctl.observe("j1", now=now[0]).downtime_s == pytest.approx(
            0.21)
        assert ctl.downtime_source["j1"] == "ack"
        now[0] = t0 + 2.5
        (entry,) = ctl.tick()
        assert entry["observed_downtime_s"] == pytest.approx(0.21)
        assert entry["downtime_kind"] == "reform"
        ctl.stop()
        takeover = self._controller("port", store, state,
                                    clock=lambda: now[0])
        takeover._restore_from_journal()
        assert takeover._downtime["j1"] == pytest.approx(0.21)
        assert takeover._downtime_kind[("j1", "reform")] == pytest.approx(
            0.21)
        takeover.stop()

    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_journal_replay_reseeds_measured_downtime(self, pkg):
        *_, js_mod, store_cls = PACKAGES[pkg]
        store = store_cls()
        t0 = time.time()
        now = [t0]
        seed_job(pkg, store, world=2, now=t0)
        state = js_mod.JobState("j1", 1, 4, desired=2)
        ctl = self._controller(pkg, store, state, clock=lambda: now[0])
        ctl.tick()
        now[0] = t0 + 0.5
        seed_job(pkg, store, world=3, rate=150.0, now=now[0])
        ctl.observe("j1", now=now[0])
        now[0] = t0 + 1.6
        ctl.tick()
        ctl.stop()
        takeover = self._controller(pkg, store, state, clock=lambda: now[0])
        takeover._restore_from_journal()
        assert takeover._downtime.get("j1") == pytest.approx(0.5, abs=0.01)
        takeover.stop()

    def test_artifact_downtime_reads_like_the_jax_package(self, tmp_path):
        art = tmp_path / "downtime.json"
        art.write_text(json.dumps({"extras": {
            "elastic_downtime_s": 1.2, "elastic_downtime_p2p_s": 0.06}}))
        art2 = tmp_path / "plain.json"
        art2.write_text(json.dumps({"elastic_downtime_s": 1.2}))
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        for path in (art, art2, bad, tmp_path / "missing.json"):
            assert pt_ctl.artifact_downtime(str(path)) \
                == jax_ctl.artifact_downtime(str(path))
        assert pt_ctl.artifact_downtime(str(art)) == pytest.approx(0.06)
        assert pt_ctl.artifact_downtime(str(art2)) == pytest.approx(1.2)
        cfg = pt_ctl.ScalerConfig(downtime_artifact=str(art))
        state = pt_js.JobState("j1", 1, 4, desired=2)
        ctl = pt_ctl.ScalerController(PtStore(), ["j1"],
                                      pt_pol.ThroughputPolicy(),
                                      config=cfg, elect=False,
                                      actuate=lambda _j, d: state.resize(d))
        assert ctl.observe("j1").downtime_s == pytest.approx(0.06)
        ctl.stop()


def test_journal_retention_and_sequence_continue():
    store = PtStore()
    journal = pt_ctl.DecisionJournal(store, "jx", keep=5)
    for i in range(12):
        journal.append({"job_id": "jx", "action": "hold", "i": i})
    tail = journal.tail()
    assert len(tail) <= 6 and tail[-1]["i"] == 11
    assert pt_ctl.DecisionJournal(store, "jx", keep=5).append(
        {"job_id": "jx", "action": "hold"})["seq"] == 12


def test_scaler_cli_one_tick_against_a_store_server(capsys):
    """``python -m edl_tpu_torch.scaler --once`` against the port's
    store server prints one journal entry per job; ``--server`` with
    several jobs is refused as in the JAX CLI."""
    from edl_tpu_torch.coord.server import StoreServer
    from edl_tpu_torch.scaler.__main__ import main
    srv = StoreServer(port=0, host="127.0.0.1").start()
    try:
        seed_job("port", srv.store, world=2)
        assert main(["--store", f"127.0.0.1:{srv.port}", "--job", "j1",
                     "--once", "--dry-run"]) == 0
        entry = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert entry["job_id"] == "j1" and entry["action"] == "dry-run"
        assert entry["desired"] == 3
    finally:
        srv.stop()
    with pytest.raises(SystemExit) as exc:
        main(["--store", "127.0.0.1:1", "--job", "a", "--job", "b",
              "--server", "127.0.0.1:2"])
    assert exc.value.code == 2
    assert "single job" in capsys.readouterr().err
