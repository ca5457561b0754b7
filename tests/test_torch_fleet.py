"""The port's fleet simulator (scaler/fleet.py, scaler/fleet_policy.py)
against the JAX package's.

The tournament contract is seed-exact, so the port's tournament on the
JAX package's pinned grid hashes to that package's pinned fingerprint,
and under a ladder read from an artifact every row equals the JAX
package's row. The JAX package's own cases (gang and capacity
invariants, the revocation pass, spot-notice riding, the ladder) are
mirrored on the port, and the CLI runs without torch or numpy.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from edl_tpu_torch.scaler.fleet import (LEGACY, MEASURED, DowntimeLadder,
                                        FleetSim, FleetTrace, run_fleet,
                                        tournament, trace_menu)
from edl_tpu_torch.scaler.fleet_policy import (GreedyRebalancePolicy,
                                               PreemptiveFairSharePolicy,
                                               default_policies)
from edl_tpu_torch.scaler.policy import FairSharePolicy

ROOT = Path(__file__).resolve().parent.parent
KW = dict(cooldown_s=15.0, horizon_s=60.0)
SMALL = dict(n_jobs=24, n_pools=5, ticks=100)

# The JAX package's pinned fingerprint of this grid (tests/test_fleet.py).
PINNED_GRID_FP = \
    "25ca3a601c0cec424613ed3cb2bdf4cf15b578873c1354b22ef61eee81d1a0b3"


def _pinned_tournament():
    return tournament(
        traces=[FleetTrace.generate("pin", 11, spot_fraction=0.25,
                                    **SMALL)],
        ladders=[MEASURED, LEGACY],
        policies={"fair": lambda: FairSharePolicy(1, **KW),
                  "preemptive":
                      lambda: PreemptiveFairSharePolicy(1, **KW)})


def test_tournament_fingerprint_is_the_jax_package_s():
    assert _pinned_tournament()["fingerprint"] == PINNED_GRID_FP


def _artifact(tmp_path):
    art = tmp_path / "ladder.json"
    art.write_text(json.dumps({
        "elastic_downtime_p2p_s": 0.4, "elastic_downtime_multihost_s": 0.9,
        "elastic_downtime_s": 7.5}))
    return str(art)


def test_rows_equal_jax_under_an_artifact_ladder(tmp_path):
    from edl_tpu.scaler import fleet as jfleet
    from edl_tpu.scaler import fleet_policy as jpolicy

    path = _artifact(tmp_path)
    kw = dict(n_jobs=12, n_pools=3, ticks=60)
    ours = tournament(traces=trace_menu(**kw),
                      ladders=[DowntimeLadder.from_artifact(path), LEGACY])
    theirs = jfleet.tournament(
        traces=jfleet.trace_menu(**kw),
        ladders=[jfleet.DowntimeLadder.from_artifact(path), jfleet.LEGACY],
        policies=jpolicy.default_policies())
    assert len(ours["rows"]) == 24
    assert ours["rows"] == theirs["rows"]
    assert ours["fingerprint"] == theirs["fingerprint"]
    assert sum(r["ladder"].startswith("artifact:")
               for r in ours["rows"]) == 12


def test_tournament_same_seed_identical_tables():
    t1, t2 = _pinned_tournament(), _pinned_tournament()
    assert t1["fingerprint"] == t2["fingerprint"]
    assert t1["rows"] == t2["rows"]


def _job_key(spec):
    return (spec.job_id, spec.curve.name, spec.tier, spec.gang,
            spec.min_nodes, spec.max_nodes, spec.arrive_tick,
            spec.depart_tick, spec.noise)


def test_trace_generation_is_seed_exact_and_matches_jax():
    from edl_tpu.scaler.fleet import FleetTrace as JTrace

    a = FleetTrace.generate("t", 3, **SMALL)
    b = FleetTrace.generate("t", 3, **SMALL)
    c = FleetTrace.generate("t", 4, **SMALL)
    j = JTrace.generate("t", 3, **SMALL)
    assert [_job_key(x) for x in a.jobs] == [_job_key(x) for x in b.jobs] \
        == [_job_key(x) for x in j.jobs]
    assert [(p.service, p.tenant, p.slo_p95_ms, p.arrive_tick)
            for p in a.pools] == \
           [(p.service, p.tenant, p.slo_p95_ms, p.arrive_tick)
            for p in j.pools]
    assert [vars(p) for p in a.preemptions] \
        == [vars(p) for p in j.preemptions]
    assert a.preemptions == b.preemptions
    assert [_job_key(x) for x in a.jobs] != [_job_key(x) for x in c.jobs]


def test_gang_legal_allocations_throughout():
    trace = FleetTrace.generate("gang", 5, **SMALL)
    sim = FleetSim(trace)
    run_fleet(sim, PreemptiveFairSharePolicy(sim.capacity(), **KW))
    for job in sim.jobs.values():
        nodes = job.sim.nodes
        assert nodes == 0 or (nodes % job.spec.gang == 0
                              and nodes >= job.spec.min_nodes)


def test_force_evict_enforces_capacity_and_bills_lost_rows():
    trace = FleetTrace.generate("cap", 6, **SMALL)
    sim = FleetSim(trace)
    for _ in range(10):
        sim.tick()
    assert sim.allocated() > 0
    sim._capacity = max(0, sim.allocated() - 5)
    sim._force_evict()
    trainer_nodes = sum(j.sim.nodes for j in sim.jobs.values())
    assert sim.allocated() <= sim.capacity() or trainer_nodes == 0
    assert sim.forced_evictions > 0
    assert sim.downtime_paid_s >= sim.ladder.stop_resume_s
    assert sim.resizes_by_kind["stop-resume"] == sim.forced_evictions
    assert sim.lost_rows > 0
    for job in sim.jobs.values():
        nodes = job.sim.nodes
        assert nodes == 0 or (nodes % job.spec.gang == 0
                              and nodes >= job.spec.min_nodes)


def test_revocation_pass_fires_and_is_tier_ordered():
    trace = FleetTrace.generate("surge", 7, **SMALL)
    policy = PreemptiveFairSharePolicy(1, **KW)
    run_fleet(FleetSim(trace), policy)
    assert policy.stats()["revocations"] > 0
    tiers = {r.get("tier", "batch") for r in policy.revocations
             if r["for"] == "slo"}
    assert tiers <= {"best-effort", "batch"}, tiers


def test_preemptive_beats_fair_share_on_slo_at_goodput():
    trace = FleetTrace.generate("surge", 7, **SMALL)
    base = run_fleet(FleetSim(trace), FairSharePolicy(1, **KW))
    pre = run_fleet(FleetSim(trace), PreemptiveFairSharePolicy(1, **KW))
    assert pre["slo_attainment"] >= base["slo_attainment"]
    assert pre["goodput_rows_per_s"] >= 0.98 * base["goodput_rows_per_s"]


def test_spot_notice_riding_vs_blind_baseline():
    spot = FleetTrace.generate("spot", 9, spot_fraction=0.5, **SMALL)
    blind = run_fleet(FleetSim(spot), FairSharePolicy(1, **KW))
    aware = run_fleet(FleetSim(spot), PreemptiveFairSharePolicy(1, **KW))
    assert blind["forced_evictions"] > 0
    assert aware["forced_evictions"] < blind["forced_evictions"]
    assert aware["notices_ridden"] > blind["notices_ridden"]
    assert aware["lost_rows"] <= blind["lost_rows"]


def test_ladder_classify_and_costs():
    assert MEASURED.classify(4, 2) == "adopt"
    assert MEASURED.classify(2, 4) == "reform"
    assert MEASURED.cost("adopt") < MEASURED.cost("reform") \
        < MEASURED.cost("stop-resume")
    assert LEGACY.cost("adopt") == LEGACY.cost("reform") \
        == LEGACY.cost("stop-resume")


def test_default_ladder_is_the_jax_package_s():
    from edl_tpu.scaler import fleet as jfleet

    for ours, theirs in ((MEASURED, jfleet.MEASURED),
                         (LEGACY, jfleet.LEGACY)):
        assert vars(ours) == vars(theirs)


def test_ladder_from_artifact(tmp_path):
    art = tmp_path / "bench.json"
    art.write_text(json.dumps({"extras": {
        "elastic_downtime_p2p_s": 0.05,
        "elastic_downtime_multihost_s": 0.2,
        "elastic_downtime_s": 1.5}}))
    ladder = DowntimeLadder.from_artifact(str(art))
    assert ladder is not None
    assert ladder.cost("adopt") == pytest.approx(0.05)
    assert ladder.cost("reform") == pytest.approx(0.2)
    assert ladder.cost("stop-resume") == pytest.approx(1.5)
    assert DowntimeLadder.from_artifact(str(tmp_path / "no")) is None
    partial = tmp_path / "partial.json"
    partial.write_text(json.dumps({"elastic_downtime_s": 3.0,
                                   "elastic_downtime_p2p_s": "junk"}))
    ladder = DowntimeLadder.from_artifact(str(partial))
    assert ladder.cost("stop-resume") == 3.0
    assert ladder.cost("adopt") == MEASURED.cost("adopt")
    assert ladder.cost("reform") == MEASURED.cost("reform")


def test_cheap_ladder_flips_a_policy_race():
    policies = default_policies()
    assert {"fair-share", "preemptive-fair-share",
            "greedy-rebalance"} <= set(policies)
    trace = FleetTrace.generate("noisy", 16, noise=0.25, **SMALL)
    greedy_m = run_fleet(FleetSim(trace, ladder=MEASURED),
                         GreedyRebalancePolicy(1, **KW))
    greedy_l = run_fleet(FleetSim(trace, ladder=LEGACY),
                         GreedyRebalancePolicy(1, **KW))
    assert greedy_l["downtime_paid_s"] > greedy_m["downtime_paid_s"]


def test_metrics_shape_and_notice_accounting():
    spot = FleetTrace.generate("spot", 9, spot_fraction=0.5, **SMALL)
    out = run_fleet(FleetSim(spot), PreemptiveFairSharePolicy(1, **KW))
    for key in ("goodput_rows_per_s", "jain_fairness", "slo_attainment",
                "downtime_paid_s", "forced_evictions", "notices_issued",
                "notices_ridden", "lost_rows", "spot_fraction"):
        assert key in out, key
    assert 0.0 < out["jain_fairness"] <= 1.0
    assert 0.0 <= out["slo_attainment"] <= 1.0
    assert out["notices_ridden"] <= out["notices_issued"]


_GUARD = ("import builtins; _imp = builtins.__import__\n"
          "def _no(name, *a, **k):\n"
          "    if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
          "        raise ImportError('imported ' + name)\n"
          "    return _imp(name, *a, **k)\n"
          "builtins.__import__ = _no\n"
          "import runpy, sys; sys.argv = sys.argv[1:]\n"
          "runpy.run_module(sys.argv[0], run_name='__main__')\n")


def _cli(*args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("EDL_TPU_", "PALLAS_"))}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run(
        [sys.executable, "-c", _GUARD, "edl_tpu_torch.scaler.fleet", *args],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=120)


def test_selftest_cli_runs_torch_and_numpy_free():
    out = _cli("selftest")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "fleet selftest: all checks passed" in out.stdout


def test_tournament_cli_reads_the_ladder(tmp_path):
    path = _artifact(tmp_path)
    out = _cli("tournament", "--ladder", path, "--jobs", "6", "--pools",
               "2", "--ticks", "20")
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    rows = doc["rows"]
    assert len(rows) == 24
    assert sum(r["ladder"] == f"artifact:{path}" for r in rows) == 12
    assert _cli("tournament", "--ladder", str(tmp_path / "no")).returncode \
        == 2


def test_spot_fraction_knob_sets_the_spot_heavy_trace(monkeypatch, capsys):
    """EDL_TPU_FLEET_SPOT_FRACTION sets the spot-heavy trace's share of
    revocable spot nodes in the CLI's tournament (the JAX package reads
    the knob and drops it); unset, the CLI's rows are the JAX package's
    trace_menu grid."""
    from edl_tpu.scaler import fleet as jfleet
    from edl_tpu_torch.scaler import fleet

    small = ["--jobs", "6", "--pools", "2", "--ticks", "20"]

    def spot_heavy(rows):
        return {r["spot_fraction"] for r in rows
                if r["trace"] == "spot-heavy"}

    monkeypatch.delenv("EDL_TPU_FLEET_SPOT_FRACTION", raising=False)
    assert fleet.main(["tournament", *small]) == 0
    unset = json.loads(capsys.readouterr().out)["rows"]
    ref = jfleet.tournament(traces=jfleet.trace_menu(n_jobs=6, n_pools=2,
                                                     ticks=20))["rows"]
    assert unset == json.loads(json.dumps(ref))
    monkeypatch.setenv("EDL_TPU_FLEET_SPOT_FRACTION", "0.25")
    assert fleet.main(["tournament", *small]) == 0
    quarter = json.loads(capsys.readouterr().out)["rows"]
    for rows, frac in ((unset, 0.5), (quarter, 0.25)):
        trace = fleet.trace_menu(n_jobs=6, n_pools=2, ticks=20,
                                 spot_fraction=frac)[2]
        assert spot_heavy(rows) == {round(trace.spot_fraction, 3)}
    assert max(spot_heavy(quarter)) < min(spot_heavy(unset))
    others = [r for r in unset if r["trace"] != "spot-heavy"]
    assert others == [r for r in quarter if r["trace"] != "spot-heavy"]
