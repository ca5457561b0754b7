"""The port's elastic_demo against the JAX package's.

- The trainer on the CPU at world 1 (LinearRegression, SGD 0.05, the
  seeded ``make_data`` shards), from the JAX init bridged across, ends
  within 1e-5 of the JAX package's trainer's ``w`` and ``b``; so does its
  local dp mesh step (``--local-mesh-by-world``'s) over two positions.
- A plain-SGD state (the trainer's: no moments) restores from a live
  donor over the tensor wire; the repair of the peer restore that failed
  on it ("no key 'opt_state'") and fell back to the disk recipe.
- ``--serve-scaler`` runs to its self-audit on the CPU at a small size.
  The modes that spawn launcher pods of torch trainers (``--scaler``,
  ``--resize-p2p``, ``--resize-reform``, ``--spot``) and the timing-bound
  ``--serve-load`` take longer than a test may: their audits run on
  recorded input, each once passing and once with the fault it exists to
  catch.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from edl_tpu.examples import elastic_demo as jax_demo
from edl_tpu_torch.examples import elastic_demo as demo
from test_torch_world import one_torch_thread  # noqa: F401


def test_make_data_is_the_jax_package_s():
    for epoch, rank, world in ((0, 0, 1), (3, 1, 2), (7, 2, 3)):
        got = list(demo.make_data(epoch, rank, world, 5, 8))
        ref = list(jax_demo.make_data(epoch, rank, world, 5, 8))
        assert len(got) == len(ref) == 5
        for g, r in zip(got, ref):
            assert np.array_equal(g["x"], r["x"])
            assert np.array_equal(g["y"], r["y"])


def jax_trainer(epochs: int, steps: int, batch: int):
    """The JAX package's elastic_demo trainer at world 1 (its main's
    recipe, without a launcher): returns (w, b) and the init."""
    from edl_tpu.models.linear import LinearRegression, mse_loss
    from edl_tpu.train.loop import LoopConfig, TrainLoop
    from edl_tpu.train.state import TrainState
    from edl_tpu.train.step import make_train_step
    model = LinearRegression(features=1)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 1)))["params"]
    init = (float(params["Dense_0"]["kernel"][0, 0]),
            float(params["Dense_0"]["bias"][0]))
    state = TrainState.create(apply_fn=model.apply, params=params,
                              tx=optax.sgd(0.05))

    def loss_fn(state, params, batch):
        return mse_loss(state.apply_fn({"params": params}, batch["x"]),
                        batch["y"]), {}

    loop = TrainLoop(make_train_step(loss_fn, donate=False), state,
                     config=LoopConfig(num_epochs=epochs,
                                       log_every_steps=steps))
    loop.run(lambda epoch: jax_demo.make_data(epoch, 0, 1, steps, batch))
    p = loop.state.params["Dense_0"]
    return (float(np.asarray(p["kernel"])[0, 0]),
            float(np.asarray(p["bias"])[0])), init


@pytest.mark.parametrize("local_mesh", [False, True])
def test_trainer_ends_where_the_jax_trainer_ends(local_mesh, monkeypatch):
    from edl_tpu_torch.collective.job_env import TrainerEnv
    for key in ("EDL_TPU_RANK", "EDL_TPU_CHECKPOINT_PATH",
                "EDL_TPU_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    (w_ref, b_ref), init = jax_trainer(epochs=3, steps=20, batch=32)
    argv = ["--device", "cpu", "--epochs", "3", "--steps-per-epoch", "20",
            "--batch", "32"] + (["--local-mesh-by-world"] if local_mesh
                                else [])
    args = demo.build_parser().parse_args(argv)
    loop = demo.train(args, TrainerEnv.from_environ(), "cpu", init=init)
    w = float(loop.state.model.Dense_0.weight.detach()[0, 0])
    b = float(loop.state.model.Dense_0.bias.detach()[0])
    assert loop.status.step == 60 and loop.status.epoch == 2
    assert abs(w - w_ref) <= 1e-5 and abs(b - b_ref) <= 1e-5
    assert abs(w - demo.TRUE_W) < 0.05 and abs(b - demo.TRUE_B) < 0.05


def test_local_mesh_follows_the_world():
    assert [demo.local_mesh(4, w).size for w in (1, 2, 3, 4, 8)] == \
        [4, 2, 1, 1, 1]


def test_a_plain_sgd_state_restores_from_a_peer(tmp_path):
    from edl_tpu_torch.collective import migration as mig
    from edl_tpu_torch.coord.store import InMemStore
    from edl_tpu_torch.models.linear import LinearRegression
    from edl_tpu_torch.train import state as state_lib
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainStatus

    def plain(seed):
        return state_lib.TrainState.create(
            model=LinearRegression(1, 1, device="cpu", seed=seed),
            tx=state_lib.sgd(0.05, momentum=0.0))

    store = InMemStore()
    mgr = CheckpointManager(str(tmp_path / "c"))
    svc = mig.MigrationService(store, "j", "p0", addr="127.0.0.1")
    svc.attach(mgr)
    try:
        donor = plain(0)
        mgr.save(donor, TrainStatus(epoch=1, step=7))
        deadline = time.monotonic() + 10
        while not mig.live_donors(store, "j"):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        got, status, stats = mig.restore_from_peers(store, "j", plain(5))
        assert stats["bytes_from_peers"] > 0 and status.step == 7
        for a, b in zip(got.model.parameters(), donor.model.parameters()):
            assert bool((a == b).all())
    finally:
        svc.shutdown(linger=False)


def test_serve_scaler_runs_to_its_audit(capsys):
    rc = demo.main(["--serve-scaler", "--serve-phase-s", "2"])
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("serve_summary=")]
    summary = json.loads(line[-1].split("=", 1)[1])
    assert rc == 0, summary
    assert summary["grows"] >= 1 and summary["shrinks"] >= 1
    assert summary["hard_killed"] == 0 and summary["final_slo_met"]


# -- the audits on recorded input -------------------------------------------


def journal_entry(seq, action="hold", current=1, desired=1, applied=None,
                  fresh=True, observed=None, downtime=1.5):
    return {"seq": seq, "ts": 1000.0 + seq, "job_id": "scaler_demo",
            "leader": "scaler-demo", "world_size": current,
            "throughput": 640.0, "generation": 1, "fresh": fresh,
            "current": current, "desired": desired, "applied": applied,
            "action": action,
            "reason": "probe-up" if action == "resize" else "converged",
            "downtime_s": downtime, "observed_downtime_s": observed,
            "downtime_kind": "reform" if observed else None,
            "predicted_gain": None}


def test_scaler_audit_on_recorded_input():
    entries = [journal_entry(0, fresh=False), journal_entry(1),
               journal_entry(2, "resize", 1, 2, 2),
               journal_entry(3, current=2, desired=2, observed=0.102,
                             downtime=0.102)]
    served = [{"from": 1, "to": 2, "requested": 2, "clamped": False,
               "source": "resize"}]
    ok, summary = demo.scaler_audit(entries, served, 2, 1, 2, True)
    assert ok and summary["observed_downtime_s"] == [0.102]
    assert summary["resizes"] == [{"tick": 2, "from": 1, "to": 2,
                                   "applied": 2, "reason": "probe-up"}]
    # a resize served behind the journal's back
    assert not demo.scaler_audit(entries[:2], served, 2, 1, 2, True)[0]
    # a scaler that never saw fresh utilization with room to act
    blind = [dict(e, fresh=False) for e in entries[:2]]
    assert not demo.scaler_audit(blind, [], 1, 1, 2, True)[0]
    assert demo.scaler_audit(blind, [], 1, 1, 1, True)[0]
    assert not demo.scaler_audit(entries, served, 2, 1, 2, False)[0]


def serving_entry(seq, current, desired, reason):
    return {"seq": seq, "kind": "serving", "service": "svc",
            "current": current, "desired": desired,
            "applied": desired if desired != current else None,
            "action": "resize" if desired != current else "hold",
            "reason": reason}


def test_serve_scaler_audit_on_recorded_input():
    entries = [serving_entry(0, 1, 1, "in-band"),
               serving_entry(1, 1, 2, "slo-breach-grow"),
               serving_entry(2, 2, 2, "cooldown"),
               serving_entry(3, 2, 1, "idle-shrink")]
    actuated = [{"from": 0, "to": 1}, {"from": 1, "to": 2},
                {"from": 2, "to": 1}]
    drains = [{"endpoint": "a", "drained": True, "hard_killed": False,
               "wait_s": 0.4}]
    ok, summary = demo.serve_scaler_audit(entries, actuated, drains, True)
    assert ok and summary["grows"] == summary["shrinks"] == 1
    killed = [dict(drains[0], drained=False, hard_killed=True)]
    assert not demo.serve_scaler_audit(entries, actuated, killed, True)[0]
    assert not demo.serve_scaler_audit(entries, actuated, drains, False)[0]
    assert not demo.serve_scaler_audit(entries[:2], actuated, drains,
                                       True)[0]


def loadgen_summary(p95, shed=0, error=0, offered=100, by_class=None):
    return {"rps_offered": 25.0, "rps_sustained": 25.0 * (1 - shed / 100),
            "p50_ms": p95 / 2, "p95_ms": p95, "offered": offered,
            "ok": offered - shed - error, "shed": shed, "error": error,
            "by_class": by_class or {}}


def test_serve_load_audit_on_recorded_input():
    ab = {"window": {"low": loadgen_summary(30.0),
                     "mid": loadgen_summary(28.0)},
          "continuous": {"low": loadgen_summary(6.0),
                         "mid": loadgen_summary(9.0)}}
    cls = {"high": {"shed": 0, "shed_pct": 0.0, "attainment": 0.97},
           "normal": {"shed": 10, "shed_pct": 20.0, "attainment": 0.7},
           "low": {"shed": 90, "shed_pct": 45.0, "attainment": 0.4}}
    over = loadgen_summary(400.0, shed=100, error=3, offered=330,
                           by_class=cls)
    killed = {"ep": "127.0.0.1:9", "t": 1.5}
    ok, summary = demo.serve_load_audit(ab, over, killed, 0.4, 50, 40)
    assert ok and summary["overload"]["low_share_of_shed"] == 0.9
    slow = dict(ab, continuous={"low": loadgen_summary(25.0),
                                "mid": loadgen_summary(9.0)})
    ok, summary = demo.serve_load_audit(slow, over, killed, 0.4, 50, 40)
    assert not ok and summary["failures"] == [
        "A/low: continuous p95 >=1.5x lower (25.0 vs 30.0 ms)"]
    assert not demo.serve_load_audit(ab, over, killed, 0.4, 50, 0)[0]
    assert not demo.serve_load_audit(ab, over, {}, 0.4, 50, 0)[0]


def ack(pod, mode, ts, gap=None, nbytes=0, pid=1, generation=2,
        reform=None):
    doc = {"pod_id": pod, "mode": mode, "ts": ts, "pid": pid,
           "generation": generation, "version": 3, "downtime_s": gap,
           "bytes_from_peers": nbytes, "restore_s": 0.01}
    if reform is not None:
        doc["reform"] = reform
    return doc


def test_p2p_audit_on_recorded_input():
    acks = [ack("a", "fresh", 1.0), ack("b", "fresh", 1.0),
            ack("a", "adopted", 5.0, gap=0.06),
            ack("c", "peers", 9.0, nbytes=24)]
    ok, summary = demo.p2p_audit(acks, True, True, 2)
    assert ok and summary["elastic_downtime_p2p_s"] == 0.06
    # the grow fell back to the disk recipe
    disk = acks[:3] + [ack("c", "disk", 9.0)]
    ok, summary = demo.p2p_audit(disk, True, True, 2)
    assert not ok and summary["disk_restores"] == 1
    assert not demo.p2p_audit(acks, True, True, 1)[0]
    assert not demo.p2p_audit(acks, True, False, 2)[0]


def in_place(restore="peers"):
    return {"result": "in-place", "restore": restore, "phases": []}


def test_reform_audit_on_recorded_input():
    acks = [ack("a", "adopted", 5.0, gap=0.08, nbytes=36, pid=11,
                generation=2, reform=in_place()),
            ack("a", "adopted", 9.0, gap=0.07, nbytes=36, pid=11,
                generation=3, reform=in_place()),
            ack("c", "peers", 14.0, nbytes=36, pid=12, generation=3)]
    ok, summary = demo.reform_audit(acks, True, True, t_grow=8.0)
    assert ok and summary["zero_restart_survivors"] == ["a"]
    assert summary["respawn_downtime_s"] == 6.0
    assert summary["elastic_downtime_multihost_s"] == 0.07
    # the survivor was restarted between the reforms (a new pid)
    restarted = [acks[0], dict(acks[1], pid=13), acks[2]]
    assert not demo.reform_audit(restarted, True, True, 8.0)[0]
    disk = [dict(a, reform=in_place("disk"), bytes_from_peers=0)
            for a in acks[:2]]
    assert not demo.reform_audit(disk, True, True, 8.0)[0]


def test_spot_audit_on_recorded_input():
    acks = [ack("a", "fresh", 1.0), ack("a", "adopted", 12.0, gap=0.065)]
    ok, summary = demo.spot_audit(acks, True, True, 10.0, 70.0, 13.0, 60.0)
    assert ok and summary["ride_margin_s"] == 57.0
    assert summary["spot_downtime_s"] == 0.065
    # finished after the deadline: the reclaim would have killed live pods
    assert not demo.spot_audit(acks, True, True, 10.0, 70.0, 71.0, 60.0)[0]
    lost = acks + [ack("b", "disk", 14.0)]
    assert not demo.spot_audit(lost, True, True, 10.0, 70.0, 13.0, 60.0)[0]


def test_one_mode_at_a_time_and_the_device_reaches_the_pods():
    with pytest.raises(SystemExit):
        demo.main(["--scaler", "--spot"])
    args = demo.build_parser().parse_args(["--device", "cpu"])
    cmd = demo.trainer_cmd(args, "h:1", "j", 1, 2, "/t", epochs=3, steps=4,
                           step_time=0.1, extra=("--local-mesh-by-world",))
    tail = cmd[cmd.index("--", 0) + 1:]
    assert tail[:3] == [tail[0], "-m", "edl_tpu_torch.examples.elastic_demo"]
    assert tail[tail.index("--device") + 1] == "cpu"
    assert tail[-1] == "--local-mesh-by-world"
