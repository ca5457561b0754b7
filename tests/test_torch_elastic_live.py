"""The port's elastic job with live state migration on the CPU
(``EDL_TPU_RESIZE_P2P=1``, the default): its store server, its launchers
and its ``imagenet_train --device cpu`` at ResNetTiny and 16 px over gloo,
every process the port's.

Worlds 2 -> 1 -> 2, with the manual gradient path (``--dcn-compress
int8``) and with the default SPMD world step: SIGTERM to the launcher of the pod holding rank 0
(what a shrink delivers; that pod is the checkpoint writer, so the one
with a sealed snapshot to serve) releases its trainer as a donor, which
seals its live state, leaves its process group and lingers; the
survivor's trainer, blocked in a collective with it, fails at once and is
respawned into the world of one, restoring from the donor's memory (ack
mode ``peers``). A fresh launcher then grows the world back to two (the
survivor's trainer held at SIGSTOP until that world is published, so
the job cannot end first): the
survivor keeps its process and adopts the new world in place (ack mode
``adopted``, its pid unchanged, the reform phases in the JAX package's
order) while the newcomer restores from the survivor's memory. Each epoch
is evaluated once, and the final acc1 is within 0.01 of a straight world
of one (the bound of tests/test_torch_elastic.py).

The test has its own deadline; past it, or on any failure, every process
of the job is killed (by process group and by its job id in /proc).
"""

import json
import os
import re
import signal

from edl_tpu_torch.collective import migration as mig
from tests.test_torch_elastic import (TINY, WORLD_FLAGS, Job,  # noqa: F401
                                      data_dir, run_world)

EPOCHS = 5   # the schedule of test_torch_elastic.py's 2 -> 1 -> 2 test
SPMD_FLAGS = ["--fused-opt", "fp32"]   # no comm flag: the SPMD world step
LIVE_ENV = {"EDL_TPU_RESIZE_P2P": "1",
            # a respawned trainer's start (torch, the model) must fit in a
            # donor's linger, and the newcomer's in the survivor's
            # rendezvous and its launcher's wait for the adoption
            "EDL_TPU_DONOR_LINGER": "60", "EDL_TPU_ADOPT_TIMEOUT": "60",
            "EDL_TPU_REFORM_MESH_S": "60"}


def _evaluated(job: Job) -> list[int]:
    """The epochs the leaders evaluated, over every trainer of the job."""
    out = []
    for d in job.dir.glob("log_*"):
        for f in d.iterdir():
            out += [int(m) for m in re.findall(r"eval epoch (\d+):",
                                                f.read_text(errors="replace"))]
    return sorted(out)


def _final_acc1(job: Job, pod: str) -> float:
    text = "".join(f.read_text(errors="replace")
                   for f in (job.dir / f"log_{pod}").iterdir())
    return float(re.findall(r"final_acc1=([0-9.]+)", text)[-1])


def test_shrink_and_in_place_grow_restore_from_peers(data_dir, tmp_path,
                                                     capsys):
    _live_job(data_dir, tmp_path, capsys, WORLD_FLAGS)


def test_spmd_world_shrinks_and_grows_in_place(data_dir, tmp_path, capsys):
    """The same job without a comm flag: the SPMD world step with
    global-batch BatchNorm, rebuilt on the new world's mesh by the
    survivor's reform_mesh (adopted in place, not downgraded)."""
    _live_job(data_dir, tmp_path, capsys, SPMD_FLAGS)


def _live_job(data_dir, tmp_path, capsys, flags: list) -> None:
    argv = ["--data-dir", str(data_dir), *TINY, *flags, "--epochs",
            str(EPOCHS), "--schedule-epochs", str(EPOCHS)]
    acks: dict[tuple, dict] = {}

    def seen_acks():
        recs, _ = job.client.get_prefix(mig.ack_prefix(job.name))
        for r in recs:
            doc = json.loads(r.value)
            acks[(doc["pod_id"], doc["ts"])] = doc
        return acks

    def sealed() -> bool:
        ckpt = tmp_path / "ckpt"
        return ckpt.is_dir() and any(c.name.startswith("ckpt-")
                                     for c in ckpt.iterdir())

    with Job(tmp_path, "live-job", deadline_s=170) as job:
        pods = {p: job.launcher(p, argv, LIVE_ENV) for p in ("podA", "podB")}
        job.wait_for(lambda: getattr(job.world(), "world_size", 0) == 2,
                     "the 2-pod world")
        job.wait_for(sealed, "a checkpoint of the 2-pod world")
        first = job.world()
        leader = first.pods[0].pod_id       # rank 0: the writer
        survivor = next(p for p in pods if p != leader)
        os.kill(pods[leader].pid, signal.SIGTERM)    # the launcher only
        assert job.wait_exit(pods[leader], "the leaver's exit") == 143

        def shrunk():
            c = job.world()
            return (c is not None and c.world_size == 1
                    and c.pod_ids() == {survivor})
        job.wait_for(shrunk, "the 1-pod world")
        v_shrunk = job.world().version
        job.wait_for(lambda: any(a["mode"] == "peers" and a["pod_id"] ==
                                 survivor for a in seen_acks().values()),
                     "the survivor's restore from the donor")
        [kept] = [p for p in job.pod_pids(survivor)
                  if p != pods[survivor].pid]
        # Held at SIGSTOP until the grown world is published: a world of
        # one at this size runs an epoch in well under a second and
        # would finish the job before the new launcher's barrier.
        os.kill(kept, signal.SIGSTOP)
        try:
            pods["podC"] = job.launcher("podC", argv, LIVE_ENV)
            job.wait_for(lambda: getattr(job.world(), "world_size", 0) == 2,
                         "the grown world")
        finally:
            os.kill(kept, signal.SIGCONT)
        v_grown = job.world().version
        for p in (survivor, "podC"):
            assert job.wait_exit(pods[p], f"{p}'s completion") == 0, \
                job.tails()
        seen_acks()
        assert job.client.get(f"/{job.name}/complete") is not None
        job.wait_for(lambda: not job.pod_pids(leader),
                     "the donor's exit after its linger")
        assert not [p for pod in pods for p in job.pod_pids(pod)]

    with capsys.disabled():
        print("\nacks:", json.dumps(sorted(acks.values(),
                                           key=lambda a: a["ts"])))
    assert v_shrunk < v_grown
    adopted = [a for a in acks.values() if a["mode"] == "adopted"]
    assert len(adopted) == 1, acks
    adopted = adopted[0]
    assert adopted["pod_id"] == survivor and adopted["pid"] == kept
    assert adopted["generation"] == v_grown
    doc = adopted["reform"]
    assert doc["result"] == "in-place" and doc["restore"] == "peers"
    assert [p["phase"] for p in doc["phases"]] == [
        "quiesce", "mesh-reform", "peer-restore", "re-jit", "first-step"]
    assert adopted["bytes_from_peers"] > 0
    peers = [a for a in acks.values() if a["mode"] == "peers"]
    assert {a["pod_id"] for a in peers} == {survivor, "podC"}, acks
    assert all(a["bytes_from_peers"] > 0 for a in peers)
    assert _evaluated(job) == list(range(EPOCHS))
    acc_live = _final_acc1(job, "podC")
    assert acc_live == _final_acc1(job, survivor)
    straight = run_world(tmp_path, "straight", 1, data_dir, EPOCHS,
                         schedule_epochs=EPOCHS)
    acc_s = straight["final"]["acc1"]
    assert acc_s > 0.85, straight["final"]
    with capsys.disabled():
        print("acc1 live", acc_live, "straight", acc_s)
    assert abs(acc_live - acc_s) < 0.01, (acc_live, acc_s)
