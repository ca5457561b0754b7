"""Elastic trainer demo, the end-to-end probe of the launcher and of the
control plane (port of ``edl_tpu.examples.elastic_demo``).

The trainer is a tiny linear regression that reads the launcher's
TrainerEnv, trains its data shard (``make_data``: seed-per-pass, shard by
rank) with checkpoint and resume under the port's TrainLoop, and
survives resizes. Each pod trains on its own card (``--device cuda``, the
default) or on the CPU (``--device cpu``):

  python -m edl_tpu_torch.examples.elastic_demo --epochs 5 --steps-per-epoch 20

The other modes are the closed loops, each wiring an in-process store,
a JobServer and a JobClient that keeps launcher pods of THIS trainer
running (the pods get the mode's ``--device``), and each ending in its
own self-audit and a ``<mode>_summary=`` JSON line (exit 1 when the
audit fails):

  --scaler        utilization in, resizes out: a leader-elected
                  ScalerController resizes the job through /resize
                  (``run_scaler_demo``);
  --serve-scaler  teacher-pool latency in, a grown or a DRAINED pool out
                  (``run_serve_scaler_demo``);
  --serve-load    continuous batching and admission control under the
                  open-loop generator, with a teacher killed unannounced
                  (``run_serve_load_demo``);
  --resize-p2p    a scripted shrink adopted in place and a grow restored
                  from peers (``run_p2p_demo``);
  --resize-reform pods whose local dp mesh is sized by the elastic world
                  (``--local-mesh-by-world``), reformed in place with
                  zero process restarts (``run_reform_demo``);
  --spot          a preemption notice ridden as a scheduled shrink inside
                  ``EDL_TPU_SPOT_NOTICE_S`` (``run_spot_demo``).

Each audit is a function of what the run recorded (journal entries,
resize logs, migration acks), so it can be checked on recorded input.
The orchestrating process imports no torch; only the trainers and the
teachers touch the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.elastic_demo")

TRUE_W, TRUE_B = 3.0, -1.5
# --local-mesh-by-world: a pod's local mesh positions at world 1 (the JAX
# package's reform demo gives each pod two virtual devices)
LOCAL_DEVICES = 2


def make_data(epoch: int, rank: int, world: int, steps: int, batch: int):
    """Seed-per-pass + shard-by-rank, the JAX package's numbers."""
    rng = np.random.default_rng(1000 + epoch)
    n = steps * batch * max(1, world)
    x = rng.normal(size=(n, 1)).astype(np.float32)
    y = TRUE_W * x + TRUE_B + 0.01 * rng.normal(size=(n, 1)).astype(
        np.float32)
    shard = slice(rank * steps * batch, (rank + 1) * steps * batch)
    xs, ys = x[shard], y[shard]
    for i in range(steps):
        s = slice(i * batch, (i + 1) * batch)
        yield {"x": xs[s], "y": ys[s]}


def trainer_cmd(args, store_ep: str, job_id: str, lo: int, hi: int,
                tmp: str, *, epochs: int, steps: int, step_time: float,
                extra: tuple[str, ...] = ()) -> list[str]:
    """One launcher pod running this trainer on the mode's device."""
    return [sys.executable, "-m", "edl_tpu_torch.collective.launch",
            "--store", store_ep, "--job-id", job_id,
            "--nodes-range", f"{lo}:{hi}",
            "--checkpoint-path", os.path.join(tmp, "ckpt"),
            "--log-dir", os.path.join(tmp, "log"), "--",
            sys.executable, "-m", "edl_tpu_torch.examples.elastic_demo",
            "--device", args.device,
            "--epochs", str(epochs), "--steps-per-epoch", str(steps),
            "--batch", str(args.batch), "--step-time", str(step_time),
            "--ckpt-steps", str(args.ckpt_steps or 10), *extra]


def read_journal(path: str) -> list[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]
    except OSError:
        return []


def pod_devices(log_dir: str) -> list[str]:
    """The devices the pods' trainers ran on, from their logs' "trainer
    up" lines (the launchers' workerlog files)."""
    import glob
    import re
    found = set()
    for path in glob.glob(os.path.join(log_dir, "workerlog.*")):
        with open(path, errors="replace") as f:
            found.update(re.findall(r"trainer up: .* device=(\S+)",
                                    f.read()))
    return sorted(found)


def stop_job_client(client, thread) -> None:
    client.stop()
    thread.join(timeout=15)
    for p in client.procs:  # no orphan launchers
        if p.poll() is None:
            p.kill()


# -- the audits (functions of what a run recorded) ---------------------------


def scaler_audit(entries: list[dict], served_log: list[dict],
                 final_desired: int, lo: int, hi: int,
                 complete: bool) -> tuple[bool, dict]:
    """The --scaler audit: the job completed, every resize the JobServer
    served has its journal entry (same applied values, same order; a
    ``final_desired`` off ``lo`` with an empty journal is the same
    escape), and with room to act (hi > lo) the scaler saw fresh
    utilization (else the loop is silently not closing)."""
    resizes = [e for e in entries if e.get("action") == "resize"]
    served = [s["to"] for s in served_log]
    journaled = [e["applied"] if e.get("applied") is not None
                 else e["desired"] for e in resizes]
    escaped = served != journaled or \
        final_desired != (served[-1] if served else lo)
    fresh_seen = any(e.get("fresh") for e in entries)
    silent = hi > lo and not fresh_seen
    summary = {"complete": complete, "decisions": len(entries),
               "resizes": [{"tick": e["seq"], "from": e["current"],
                            "to": e["desired"], "applied": e["applied"],
                            "reason": e["reason"]} for e in resizes],
               "served_resizes": served_log,
               "journal_matches_served": not escaped,
               "fresh_utilization_seen": fresh_seen,
               "final_desired": final_desired,
               "observed_downtime_s": [e["observed_downtime_s"]
                                       for e in entries
                                       if e.get("observed_downtime_s")
                                       is not None],
               "downtime_charged_s": [e.get("downtime_s")
                                      for e in entries]}
    return complete and not escaped and not silent, summary


def serve_scaler_audit(entries: list[dict], actuated_log: list[dict],
                       drain_log: list[dict],
                       final_slo_met: bool) -> tuple[bool, dict]:
    """The --serve-scaler audit: at least one grow AND one shrink were
    journaled and applied, every actuated pool resize has its journal
    entry (the actuator's log minus the initial pre-controller resize),
    at least one shrink completed as a graceful drain with zero hard
    kills, and the SLO was met again by the end."""
    serving = [e for e in entries if e.get("kind") == "serving"]
    resizes = [e for e in serving if e["action"] == "resize"]
    grows = [e for e in resizes if e["desired"] > e["current"]]
    shrinks = [e for e in resizes if e["desired"] < e["current"]]
    journaled = [e["applied"] for e in resizes]
    actuated = [r["to"] for r in actuated_log[1:]]
    drained = [d for d in drain_log if d["drained"]]
    hard_killed = [d for d in drain_log if d["hard_killed"]]
    ok = (len(grows) >= 1 and len(shrinks) >= 1
          and journaled == actuated
          and len(drained) >= 1 and not hard_killed
          and final_slo_met)
    return ok, {"ok": ok, "decisions": len(serving),
                "grows": len(grows), "shrinks": len(shrinks),
                "resizes": [{"tick": e["seq"], "from": e["current"],
                             "to": e["desired"], "reason": e["reason"]}
                            for e in resizes],
                "journal_matches_actuated": journaled == actuated,
                "drained": len(drained), "hard_killed": len(hard_killed),
                "drain_log": drain_log, "final_slo_met": final_slo_met}


def serve_load_audit(ab: dict, over: dict, killed: dict,
                     first_shed: float | None, ok_after_shed: int,
                     ok_after_kill: int) -> tuple[bool, dict]:
    """The --serve-load audit over the loadgen summaries: A, for each
    load, clean runs with equal sustained throughput and a continuous
    p95 at least 1.5x below the window's; B, overload shed happened, the
    high class held >= 90% attainment and (almost) never shed, shedding
    concentrated on low, completions flowed after the first shed and
    after the kill, and errors stayed within the kill's in-flight."""
    failures: list[str] = []

    def gate(cond: bool, what: str) -> None:
        if not cond:
            failures.append(what)
        log.info("%s %s", "ok  " if cond else "FAIL", what)

    for load in ("low", "mid"):
        w, c = ab["window"][load], ab["continuous"][load]
        gate(w["error"] == 0 and c["error"] == 0
             and w["shed"] == 0 and c["shed"] == 0,
             f"A/{load}: clean run (no shed, no errors)")
        gate(abs(w["rps_sustained"] - c["rps_sustained"])
             <= 0.15 * max(w["rps_sustained"], c["rps_sustained"]),
             f"A/{load}: equal sustained throughput "
             f"(window {w['rps_sustained']} vs continuous "
             f"{c['rps_sustained']} rps)")
        gate(c["p95_ms"] is not None and w["p95_ms"] is not None
             and c["p95_ms"] * 1.5 <= w["p95_ms"],
             f"A/{load}: continuous p95 >=1.5x lower "
             f"({c['p95_ms']} vs {w['p95_ms']} ms)")
    cls = over["by_class"]
    sheds = {c: v["shed"] for c, v in cls.items()}
    low_share = sheds.get("low", 0) / max(sum(sheds.values()), 1)
    high = cls.get("high", {"attainment": None, "shed_pct": 100.0})
    low = cls.get("low", {"shed_pct": 0.0})
    gate(bool(killed) and over["shed"] >= 1 and first_shed is not None,
         f"B: overload shed happened ({over['shed']} rejects)")
    gate(high["attainment"] is not None and high["attainment"] >= 0.9,
         f"B: high class holds >=90% SLO attainment "
         f"(got {high['attainment']})")
    gate(high["shed_pct"] <= 5.0,
         f"B: high class (almost) never sheds (got {high['shed_pct']}%)")
    gate(low_share >= 0.7 and low["shed_pct"] >= 30.0,
         f"B: shedding concentrates on low (low share {low_share:.2f}, "
         f"low shed {low['shed_pct']}%)")
    gate(ok_after_shed > 0, "B: completions resume after the first shed")
    gate(bool(killed) and ok_after_kill > 0,
         "B: completions resume after the kill (failover)")
    gate(over["error"] <= 0.05 * max(over["offered"], 1),
         f"B: errors bounded to the kill's in-flight "
         f"({over['error']}/{over['offered']})")
    ok = not failures
    return ok, {"ok": ok, "failures": failures,
                "ab": {m: {load: {k: r[k] for k in
                                  ("rps_offered", "rps_sustained",
                                   "p50_ms", "p95_ms")}
                           for load, r in runs.items()}
                       for m, runs in ab.items()},
                "overload": {**{k: over[k] for k in
                                ("rps_offered", "rps_sustained",
                                 "offered", "ok", "shed", "error")},
                             "low_share_of_shed": round(low_share, 3),
                             "by_class": cls}}


def p2p_audit(acks: list[dict], phases_ok: bool, complete: bool,
              epochs_published: int) -> tuple[bool, dict]:
    """The --resize-p2p audit: at least one pod ADOPTED a resize in
    place, at least one restored FROM PEERS with bytes over the wire,
    /resize published a migration epoch per applied resize, and the job
    completed; nothing silently degraded to the disk recipe."""
    adoptions = [d for d in acks if d["mode"] == "adopted"]
    peer_restores = [d for d in acks if d["mode"] == "peers"]
    disk_restores = [d for d in acks if d["mode"] == "disk"]
    bytes_from_peers = sum(d.get("bytes_from_peers") or 0
                           for d in peer_restores)
    gaps = [d["downtime_s"] for d in adoptions
            if d.get("downtime_s") is not None]
    ok = (phases_ok and complete and len(adoptions) >= 1
          and len(peer_restores) >= 1 and bytes_from_peers > 0
          and epochs_published >= 2)
    return ok, {
        "ok": ok, "complete": complete,
        "adoptions": len(adoptions),
        "peer_restores": len(peer_restores),
        "disk_restores": len(disk_restores),
        "resize_bytes_from_peers": bytes_from_peers,
        # the worst surviving-pod training gap across the resizes
        "elastic_downtime_p2p_s": round(max(gaps), 4) if gaps else None,
        "adoption_gaps_s": [round(g, 4) for g in sorted(gaps)],
        "peer_restore_s": [d.get("restore_s") for d in peer_restores],
        "migration_epochs_published": epochs_published}


def reform_audit(acks: list[dict], phases_ok: bool, complete: bool,
                 t_grow: float | None) -> tuple[bool, dict]:
    """The --resize-reform audit: at least TWO in-place reforms (result
    "in-place" in the adoption ack's reform doc), one pod that rode both
    on the SAME pid (zero process restarts), at least one reform restored
    FROM PEERS with bytes over the wire, and the job completed."""
    reforms = [d for d in acks
               if d["mode"] == "adopted"
               and (d.get("reform") or {}).get("result") == "in-place"]
    peer_reforms = [d for d in reforms
                    if d["reform"].get("restore") == "peers"]
    disk_reforms = [d for d in reforms
                    if d["reform"].get("restore") == "disk"]
    respawn_restores = [d for d in acks if d["mode"] == "peers"]
    by_pod: dict[str, set] = {}
    for d in reforms:
        by_pod.setdefault(d["pod_id"], set()).add(
            (d.get("pid"), d.get("generation")))
    survivors = sorted(pod for pod, gens in by_pod.items()
                       if len({g for _, g in gens}) >= 2
                       and len({p for p, _ in gens}) == 1)
    bytes_from_peers = sum(d.get("bytes_from_peers") or 0
                           for d in reforms + respawn_restores)
    gaps = sorted(d["downtime_s"] for d in reforms
                  if d.get("downtime_s") is not None)
    # the stop-resume price a NON-surviving process pays on the grow
    respawn_gaps = sorted(d["ts"] - t_grow for d in respawn_restores
                          if t_grow is not None and d["ts"] > t_grow)
    ok = (phases_ok and complete and len(reforms) >= 2
          and len(survivors) >= 1 and len(peer_reforms) >= 1
          and bytes_from_peers > 0)
    last = max(reforms, key=lambda d: d["ts"])["reform"] if reforms \
        else None
    return ok, {
        "ok": ok, "complete": complete,
        "reforms_in_place": len(reforms),
        "reform_restores_peers": len(peer_reforms),
        "reform_restores_disk": len(disk_reforms),
        "respawn_peer_restores": len(respawn_restores),
        "zero_restart_survivors": survivors,
        "resize_bytes_from_peers": bytes_from_peers,
        # best gap = a reform back to an already-seen shape; worst = the
        # first sight of a new one
        "elastic_downtime_multihost_s": round(gaps[0], 4) if gaps
        else None,
        "elastic_downtime_multihost_cold_s": round(gaps[-1], 4) if gaps
        else None,
        "reform_gaps_s": [round(g, 4) for g in gaps],
        "respawn_downtime_s": round(respawn_gaps[0], 4)
        if respawn_gaps else None,
        "last_reform": last}


def spot_audit(acks: list[dict], phases_ok: bool, complete: bool,
               t_notice: float | None, deadline: float | None,
               t_rode: float | None, notice_s: float) -> tuple[bool, dict]:
    """The --spot audit: the shrink COMPLETED before the notice's
    deadline, the survivor adopted IN PLACE after the notice (no respawn)
    with nothing fallen back to the disk recipe, and the job completed on
    the shrunk world."""
    after = [d for d in acks if t_notice is not None and d["ts"] > t_notice]
    adoptions = [d for d in after if d["mode"] == "adopted"]
    disk_restores = [d for d in after if d["mode"] == "disk"]
    gaps = [d["downtime_s"] for d in adoptions
            if d.get("downtime_s") is not None]
    rode = (phases_ok and t_rode is not None and deadline is not None
            and t_rode <= deadline)
    ok = rode and complete and len(adoptions) >= 1 and not disk_restores
    return ok, {
        "ok": ok, "complete": complete, "rode_notice": rode,
        "notice_window_s": notice_s,
        "ride_margin_s": round(deadline - t_rode, 3) if rode else None,
        "adoptions_after_notice": len(adoptions),
        "disk_restores_after_notice": len(disk_restores),
        "spot_downtime_s": round(max(gaps), 4) if gaps else None}


# -- the live-job modes -------------------------------------------------------


class _DemoJob:
    """Store + store-attached JobServer + JobClient-spawned launcher pods
    of this trainer: the rig of the p2p, reform and spot modes."""

    def __init__(self, args, job_id: str, prefix: str, *, epochs: int,
                 steps: int, step_time: float,
                 extra: tuple[str, ...] = ()):
        from edl_tpu_torch.collective.job_server import (JobClient,
                                                         JobServer, JobState)
        from edl_tpu_torch.coord.server import StoreServer
        self.job_id = job_id
        self.lo, self.hi = (int(x) for x in args.nodes_range.split(":"))
        self.hi = max(self.hi, 2)
        self.timeout = args.p2p_timeout
        self.tmp = tempfile.mkdtemp(prefix=prefix)
        self.srv = StoreServer(port=0, host="127.0.0.1",
                               sweep_interval=0.2).start()
        self.state = JobState(job_id, self.lo, self.hi, desired=self.hi,
                              store=self.srv.store)
        self.server = JobServer(self.state, port=0).start()
        self.endpoint = f"127.0.0.1:{self.server.port}"
        cmd = trainer_cmd(args, f"127.0.0.1:{self.srv.port}", job_id,
                          self.lo, self.hi, self.tmp, epochs=epochs,
                          steps=steps, step_time=step_time, extra=extra)
        self.client = JobClient(self.endpoint, cmd, poll=0.5)
        self.thread = threading.Thread(target=self.client.run, daemon=True,
                                       name=f"{prefix}jobclient")
        self._acks: dict[tuple, dict] = {}   # (pod_id, ts) -> ack doc

    def start(self) -> None:
        self.thread.start()

    def sample_acks(self) -> None:
        from edl_tpu_torch.collective import migration as mig
        records, _ = self.srv.store.get_prefix(mig.ack_prefix(self.job_id))
        for rec in records:
            try:
                doc = json.loads(rec.value)
                self._acks[(doc["pod_id"], doc["ts"])] = doc
            except (ValueError, KeyError):
                continue

    @property
    def acks(self) -> list[dict]:
        return list(self._acks.values())

    def wait_for(self, pred, timeout: float, what: str) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.sample_acks()
            if pred():
                return True
            time.sleep(0.25)
        log.error("%s: timeout waiting for %s", self.job_id, what)
        return False

    def world(self) -> int:
        from edl_tpu_torch.collective.barrier import read_cluster
        c = read_cluster(self.srv.store, self.job_id)
        return c.world_size if c is not None else 0

    def full_world_with_donors(self) -> bool:
        from edl_tpu_torch.collective import migration as mig
        return self.wait_for(
            lambda: self.world() == self.hi
            and mig.live_donors(self.srv.store, self.job_id),
            self.timeout, "world up with live donors")

    def resize(self, desired: int) -> None:
        from edl_tpu_torch.collective.job_server import request_resize
        request_resize(self.endpoint, desired)

    def wait_complete(self, budget: float) -> bool:
        from edl_tpu_torch.collective import register as reg
        return self.wait_for(
            lambda: self.srv.store.get(reg.complete_key(self.job_id))
            is not None, budget, "job completion")

    def close(self) -> None:
        self.sample_acks()
        stop_job_client(self.client, self.thread)
        self.server.stop()
        self.srv.stop()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _live_env(adopt_timeout: str | None = None) -> None:
    # fast membership plumbing so the measured gaps are the migration
    # plane's, not the default 10 s leases (children inherit these)
    os.environ.setdefault("EDL_TPU_BARRIER_STABLE", "0.5")
    os.environ.setdefault("EDL_TPU_LEASE_TTL", "3.0")
    os.environ["EDL_TPU_RESIZE_P2P"] = "1"
    if adopt_timeout is not None:
        os.environ.setdefault("EDL_TPU_ADOPT_TIMEOUT", adopt_timeout)


def run_scaler_demo(args) -> int:
    """Controller-driven elasticity end to end on this host: store +
    JobServer (store-attached: each served resize publishes its migration
    epoch and carries the decision's trace to the trainers) + JobClient-
    spawned launcher pods + ScalerController. Returns non-zero unless
    `scaler_audit` passes. ``scaler_summary=`` adds where the measured
    downtime came from (``downtime_source``: "ack" when the trainers'
    migration acks carried it) and the acked gaps."""
    from edl_tpu_torch.collective import migration as mig
    from edl_tpu_torch.collective import register as reg
    from edl_tpu_torch.collective.job_server import (JobClient, JobServer,
                                                     JobState)
    from edl_tpu_torch.coord.server import StoreServer
    from edl_tpu_torch.scaler.controller import (ScalerConfig,
                                                 ScalerController)
    from edl_tpu_torch.scaler.policy import ThroughputPolicy

    job_id = "scaler_demo"
    lo, hi = (int(x) for x in args.nodes_range.split(":"))
    tmp = tempfile.mkdtemp(prefix="edl-scaler-demo-")
    journal_path = args.journal or os.path.join(tmp, "scaler.jsonl")
    srv = StoreServer(port=0, host="127.0.0.1", sweep_interval=0.2).start()
    store_ep = f"127.0.0.1:{srv.port}"
    state = JobState(job_id, lo, hi, desired=lo, store=srv.store)
    server = JobServer(state, port=0).start()
    # pace the trainers a little by default: an instant run would
    # complete before the scaler ever observes a utilization record
    cmd = trainer_cmd(args, store_ep, job_id, lo, hi, tmp,
                      epochs=args.epochs, steps=args.steps_per_epoch,
                      step_time=args.step_time or 0.05)
    client = JobClient(f"127.0.0.1:{server.port}", cmd, poll=0.5)
    client_thread = threading.Thread(target=client.run, daemon=True,
                                     name="scaler-demo-jobclient")
    config = ScalerConfig(interval=args.scaler_interval,
                          cooldown_s=args.scaler_cooldown,
                          downtime_s=args.scaler_downtime,
                          staleness_s=10.0)
    controller = ScalerController(
        srv.store, [job_id],
        ThroughputPolicy(gain_threshold=config.gain_threshold,
                         cooldown_s=config.cooldown_s,
                         horizon_s=max(config.cooldown_s, 30.0)),
        config=config, job_server=f"127.0.0.1:{server.port}",
        journal_path=journal_path, owner="scaler-demo")
    log.info("scaler demo: store=%s job_server=:%d nodes=%d:%d "
             "journal=%s", store_ep, server.port, lo, hi, journal_path)
    complete = False
    acks: list[dict] = []
    try:
        client_thread.start()
        controller.start()
        deadline = time.time() + args.scaler_timeout
        while time.time() < deadline:
            if srv.store.get(reg.complete_key(job_id)) is not None:
                complete = True
                break
            time.sleep(0.5)
        records, _ = srv.store.get_prefix(mig.ack_prefix(job_id))
        acks = [json.loads(r.value) for r in records]
    finally:
        controller.stop()
        stop_job_client(client, client_thread)
        server.stop()
        srv.stop()

    ok, summary = scaler_audit(read_journal(journal_path), state.resize_log,
                               state.desired, lo, hi, complete)
    summary["downtime_source"] = controller.downtime_source.get(job_id)
    summary["acked_downtime_s"] = [a["downtime_s"] for a in acks
                                   if a.get("downtime_s") is not None]
    summary["configured_downtime_s"] = args.scaler_downtime
    summary["migration_epochs_published"] = state._migration_epoch
    summary["trainer_devices"] = pod_devices(os.path.join(tmp, "log"))
    summary["journal"] = journal_path if args.journal else None
    log.info("scaler demo done: ok=%s %s", ok, summary)
    print("scaler_summary=" + json.dumps(summary), flush=True)
    if args.journal is None:
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        shutil.rmtree(os.path.join(tmp, "ckpt"), ignore_errors=True)
    return 0 if ok else 1


def run_serve_scaler_demo(args) -> int:
    """Serving elasticity end to end on this host: an in-process store, a
    `TeacherPoolActuator` spawning in-process `TeacherServer`s (a sleepy
    predict standing in for device time) with registrars publishing
    latency/queue stats, an open-loop load, and a `ScalerController`
    running a `ServingPolicy`. Three load phases: cruise (SLO met), a 4x
    step (sustained p95 breach -> grow), then near-idle (utilization
    under the low-water mark -> DRAINED shrink). Returns non-zero unless
    `serve_scaler_audit` passes; prints ``serve_summary=``."""
    from edl_tpu_torch.coord.registry import ServiceRegistry
    from edl_tpu_torch.coord.server import StoreServer
    from edl_tpu_torch.distill.registrar import DISTILL_ROOT, TeacherRegistrar
    from edl_tpu_torch.distill.teacher_server import (TeacherClient,
                                                      TeacherServer)
    from edl_tpu_torch.scaler.controller import (ScalerConfig,
                                                 ScalerController)
    from edl_tpu_torch.scaler.policy import ThroughputPolicy
    from edl_tpu_torch.scaler.serving import (LocalTeacher, ServingConfig,
                                              ServingPolicy,
                                              TeacherPoolActuator)

    service = "serve_demo_teacher"
    tmp = tempfile.mkdtemp(prefix="edl-serve-scaler-")
    journal_path = args.journal or os.path.join(tmp, "serving.jsonl")
    srv = StoreServer(port=0, host="127.0.0.1", sweep_interval=0.2).start()
    per_row_s = 0.002      # the stand-in device: 2 ms per row
    request_rows = 8

    def spawn(index: int) -> LocalTeacher:
        del index

        def predict(feeds):
            rows = next(iter(feeds.values())).shape[0]
            time.sleep(rows * per_row_s)
            out = {"logits": np.zeros((rows, 4), np.float32)}
            return lambda: out   # the port's predict returns its fetch
        server = TeacherServer(predict, port=0, host="127.0.0.1",
                               max_batch=32, max_wait=0.001).start()
        registrar = TeacherRegistrar(
            srv.store, service, f"127.0.0.1:{server.port}",
            ttl=2.0, stats_interval=0.25, probe_timeout=10.0)
        registrar.start()
        return LocalTeacher(server, registrar)

    serve_cfg = ServingConfig(
        slo_p95_ms=200.0, queue_high=4.0, util_low=0.25,
        breach_ticks=2, idle_ticks=3, cooldown_s=2.0,
        min_teachers=1, max_teachers=3, drain_deadline_s=15.0)
    actuator = TeacherPoolActuator(
        spawn, min_teachers=serve_cfg.min_teachers,
        max_teachers=serve_cfg.max_teachers,
        drain_deadline_s=serve_cfg.drain_deadline_s, service=service)
    controller = ScalerController(
        srv.store, [], ThroughputPolicy(),
        config=ScalerConfig(interval=0.5, min_tick_s=0.2,
                            staleness_s=5.0),
        services=[service], serving_policy=ServingPolicy(serve_cfg),
        serving_actuate=actuator.actuate, serving_config=serve_cfg,
        journal_path=journal_path, owner="serve-scaler-demo",
        scope="serve_demo")

    # requests/sec follows the phase plan; endpoints are re-read from the
    # registry so a drained teacher stops receiving traffic the moment
    # it deregisters
    phase = {"rate": 20.0}
    stop = threading.Event()

    def load_loop() -> None:
        registry = ServiceRegistry(srv.store, root=DISTILL_ROOT)
        clients: dict[str, TeacherClient] = {}
        endpoints: list[str] = []
        rr, last_refresh = 0, 0.0
        feed = {"image": np.zeros((request_rows, 4), np.float32)}
        while not stop.is_set():
            now = time.monotonic()
            if now - last_refresh > 0.3 or not endpoints:
                endpoints = [m.server for m in
                             registry.get_service(service)]
                for ep in list(clients):
                    if ep not in endpoints:
                        clients.pop(ep).close()
                last_refresh = now
            if not endpoints:
                time.sleep(0.05)
                continue
            ep = endpoints[rr % len(endpoints)]
            rr += 1
            try:
                client = clients.get(ep)
                if client is None:
                    # lifecycle: long-lived(pooled per-endpoint client; closed on dict eviction above and drained at loop end)
                    client = TeacherClient(ep, timeout=30.0,
                                           max_inflight=64)
                    clients[ep] = client
                client.predict_async(feed)
            except Exception:  # noqa: BLE001 — teacher went away
                clients.pop(ep, None)
            time.sleep(1.0 / max(phase["rate"], 1e-6))
        for client in clients.values():
            client.close()

    load_thread = threading.Thread(target=load_loop, daemon=True,
                                   name="serve-demo-load")
    final_ok = False
    try:
        actuator.resize(1)   # the initial pool, before any decisions
        controller.start()
        load_thread.start()
        # cruise: ~160 rows/s against 500 rows/s capacity
        time.sleep(args.serve_phase_s)
        # 4x step: ~640 rows/s > one teacher's capacity; the backlog
        # drives p95 over the SLO and the pool must grow
        phase["rate"] = 80.0
        time.sleep(2.5 * args.serve_phase_s)
        # near-idle: the pool must DRAIN back down
        phase["rate"] = 4.0
        time.sleep(3.0 * args.serve_phase_s)
        roll = controller._service_collector.service_rollup(service)
        final_ok = (roll["latency_ms_p95"] is None
                    or roll["latency_ms_p95"] <= serve_cfg.slo_p95_ms)
    finally:
        stop.set()
        load_thread.join(timeout=10)
        controller.stop()
        actuator.wait_drains(timeout=serve_cfg.drain_deadline_s + 5)
        actuator.close()
        srv.stop()

    ok, summary = serve_scaler_audit(read_journal(journal_path),
                                     actuator.resize_log,
                                     actuator.drain_log, final_ok)
    summary["journal"] = journal_path if args.journal else None
    if not ok:
        log.error("serve-scaler audit failed: %s", summary)
    print("serve_summary=" + json.dumps(summary), flush=True)
    if args.journal is None:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0 if ok else 1


def run_serve_load_demo(args) -> int:
    """Continuous batching + admission control end to end on this host:
    in-process `TeacherServer`s (sleepy predicts standing in for device
    time) probed by the open-loop generator (`distill/loadgen.py`).

      A. batching A/B: one teacher per mode at the same offered rates
         (low and mid, well under capacity): continuous sustains the
         window Batcher's throughput with at least 1.5x lower p95.
      B. overload + a teacher killed unannounced: two continuous
         teachers with the overload-shed rule armed, offered 2x the
         pool's capacity on a high/normal/low mix, one stopped mid-phase
         (no deregistration, no drain: the loadgen's failover path).
         The high class holds >= 90% SLO attainment and (almost) never
         sheds, shedding concentrates on low, and completions flow again
         after the first shed and after the kill.

    Prints ``serve_load_summary=`` and returns non-zero unless every gate
    holds.
    """
    from edl_tpu_torch.distill.admission import AdmissionConfig
    from edl_tpu_torch.distill.loadgen import LoadStats, run_open_loop
    from edl_tpu_torch.distill.teacher_server import TeacherServer

    phase_s = args.serve_phase_s

    def sleepy(per_row_s: float, base_s: float):
        def predict(feeds):
            rows = next(iter(feeds.values())).shape[0]
            time.sleep(base_s + per_row_s * rows)
            out = {"logits": np.zeros((rows, 4), np.float32)}
            return lambda: out   # the port's predict returns its fetch
        return predict

    ab: dict[str, dict] = {}
    for mode in ("window", "continuous"):
        # a fast stand-in (~0.3 ms/row): service time is small against
        # the 20 ms coalesce window, so the window's cost is visible
        server = TeacherServer(
            sleepy(0.0003, 0.001), port=0, host="127.0.0.1",
            max_batch=64, max_wait=0.02,
            admission=AdmissionConfig(batching=mode)).start()
        runs = {}
        try:
            for load, rps in (("low", 25.0), ("mid", 100.0)):
                stats = run_open_loop(
                    [f"127.0.0.1:{server.port}"], duration_s=phase_s,
                    rps=rps, rows=4, seed=11)
                runs[load] = stats.summary()
        finally:
            server.stop()
        ab[mode] = runs

    # a slower stand-in (36 ms batches): pool capacity ~2 * 222 rows/s =
    # ~55 rps of 8-row requests; offered 111 rps is a 2x overload. SLO
    # 500 ms ~= 3x the saturated pipeline latency
    slo_ms = 500.0
    adm = AdmissionConfig(batching="continuous", shed_ms=150.0)
    servers = [TeacherServer(sleepy(0.004, 0.004), port=0,
                             host="127.0.0.1", max_batch=8,
                             admission=adm).start() for _ in range(2)]
    live = [f"127.0.0.1:{s.port}" for s in servers]
    by_ep = dict(zip(live, servers))
    killed: dict = {}
    kill_at = 1.5 * phase_s

    def kill_one(i: int, t: float) -> None:
        del i
        if t >= kill_at and not killed:
            ep = live.pop()
            killed["ep"], killed["t"] = ep, t
            # stop() resets live connections; no drain, no
            # deregistration: the loadgen must fail over on its own
            threading.Thread(target=by_ep[ep].stop, daemon=True,
                             name="serve-load-kill").start()

    stats = LoadStats()
    try:
        run_open_loop(lambda: list(live), duration_s=3.0 * phase_s,
                      rps=111.0, rows=8,
                      mix={"high": 0.1, "normal": 0.15, "low": 0.75},
                      seed=12, stats=stats, on_arrival=kill_one)
    finally:
        for server in servers:
            try:
                server.stop()
            except Exception:  # noqa: BLE001 — one already stopped
                pass
    over = stats.summary(slo_ms=slo_ms)
    first_shed = stats.first_event("shed")
    ok, summary = serve_load_audit(
        ab, over, killed, first_shed,
        stats.ok_after(first_shed) if first_shed is not None else 0,
        stats.ok_after(killed["t"]) if killed else 0)
    summary["overload"]["slo_ms"] = slo_ms
    if not ok:
        log.error("serve-load audit failed: %s", summary["failures"])
    print("serve_load_summary=" + json.dumps(summary), flush=True)
    return 0 if ok else 1


def run_p2p_demo(args) -> int:
    """Peer-to-peer state migration end to end on one host: the live job
    (`_DemoJob`), a scripted shrink (the survivor adopts in place) and
    grow (the new pod restores from peers over the wire) through
    /resize, then the job runs to completion. Prints ``p2p_summary=``
    (with the resize traces' phase split when ``EDL_TPU_TRACE`` is on)
    and returns non-zero unless `p2p_audit` passes."""
    from edl_tpu_torch.obs import trace as obs_trace
    _live_env()
    epochs = max(args.epochs, 30)
    steps = max(args.steps_per_epoch, 20)
    step_time = args.step_time or 0.06
    job = _DemoJob(args, "p2p_demo", "edl-p2p-demo-", epochs=epochs,
                   steps=steps, step_time=step_time)
    phases_ok, complete = True, False
    t_shrink = None
    try:
        job.start()
        phases_ok &= job.full_world_with_donors()
        if phases_ok:
            t_shrink = time.time()
            job.resize(job.lo)
            phases_ok &= job.wait_for(
                lambda: job.world() == job.lo and any(
                    d["mode"] == "adopted" and d["ts"] > t_shrink
                    for d in job.acks),
                job.timeout, "shrink adopted in place")
        if phases_ok:
            time.sleep(2.0)  # let the survivors seal fresh versions
            t_grow = time.time()
            job.resize(job.hi)
            phases_ok &= job.wait_for(
                lambda: job.world() == job.hi and any(
                    d["mode"] == "peers" and d["ts"] > t_grow
                    for d in job.acks),
                job.timeout, "grow restored from peers")
        if phases_ok:
            complete = job.wait_complete(job.timeout
                                         + epochs * steps * step_time)
    finally:
        job.close()
    ok, summary = p2p_audit(job.acks, phases_ok, complete,
                            job.state._migration_epoch)
    summary["served_resizes"] = job.state.resize_log
    if obs_trace.enabled():
        # the traces started by THIS run (the sink dir persists)
        spans = obs_trace.load_spans(obs_trace.sink_dir())
        resizes = [r for r in obs_trace.resize_phase_summary(spans)
                   if t_shrink is None or r["t0"] >= t_shrink - 60.0]
        summary["trace_dir"] = obs_trace.sink_dir()
        summary["resize_traces"] = [
            {k: r[k] for k in ("trace_id", "spans", "phases",
                               "downtime_s")} for r in resizes]
    if not ok:
        log.error("p2p audit failed: %s", summary)
    print("p2p_summary=" + json.dumps(summary), flush=True)
    return 0 if ok else 1


def run_reform_demo(args) -> int:
    """A resize WITHOUT restart, end to end on one host: pods whose local
    dp mesh is a function of the elastic world (``--local-mesh-by-world``
    over LOCAL_DEVICES positions), so every resize changes every survivor's
    mesh: the surviving process quiesce-seals its live state, re-forms its
    mesh, restores its state from its own sealed snapshot over the tensor
    wire, rebuilds its step, steps and acks, generation-fenced. Scripted
    shrink + grow through /resize. Prints ``reform_summary=`` and returns
    non-zero unless `reform_audit` passes."""
    # reforms pay seal + restore + the step's rebuild: room beyond the
    # launcher's default 10 s adoption fence
    _live_env(adopt_timeout="30")
    epochs = max(args.epochs, 30)
    steps = max(args.steps_per_epoch, 20)
    step_time = args.step_time or 0.05
    job = _DemoJob(args, "reform_demo", "edl-reform-demo-", epochs=epochs,
                   steps=steps, step_time=step_time,
                   extra=("--local-mesh-by-world",))

    def reform_acks(after: float) -> list[dict]:
        return [d for d in job.acks
                if d["mode"] == "adopted" and d["ts"] > after
                and (d.get("reform") or {}).get("result") == "in-place"]

    phases_ok, complete = True, False
    t_grow = None
    try:
        job.start()
        phases_ok &= job.full_world_with_donors()
        if phases_ok:
            # shrink: every survivor's local mesh GROWS (fewer pods share
            # the local devices): a change it must reform through
            t_shrink = time.time()
            job.resize(job.lo)
            phases_ok &= job.wait_for(
                lambda: job.world() == job.lo and reform_acks(t_shrink),
                job.timeout, "shrink reformed in place")
        if phases_ok:
            time.sleep(1.5)  # survivors seal fresh versions
            # grow: survivors reform back to a shape they have seen while
            # the new pod restores from peers through a respawn
            t_grow = time.time()
            job.resize(job.hi)
            phases_ok &= job.wait_for(
                lambda: job.world() == job.hi and reform_acks(t_grow)
                and any(d["mode"] == "peers" and d["ts"] > t_grow
                        for d in job.acks),
                job.timeout, "grow reformed + peer-restored")
        if phases_ok:
            complete = job.wait_complete(job.timeout
                                         + epochs * steps * step_time)
    finally:
        job.close()
    ok, summary = reform_audit(job.acks, phases_ok, complete, t_grow)
    summary["migration_epochs_published"] = job.state._migration_epoch
    summary["served_resizes"] = job.state.resize_log
    if not ok:
        log.error("reform audit failed: %s", summary)
    print("reform_summary=" + json.dumps(summary), flush=True)
    return 0 if ok else 1


def run_spot_demo(args) -> int:
    """Spot capacity ridden end to end on one host: the live job receives
    a preemption NOTICE and rides it as a SCHEDULED quiesce-seal-donate
    shrink through /resize inside the notice window
    (``EDL_TPU_SPOT_NOTICE_S``): never a surprise kill, never lost
    progress. Prints ``spot_summary=`` with the ride margin (deadline
    minus completion) and returns non-zero unless `spot_audit` passes."""
    from edl_tpu_torch.utils.config import env_float
    _live_env()
    notice_s = env_float("EDL_TPU_SPOT_NOTICE_S", 60.0)
    if notice_s <= 0:
        log.error("spot demo: EDL_TPU_SPOT_NOTICE_S=0 means notices are "
                  "ignored: nothing to demonstrate")
        return 1
    epochs = max(args.epochs, 30)
    steps = max(args.steps_per_epoch, 20)
    step_time = args.step_time or 0.06
    job = _DemoJob(args, "spot_demo", "edl-spot-demo-", epochs=epochs,
                   steps=steps, step_time=step_time)
    phases_ok, complete = True, False
    t_notice = deadline = t_rode = None
    try:
        job.start()
        phases_ok &= job.full_world_with_donors()
        if phases_ok:
            # the NOTICE: notice_s seconds to quiesce-seal-donate down to
            # the post-reclaim capacity; the scheduled shrink IS the ride
            t_notice = time.time()
            deadline = t_notice + notice_s
            log.info("spot notice: %d node(s) reclaimed in %.0fs — "
                     "scheduled shrink %d -> %d", job.hi - job.lo,
                     notice_s, job.hi, job.lo)
            job.resize(job.lo)
            phases_ok &= job.wait_for(
                lambda: job.world() == job.lo and any(
                    d["mode"] == "adopted" and d["ts"] > t_notice
                    for d in job.acks),
                notice_s, "sealed shrink inside the notice window")
            t_rode = time.time()
        if phases_ok:
            complete = job.wait_complete(job.timeout
                                         + epochs * steps * step_time)
    finally:
        job.close()
    ok, summary = spot_audit(job.acks, phases_ok, complete, t_notice,
                             deadline, t_rode, notice_s)
    summary["served_resizes"] = job.state.resize_log
    if not ok:
        log.error("spot audit failed: %s", summary)
    print("spot_summary=" + json.dumps(summary), flush=True)
    return 0 if ok else 1


# -- the trainer --------------------------------------------------------------


def local_mesh(n_local: int, world: int):
    """The local dp mesh a pod trains over at elastic world ``world``:
    every local device at world 1, ``n_local // world`` of them above."""
    from edl_tpu_torch.parallel import mesh as mesh_lib
    n = n_local if world <= 1 else max(1, n_local // world)
    return mesh_lib.Mesh(np.arange(n), ("dp",))


def make_step(mesh, step_time: float):
    """The SGD step on a local dp mesh: the batch splits into one equal
    slice per mesh position and the loss is the mean of their losses, the
    gradient the JAX package's dp mesh averages (``mesh`` None: the whole
    batch at once)."""
    from edl_tpu_torch.models.linear import mse_loss
    from edl_tpu_torch.train.step import make_train_step
    n = 1 if mesh is None else mesh.size

    def loss_fn(model, batch):
        xs, ys = batch["x"].chunk(n), batch["y"].chunk(n)
        loss = sum(mse_loss(model(x), y) for x, y in zip(xs, ys)) / n
        return loss, {}

    step = make_train_step(loss_fn)
    if step_time <= 0:
        return step

    def paced(s, b):  # the resize-window pacing
        time.sleep(step_time)
        return step(s, b)
    return paced


def train(args, env, device, init: tuple[float, float] | None = None):
    """Build and run the trainer; returns the finished TrainLoop.
    ``init`` = (w, b) overrides the seeded init (the tests bridge the JAX
    package's init across)."""
    import torch

    from edl_tpu_torch.models.linear import LinearRegression
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.train import state as state_lib
    from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
    from edl_tpu_torch.utils.config import from_env

    model = LinearRegression(1, 1, device=device, seed=0)
    if init is not None:
        with torch.no_grad():
            model.Dense_0.weight.fill_(init[0])
            model.Dense_0.bias.fill_(init[1])
    state = state_lib.TrainState.create(
        model=model, tx=state_lib.sgd(0.05, momentum=0.0))

    # --local-mesh-by-world: the local dp mesh is a FUNCTION of the
    # elastic world, so a resize changes every survivor's mesh: the
    # reform_mesh hook returns the step for the new mesh and the
    # TrainLoop walks quiesce -> mesh-reform -> peer-restore -> rebuild in
    # place (no respawn). Each pod checkpoints under its own subdir
    # (per-pod version counters are per-lineage).
    reform_mesh = None
    mesh = None
    if args.local_mesh_by_world:
        holder = {"mesh": local_mesh(LOCAL_DEVICES, env.world_size)}
        mesh = holder["mesh"]

        def place() -> None:
            # the state re-placed whole on the pod's device, the JAX
            # package's replicated placement on the live mesh
            model.load_state_dict(mesh_lib.replicate_host_tree(
                holder["mesh"], model.state_dict(), device))

        place()

        def reform_mesh(rank, world, cluster):
            new = local_mesh(LOCAL_DEVICES, world)
            if new.size == holder["mesh"].size:
                return None  # mesh unchanged: the fast adoption
            holder["mesh"] = new
            place()
            return make_step(new, args.step_time)

    def on_reform(rank, world, cluster):
        # an adopted resize re-enters the epoch in place: re-derive the
        # data shard for the new world (make_data reads env per epoch)
        env.rank, env.world_size = rank, world
        env.cluster_version = cluster.version

    ckpt_kw = {}
    if args.ckpt_steps is not None:
        ckpt_kw["ckpt_every_steps"] = args.ckpt_steps
    if args.ckpt_sync:
        ckpt_kw["ckpt_async"] = False
    ckpt_dir = env.checkpoint_path or None
    if ckpt_dir and args.local_mesh_by_world and env.pod_id:
        ckpt_dir = os.path.join(ckpt_dir, env.pod_id)
    loop = TrainLoop(make_step(mesh, args.step_time), state, device=device,
                     config=from_env(LoopConfig, num_epochs=args.epochs,
                                     ckpt_dir=ckpt_dir,
                                     log_every_steps=args.steps_per_epoch,
                                     **ckpt_kw),
                     on_reform=on_reform, reform_mesh=reform_mesh)
    loop.run(lambda epoch: make_data(epoch, env.rank, env.world_size,
                                     args.steps_per_epoch, args.batch))
    return loop


def run_trainer(args) -> int:
    from edl_tpu_torch import resolve_device
    from edl_tpu_torch.collective.job_env import TrainerEnv

    device = resolve_device(args.device)
    env = TrainerEnv.from_environ()
    log.info("trainer up: rank=%d world=%d cluster_v=%d device=%s",
             env.rank, env.world_size, env.cluster_version, device)
    loop = train(args, env, device)
    w = float(loop.state.model.Dense_0.weight.detach()[0, 0])
    b = float(loop.state.model.Dense_0.bias.detach()[0])
    log.info("done: epoch=%d step=%d w=%.3f b=%.3f", loop.status.epoch,
             loop.status.step, w, b)
    # a graceful SIGTERM stop never reaches here: loop.run raises
    # SystemExit(143) after its donor linger (the launcher must not read
    # a stopped trainer as "training complete")
    print("ckpt_stats=" + json.dumps(loop.ckpt_stats()), flush=True)
    return 0


MODES = ("scaler", "serve_scaler", "serve_load", "resize_p2p",
         "resize_reform", "spot")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.examples.elastic_demo")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the closed-loop modes "
                             "pass it on to the pods they spawn")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--steps-per-epoch", type=int, default=20)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--step-time", type=float, default=0.0,
                        help="artificial per-step delay (resize-window test)")
    parser.add_argument("--ckpt-steps", type=int, default=None,
                        help="also checkpoint every N steps (default "
                             "$EDL_TPU_CKPT_STEPS, else epoch-end only)")
    parser.add_argument("--ckpt-sync", action="store_true",
                        help="synchronous saves (default async "
                             "snapshot-then-write)")
    parser.add_argument("--scaler", action="store_true",
                        help="run the closed loop: store + JobServer + "
                             "launcher pods + utilization-driven scaler")
    parser.add_argument("--nodes-range", default="1:2",
                        help="min:max pods on this host")
    parser.add_argument("--scaler-interval", type=float, default=1.0)
    parser.add_argument("--scaler-cooldown", type=float, default=8.0)
    parser.add_argument("--scaler-downtime", type=float, default=1.5,
                        help="the downtime charged before one is measured")
    parser.add_argument("--scaler-timeout", type=float, default=300.0)
    parser.add_argument("--journal", default=None,
                        help="--scaler/--serve-scaler: keep the decision "
                             "journal here")
    parser.add_argument("--serve-scaler", action="store_true",
                        help="run the serving loop: store + teacher pool "
                             "+ load + SLO-driven scaler, self-audited "
                             "grow + drained shrink")
    parser.add_argument("--serve-phase-s", type=float, default=5.0,
                        help="--serve-scaler/--serve-load: base "
                             "load-phase seconds")
    parser.add_argument("--serve-load", action="store_true",
                        help="run the serving load check: open-loop "
                             "generator vs window/continuous batching, "
                             "then 2x overload with a teacher killed")
    parser.add_argument("--resize-p2p", action="store_true",
                        help="run the live-migration loop: scripted "
                             "shrink/grow, self-audited p2p adoption + "
                             "peer restore")
    parser.add_argument("--p2p-timeout", type=float, default=120.0,
                        help="--resize-p2p/-reform/--spot: per-phase "
                             "timeout seconds")
    parser.add_argument("--resize-reform", action="store_true",
                        help="run the resize-without-restart loop: pods "
                             "whose local mesh is sized by the elastic "
                             "world, self-audited in-place reforms")
    parser.add_argument("--spot", action="store_true",
                        help="run the spot-riding loop: a preemption "
                             "notice ridden as a scheduled shrink inside "
                             "$EDL_TPU_SPOT_NOTICE_S")
    parser.add_argument("--local-mesh-by-world", action="store_true",
                        help="trainer mode of --resize-reform: the local "
                             "dp mesh sized by the elastic world (per-pod "
                             "checkpoint subdirs)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    chosen = [m for m in MODES if getattr(args, m)]
    if len(chosen) > 1:
        parser.error("--scaler, --serve-scaler, --serve-load, "
                     "--resize-p2p, --resize-reform and --spot are "
                     "separate demos")
    runner = {"scaler": run_scaler_demo,
              "serve_scaler": run_serve_scaler_demo,
              "serve_load": run_serve_load_demo,
              "resize_p2p": run_p2p_demo,
              "resize_reform": run_reform_demo,
              "spot": run_spot_demo}.get(chosen[0] if chosen else "",
                                         run_trainer)
    return runner(args)


if __name__ == "__main__":
    sys.exit(main())
