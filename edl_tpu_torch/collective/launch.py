"""Elastic launcher: register -> barrier -> spawn trainer -> watch -> loop
(port of ``edl_tpu.collective.launch``). One launcher per pod; it
imports no torch, so it starts fast and holds no CUDA context.

Lifecycle per generation:
  1. claim a rank slot (CAS, leased)                       register.py
  2. barrier until leader publishes a Cluster snapshot     barrier.py
  3. spawn ONE trainer process with the EDL_TPU_* env       process.py
  4. watch: membership change | lease lost | trainer exit  watcher.py
  5. a membership change under live migration (EDL_TPU_RESIZE_P2P=1,
     the default): re-form the world first, with the claim held, and
     wait for the running trainer to adopt it in place (its "adopted"
     ack, migration.wait_adopted); else stop-resume with the old trainer
     kept alive as a lingering donor, so the new one restores its state
     from memory                                           migration.py
  6. any other restart, or EDL_TPU_RESIZE_P2P=0: stop-resume: kill the
     trainer, go to 2 (or 1); the trainer resumes from the latest
     checkpoint in the new world

The restart reasons are the JAX package's: ``complete`` (the trainer
exited 0, or another pod published ``/<job>/complete``), ``lease_lost``,
``membership``, ``crash`` and ``crash_loop``. A SIGTERM to the launcher
(a shrink) releases a live-migration trainer as a donor (it stops
gracefully and lingers, bounded, in its own session) and kills it
outright under ``EDL_TPU_RESIZE_P2P=0``.

CLI (the trainer picks its own device on its command line):
  python -m edl_tpu_torch.collective.launch \\
      --store 127.0.0.1:2379 --nodes-range 1:4 -- \\
      python -m edl_tpu_torch.examples.imagenet_train --ckpt-dir D ...
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

from edl_tpu_torch.collective import barrier as bar
from edl_tpu_torch.collective import migration as mig
from edl_tpu_torch.collective import register as reg
from edl_tpu_torch.collective.cluster import Pod
from edl_tpu_torch.collective.job_env import (JobEnv, local_addr,
                                              trainer_environ)
from edl_tpu_torch.collective.process import (release_trainer,
                                              start_trainer,
                                              terminate_trainer)
from edl_tpu_torch.collective.watcher import ClusterWatcher
from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.utils import net
from edl_tpu_torch.utils.config import describe
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.collective.launch")

def _job_complete(store: Store, job_id: str) -> bool:
    return store.get(reg.complete_key(job_id)) is not None


def launch(job: JobEnv, trainer_cmd: list[str], *, store: Store | None = None,
           max_consecutive_crashes: int = 5, poll: float = 0.5,
           n_devices: int | None = None,
           healthy_generation_secs: float = 60.0) -> int:
    """Run the elastic loop until the job completes. Returns exit code."""
    owns_store = store is None
    if store is None:
        store = StoreClient(job.store_endpoints)  # closed in the finally
    if n_devices is None:
        n_devices = max(1, job.nproc_per_node)
    # The coordinator port is stable across membership restarts (published
    # cluster snapshots embed it, so silently changing it would invalidate
    # every snapshot) and is re-picked ONLY on the release+re-claim path,
    # where the membership blip forces peers into a new generation built
    # from live records anyway.
    pod = Pod(pod_id=job.pod_id, addr=local_addr(), port=net.free_port(),
              n_devices=n_devices)
    log.info("launcher starting:\n%s", describe(job))

    register = reg.PodRegister(store, job.job_id, pod,
                               max_nodes=job.max_nodes, ttl=job.lease_ttl)
    register.claim()
    last_version = 0
    crashes = 0
    trainer = None
    watcher = None
    cluster = None
    # Donors released into their linger window: trainers that keep
    # serving their sealed snapshot to the re-formed world. Reaped each
    # poll; force-killed past the deadline.
    lingering: list[list] = []  # [TrainerProc, kill_deadline]

    def _reap_lingering() -> None:
        now = time.monotonic()
        for item in list(lingering):
            tp, deadline = item
            if not tp.alive():
                lingering.remove(item)
            elif now > deadline:
                log.warning("donor pid=%d outlived its linger window; "
                            "killing group", tp.pid)
                try:
                    os.killpg(os.getpgid(tp.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                lingering.remove(item)

    try:
        while True:
            if _job_complete(store, job.job_id):
                log.info("job %s complete", job.job_id)
                return 0
            if cluster is None:
                cluster = bar.cluster_barrier(
                    store, job.job_id, pod.pod_id,
                    after_version=last_version, min_nodes=job.min_nodes,
                    stable_secs=job.barrier_stable_secs,
                    timeout=job.barrier_timeout)
                last_version = cluster.version
            if trainer is None:
                rank = cluster.rank_of(pod.pod_id)
                env = trainer_environ(cluster, pod.pod_id, job)
                trainer = start_trainer(trainer_cmd, env, job.log_dir,
                                        rank=rank)
            watcher = ClusterWatcher(store, cluster).start()
            generation_start = time.monotonic()

            restart_reason = None
            while restart_reason is None:
                time.sleep(poll)
                _reap_lingering()
                if _job_complete(store, job.job_id):
                    restart_reason = "complete"
                elif register.lost.is_set():
                    # Checked before `changed`: when our own lease expires
                    # the watcher also sees the membership blip, but the
                    # right recovery is release + re-claim, not a plain
                    # rejoin of the (stale-lease) barrier.
                    restart_reason = "lease_lost"
                elif watcher.changed.is_set():
                    restart_reason = "membership"
                elif not trainer.alive():
                    rc = trainer.returncode
                    if rc == 0:
                        # Training finished: publish completion for the
                        # other pods (idempotent put).
                        store.put(reg.complete_key(job.job_id), "1")
                        restart_reason = "complete"
                    else:
                        # A generation that trained healthily for a while
                        # breaks the "consecutive" chain: without this,
                        # isolated crashes days apart would accumulate into
                        # a spurious crash_loop abort.
                        if time.monotonic() - generation_start \
                                > healthy_generation_secs:
                            crashes = 0
                        crashes += 1
                        log.warning("trainer crashed rc=%s (%d/%d)", rc,
                                    crashes, max_consecutive_crashes)
                        if crashes >= max_consecutive_crashes:
                            restart_reason = "crash_loop"
                        else:
                            restart_reason = "crash"

            watcher.stop()
            log.info("generation v%d ends: %s", cluster.version,
                     restart_reason)
            if restart_reason == "membership" and job.resize_p2p \
                    and trainer.alive():
                # Live migration: re-form the world FIRST (our claim is
                # still held, the trainer keeps training), then let the
                # running trainer adopt the new generation in place. Its
                # reform watch follows the leader-published cluster; we
                # only wait for its "adopted" ack.
                cluster = bar.cluster_barrier(
                    store, job.job_id, pod.pod_id,
                    after_version=last_version, min_nodes=job.min_nodes,
                    stable_secs=job.barrier_stable_secs,
                    timeout=job.barrier_timeout)
                last_version = cluster.version
                if cluster.rank_of(pod.pod_id) >= 0 and mig.wait_adopted(
                        store, job.job_id, pod.pod_id, cluster.version,
                        timeout=job.adopt_timeout_secs,
                        is_alive=trainer.alive):
                    log.info("trainer pid=%d adopted cluster v%d in "
                             "place", trainer.pid, cluster.version)
                    crashes = 0
                    continue  # same trainer; fresh watcher at loop top
                # Adoption unavailable (the trainer died, has no
                # migration service, or stalled): stop-resume, with the
                # old trainer kept alive as a DONOR so the replacement
                # restores its state from memory instead of disk.
                log.info("in-place adoption unavailable — stop-resume "
                         "with donor linger (pid=%d)", trainer.pid)
                release_trainer(trainer)
                lingering.append([trainer,
                                  time.monotonic()
                                  + job.donor_linger_secs + 5.0])
                trainer = None
                crashes = 0
                continue  # cluster already re-formed: respawn directly
            terminate_trainer(trainer)
            trainer = None
            cluster = None
            if restart_reason == "complete":
                return 0
            if restart_reason == "crash_loop":
                log.error("aborting after %d consecutive crashes", crashes)
                return 1
            if restart_reason == "membership":
                crashes = 0
            if restart_reason in ("lease_lost", "crash"):
                # Re-form the world without us first: drop our claim so the
                # surviving pods' watchers fire, then re-claim. This is how
                # a local trainer failure propagates into a global
                # stop-resume. The gap must stay open longer than the
                # peers' watch poll interval or they miss the blip; peers
                # that still miss it catch the new generation via the
                # watcher's cluster-version check.
                register.release()
                time.sleep(job.rejoin_delay_secs)
                # Safe point to re-pick the coordinator port (it may still
                # be held by the dying trainer): we are absent from the
                # registry, so no snapshot can embed the old value, and the
                # blip forces a new generation from live records.
                pod.port = net.free_port()
                register = reg.PodRegister(store, job.job_id, pod,
                                           max_nodes=job.max_nodes,
                                           ttl=job.lease_ttl)
                register.claim()
    except EdlError as exc:
        log.error("launcher failed: %s", exc)
        return 2
    finally:
        if watcher is not None:
            watcher.stop()
        if trainer is not None:
            if job.resize_p2p:
                # Shrink/shutdown: the trainer turns SIGTERM into a
                # graceful stop and lingers as a donor (own session, so
                # it outlives this launcher). Its linger is self-bounded;
                # releasing the claim below lets it exit early when
                # nobody is left to serve.
                release_trainer(trainer)
            else:
                terminate_trainer(trainer)
        register.release()
        if owns_store:
            try:
                store.close()
            except Exception:  # noqa: BLE001 — teardown
                pass


def parse_args(argv=None) -> tuple[JobEnv, list[str]]:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.collective.launch",
        description="Elastic job launcher (flag else EDL_TPU_* env)")
    parser.add_argument("--job-id", default=None)
    parser.add_argument("--pod-id", default=None)
    parser.add_argument("--store", dest="store_endpoints", default=None,
                        help="coordination store endpoint host:port")
    parser.add_argument("--nodes-range", default=None, help="min:max")
    parser.add_argument("--nproc-per-node", type=int, default=None)
    parser.add_argument("--slices", dest="slices", type=int, default=None,
                        help="slice count (0 = auto; >1 partitions pods "
                             "rank-contiguously)")
    parser.add_argument("--checkpoint-path", default=None)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- trainer command line")
    args = parser.parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("missing trainer command (after --)")
    overrides = {k: v for k, v in vars(args).items()
                 if k != "cmd" and v is not None}
    return JobEnv.from_environ(**overrides), cmd


def _raise_exit(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    # A shrink (or an operator's Ctrl-C on a remote shell) delivers
    # SIGTERM to the launcher only: the trainer runs in its own session.
    # Convert it to SystemExit so launch()'s finally block releases (or
    # kills) the trainer tree and releases the rank claim instead of
    # orphaning a trainer that keeps writing checkpoints against a stale
    # world.
    job, cmd = parse_args(argv)
    signal.signal(signal.SIGTERM, _raise_exit)
    return launch(job, cmd)


if __name__ == "__main__":
    sys.exit(main())
