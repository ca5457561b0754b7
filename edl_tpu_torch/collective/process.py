"""Trainer subprocess management: spawn, log redirect, signal the tree
(copy of ``edl_tpu.collective.process``).

ONE trainer process per launcher, started in its own session (so its own
process group) with stdout+stderr in ``{log_dir}/workerlog.{rank}``; the
signals go to the whole group, so the trainer's loader workers die with
it. ``release_trainer`` SIGTERMs the group without waiting: the donor
path of live state migration.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from dataclasses import dataclass, field

from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.collective.process")


@dataclass
class TrainerProc:
    proc: subprocess.Popen
    log_path: str
    cmd: list[str] = field(default_factory=list)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def returncode(self) -> int | None:
        return self.proc.poll()


def start_trainer(cmd: list[str], env: dict, log_dir: str,
                  rank: int = 0) -> TrainerProc:
    """Spawn the trainer with stdout+stderr -> {log_dir}/workerlog.{rank}."""
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, f"workerlog.{rank}")
    fout = open(log_path, "ab", buffering=0)
    fout.write(f"==== start rank={rank} cmd={cmd} ====\n".encode())
    proc = subprocess.Popen(cmd, env=env, stdout=fout, stderr=fout,
                            start_new_session=True)  # own process group
    log.info("started trainer rank=%d pid=%d log=%s", rank, proc.pid,
             log_path)
    return TrainerProc(proc=proc, log_path=log_path, cmd=list(cmd))


def release_trainer(tp: TrainerProc) -> None:
    """SIGTERM the trainer group and return at once: the donor path of the
    state-migration plane. A migration-enabled trainer turns SIGTERM into
    a graceful stop and a bounded donor linger (it keeps serving its
    sealed snapshot to the re-formed world), so the caller neither blocks
    on it nor escalates to SIGKILL as ``terminate_trainer`` does. The
    caller owns the eventual force-kill deadline (launch.py's reap of
    lingering donors)."""
    if not tp.alive():
        return
    try:
        os.killpg(os.getpgid(tp.pid), signal.SIGTERM)
        log.info("released trainer pid=%d (graceful stop + donor linger)",
                 tp.pid)
    except (ProcessLookupError, PermissionError):
        pass


def terminate_trainer(tp: TrainerProc, grace: float = 10.0) -> None:
    """SIGTERM the process group, escalate to SIGKILL after `grace`."""
    if not tp.alive():
        return
    pgid = None
    try:
        pgid = os.getpgid(tp.pid)
        os.killpg(pgid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        pass
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        if not tp.alive():
            break
        time.sleep(0.1)
    if tp.alive() and pgid is not None:
        log.warning("trainer pid=%d ignored SIGTERM; killing group", tp.pid)
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    try:
        tp.proc.wait(timeout=5.0)
    except subprocess.TimeoutExpired:
        log.error("trainer pid=%d unkillable", tp.pid)
    log.info("trainer pid=%d terminated rc=%s", tp.pid, tp.returncode)
