"""Reform state machine: survive a device-world change without a restart
(copy of ``edl_tpu.collective.reform``).

A surviving trainer keeps its OS process and walks the phase ladder

    quiesce -> mesh-reform -> peer-restore -> re-jit -> first-step

and every phase carries a **deadline**, a **typed failure**
(`ReformError`) and a **defined downgrade**:

    phase         failure means                     downgrade
    ------------  --------------------------------  -------------------
    quiesce       step/ckpt drain stalled           stop-resume
    mesh-reform   process-group re-formation timed  stop-resume
                  out or failed
    peer-restore  donor died / peer stalled         disk restore
    disk-restore  local disk also unusable          stop-resume
    re-jit        the first step of the new world   stop-resume
                  failed
    first-step    new generation never stepped      stop-resume (via the
                                                    launcher's adopt
                                                    timeout)

"stop-resume" is the clean downgrade, never a wedge: the survivor seals
its live state, exits 143 and lingers as a donor, and the launcher's
``wait_adopted`` timeout respawns the world as a stop-resume would, with
the old generation's state served from memory. A half-reformed survivor
never acks adoption: acks are generation-fenced against the
leader-published cluster doc (``MigrationService.ack``).

In the port a rank's device world is its process group, so mesh-reform
re-forms ``torch.distributed`` (``parallel/distributed.reform_world``)
and re-jit is the first call of the step rebuilt for the new world (no
compile; the name and budget are the JAX package's). The machine itself
is pure stdlib: ``train/loop.py`` drives it with torch-side executors and
reports the same phase/outcome shape.

Deadlines are the ``EDL_TPU_REFORM_*`` knobs; enforcement is cooperative
(executors receive the phase deadline) plus post-hoc: an executor that
returns after its budget is still a typed phase failure. A phase that
never returns is bounded by the launcher's ``EDL_TPU_ADOPT_TIMEOUT``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

from edl_tpu_torch.obs import recorder as flight
from edl_tpu_torch.obs import trace
from edl_tpu_torch.utils.config import field, from_env
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.collective.reform")

# canonical phase order
PHASES = ("quiesce", "mesh-reform", "peer-restore", "disk-restore",
          "re-jit", "first-step")

#: outcome of a completed ladder
IN_PLACE = "in-place"
STOP_RESUME = "stop-resume"

#: phase -> downgrade when it fails (the ladder's one retry is
#: peer-restore -> disk-restore; everything else degrades to a clean
#: stop-resume)
DOWNGRADE = {
    "quiesce": STOP_RESUME,
    "mesh-reform": STOP_RESUME,
    "peer-restore": "disk",
    "disk-restore": STOP_RESUME,
    "re-jit": STOP_RESUME,
    "first-step": STOP_RESUME,
}


@dataclass
class ReformConfig:
    """Per-phase deadlines (seconds). Generous defaults: the budgets turn
    a wedge into a typed downgrade, they do not race the happy path."""

    quiesce_s: float = field(10.0, env="EDL_TPU_REFORM_QUIESCE_S")
    mesh_s: float = field(30.0, env="EDL_TPU_REFORM_MESH_S")
    restore_s: float = field(60.0, env="EDL_TPU_REFORM_RESTORE_S")
    rejit_s: float = field(300.0, env="EDL_TPU_REFORM_REJIT_S")

    def budget(self, phase: str) -> float:
        return {"quiesce": self.quiesce_s,
                "mesh-reform": self.mesh_s,
                "peer-restore": self.restore_s,
                "disk-restore": self.restore_s,
                "re-jit": self.rejit_s,
                "first-step": self.rejit_s}[phase]

    @classmethod
    def from_environ(cls, **overrides) -> "ReformConfig":
        return from_env(cls, **overrides)


class ReformError(EdlError):
    """Typed phase failure; carries the phase and its downgrade."""

    def __init__(self, phase: str, reason: str, downgrade: str):
        super().__init__(f"reform {phase} failed ({downgrade} downgrade):"
                         f" {reason}")
        self.phase = phase
        self.reason = reason
        self.downgrade = downgrade


class ReformMachine:
    """One generation change, walked phase by phase.

    Drive it with `run_ladder` (the canonical order, with the peer->disk
    restore downgrade built in) or phase at a time with `run_phase`.
    Phases the caller cannot run inside the ladder (the loop's re-jit and
    first step happen at the next training step) are recorded afterwards
    with `note_deferred`; `finish()` seals the outcome into the flight
    recorder exactly once.
    """

    def __init__(self, generation: int, config: ReformConfig | None = None,
                 *, trace_parent: tuple[str, str] | None = None,
                 who: str = ""):
        self.generation = generation
        self.config = config or ReformConfig.from_environ()
        self.phases: list[dict] = []   # [{phase, s, ok, error?, overrun?}]
        self.result: str | None = None
        self.restore: str | None = None   # None | "peers" | "disk"
        self.error: str | None = None
        self.who = who
        self._parent = trace_parent
        self._finished = False

    # -- low level -----------------------------------------------------------

    def run_phase(self, name: str, fn: Callable[[float], Any]) -> Any:
        """Run one phase: `fn(deadline)` under a `reform.<name>` span.

        Raises `ReformError` on any exception (typed with the phase's
        downgrade) and on post-hoc deadline overrun: a phase that
        *returns* late still failed its budget."""
        budget = self.config.budget(name)
        t0 = time.monotonic()
        deadline = t0 + budget
        try:
            with trace.span(f"reform.{name}", parent=self._parent,
                            attrs={"generation": self.generation}):
                out = fn(deadline)
        except ReformError as exc:
            self.phases.append({"phase": name,
                                "s": round(time.monotonic() - t0, 4),
                                "ok": False, "error": str(exc)})
            raise
        except Exception as exc:  # noqa: BLE001 — every phase failure
            # becomes the TYPED error its downgrade is keyed on
            self.phases.append({"phase": name,
                                "s": round(time.monotonic() - t0, 4),
                                "ok": False, "error": str(exc)})
            raise ReformError(name, str(exc), DOWNGRADE[name]) from exc
        elapsed = time.monotonic() - t0
        if elapsed > budget:
            self.phases.append({"phase": name, "s": round(elapsed, 4),
                                "ok": False, "overrun": True,
                                "error": f"deadline exceeded "
                                         f"({elapsed:.3f}s > {budget}s)"})
            raise ReformError(
                name, f"deadline exceeded ({elapsed:.3f}s > {budget}s)",
                DOWNGRADE[name])
        self.phases.append({"phase": name, "s": round(elapsed, 4),
                            "ok": True})
        return out

    # -- the canonical ladder -------------------------------------------------

    def run_ladder(self, *, quiesce: Callable | None = None,
                   mesh_reform: Callable | None = None,
                   restore_peers: Callable | None = None,
                   restore_disk: Callable | None = None,
                   rejit: Callable | None = None) -> "ReformMachine":
        """Walk the phases in order. A `None` executor skips its phase.
        peer-restore failure retries as disk-restore; any other failure,
        or a disk failure, lands the outcome on the clean stop-resume
        downgrade. Never raises."""
        try:
            if quiesce is not None:
                self.run_phase("quiesce", quiesce)
            if mesh_reform is not None:
                self.run_phase("mesh-reform", mesh_reform)
            if restore_peers is not None:
                try:
                    self.run_phase("peer-restore", restore_peers)
                    self.restore = "peers"
                except ReformError as exc:
                    if exc.downgrade != "disk" or restore_disk is None:
                        raise
                    log.warning("reform gen=%d: %s — disk-restore "
                                "downgrade", self.generation, exc)
                    self.run_phase("disk-restore", restore_disk)
                    self.restore = "disk"
            if rejit is not None:
                self.run_phase("re-jit", rejit)
            self.result = IN_PLACE
        except ReformError as exc:
            self.result = STOP_RESUME
            self.error = str(exc)
            log.warning("reform gen=%d degraded to stop-resume: %s",
                        self.generation, exc)
        return self

    # -- deferred phases (loop-side re-jit / first-step) ----------------------

    def note_deferred(self, name: str, seconds: float,
                      ok: bool = True, error: str | None = None) -> None:
        """Record a phase measured outside the ladder (the loop's first
        post-reform step IS re-jit + first-step). Deadline overruns are
        flagged but do not downgrade after the fact: the step already
        ran; the launcher's adopt timeout is the hard bound on this
        tail."""
        budget = self.config.budget(name)
        rec = {"phase": name, "s": round(seconds, 4), "ok": ok}
        if error:
            rec["error"] = error
        if seconds > budget:
            rec["overrun"] = True
        self.phases.append(rec)

    def finish(self) -> dict:
        """Seal the outcome (idempotent): one flight-recorder event per
        reform, and the dict the adoption ack carries."""
        doc = self.to_dict()
        if not self._finished:
            self._finished = True
            flight.record("reform", who=self.who,
                          generation=self.generation,
                          result=self.result, restore=self.restore,
                          error=self.error,
                          phases={p["phase"]: p["s"] for p in self.phases})
        return doc

    def phase_seconds(self) -> dict[str, float]:
        return {p["phase"]: p["s"] for p in self.phases}

    def to_dict(self) -> dict:
        return {"generation": self.generation, "result": self.result,
                "restore": self.restore, "error": self.error,
                "phases": self.phases}


def wait_until(pred: Callable[[], bool], deadline: float,
               interval: float = 0.05) -> bool:
    """Cooperative-deadline poll helper for phase executors: True when
    `pred` held before `deadline` (monotonic), False on timeout."""
    while True:
        if pred():
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(min(interval, max(0.0, deadline - time.monotonic())))
