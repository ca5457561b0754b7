"""Elastic task dispenser: file-shard leasing over the coordination store
(port of ``edl_tpu.data.task_master``; the task records' bytes are the
JAX package's, so trainers of both packages share one epoch's table on
one store server).

Capability of the reference's Go master task service (pkg/master/
service.go:17-66,95-208 — GetTask/TaskFinished/TaskErrored/NewEpoch with a
Todo/Pending/Done/Failed state machine and timeout->requeue, over a
file-list dataset, pkg/master/file_list_dataset.go:5-39), re-designed for
this stack: instead of a dedicated master daemon owning in-memory queues,
the task state machine lives in the coordination store as one record per
task, and every transition is a compare-and-swap — so any pod can dispense
or consume, a dead consumer's leases expire by wall-clock deadline and the
task is re-claimed by a CAS race (exactly the rank-claim pattern,
collective/register.py), and task state survives coordinator restarts
whenever the store is the durable `edl-store` daemon.

States (value is the task's JSON record; the CAS expect-string is the
exact bytes last read, so two claimers can never both win):

    todo --get_task--> pending(owner, deadline)
    pending --finished--> done
    pending --errored--> todo       (failures+1; failed when > max)
    pending[expired] --get_task--> pending(new owner, failures+1)

Record-level data checkpointing falls out: `done` tasks are never
re-served, so an elastic restart resumes the epoch from the store's task
table instead of re-reading data (reference collective/dataloader.py:
100-120 "PROCSSED" record skip).
"""

from __future__ import annotations

import json
import random
import time
from dataclasses import dataclass
from typing import Sequence

from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.data.task_master")


class EdlTaskError(EdlError):
    pass


@dataclass
class Task:
    """A leased work unit (one file shard / record range)."""

    task_id: int
    epoch: int
    spec: dict
    failures: int
    _key: str = ""
    _raw: str = ""  # exact stored JSON at claim time (CAS expect)


def _task_record(spec: dict, state: str, owner: str = "",
                 deadline: float = 0.0, failures: int = 0) -> str:
    return json.dumps({"spec": spec, "state": state, "owner": owner,
                       "deadline": deadline, "failures": failures},
                      sort_keys=True)


def file_list_specs(files: Sequence[str],
                    records_per_task: int | None = None,
                    counts: Sequence[int] | None = None) -> list[dict]:
    """Task specs from a file list (reference file_list_dataset.go:5-39).

    Without counts: one task per file. With per-file record counts and
    records_per_task, files split into record-range tasks
    {"file", "start", "stop"}.
    """
    if counts is None or records_per_task is None:
        return [{"file": f} for f in files]
    specs = []
    for f, n in zip(files, counts):
        for lo in range(0, n, records_per_task):
            specs.append({"file": f, "start": lo,
                          "stop": min(lo + records_per_task, n)})
    return specs


class TaskMaster:
    """Dispense/lease/complete tasks for one job over the store.

    Args:
      store: coordination store (client or in-mem).
      job_id: namespace.
      owner: this consumer's id (pod id).
      lease_timeout: seconds before an unfinished pending task is
        re-claimable (reference task timeout, cmd/master/master.go:36).
      max_failures: errored/timed-out attempts before a task is failed
        (reference task-timeout-max=3).
    """

    def __init__(self, store: Store, job_id: str, owner: str, *,
                 lease_timeout: float = 60.0, max_failures: int = 3,
                 clock=time.time):
        self.store = store
        self.job_id = job_id
        self.owner = owner
        self.lease_timeout = lease_timeout
        self.max_failures = max_failures
        self._clock = clock
        # Claim-candidate cache: the leftover todo keys of the last full
        # scan. A claim is then one get + one CAS (amortized) instead of
        # a whole-prefix scan + parse per claim — the difference between
        # file-shard granularity (hundreds of tasks) and record-range
        # granularity (10^5+, file_list_specs with records_per_task).
        # Staleness is harmless: every claim re-reads the record and the
        # CAS guards the transition.
        self._cache_epoch: int | None = None
        self._todo_keys: list[str] = []

    # -- keys ---------------------------------------------------------------

    def _epoch_key(self) -> str:
        return f"/{self.job_id}/data/epoch"

    def _task_prefix(self, epoch: int) -> str:
        return f"/{self.job_id}/data/e{epoch}/task/"

    def _task_key(self, epoch: int, task_id: int) -> str:
        return f"{self._task_prefix(epoch)}{task_id:06d}"

    # -- epoch lifecycle ----------------------------------------------------

    def current_epoch(self) -> int | None:
        rec = self.store.get(self._epoch_key())
        return None if rec is None else json.loads(rec.value)["epoch"]

    def init_epoch(self, epoch: int, specs: Sequence[dict]) -> bool:
        """Install the epoch's task table (idempotent; the AddDataSet +
        NewEpoch analogue, service.go:175-188). Returns True if this call
        installed it, False if it already existed."""
        header = json.dumps({"epoch": epoch, "n_tasks": len(specs)})
        cur = self.store.get(self._epoch_key())
        if cur is not None:
            cur_epoch = json.loads(cur.value)["epoch"]
            if cur_epoch >= epoch:
                return False
            if not self.store.compare_and_swap(self._epoch_key(), cur.value,
                                               header):
                return False
        elif not self.store.put_if_absent(self._epoch_key(), header):
            return False
        for i, spec in enumerate(specs):
            self.store.put_if_absent(self._task_key(epoch, i),
                                     _task_record(spec, "todo"))
        log.info("epoch %d installed: %d tasks", epoch, len(specs))
        return True

    # -- dispensing ---------------------------------------------------------

    def _claim(self, rec, epoch: int, failures: int,
               data: dict | None = None) -> Task | None:
        if data is None:
            data = json.loads(rec.value)
        new_raw = _task_record(data["spec"], "pending", self.owner,
                               self._clock() + self.lease_timeout, failures)
        if self.store.compare_and_swap(rec.key, rec.value, new_raw):
            task_id = int(rec.key.rsplit("/", 1)[1])
            return Task(task_id, epoch, data["spec"], failures,
                        _key=rec.key, _raw=new_raw)
        return None

    def get_task(self) -> Task | None:
        """Claim a todo task, or re-claim an expired pending one.

        None means nothing claimable right now: poll again unless
        `epoch_done()`. A timed-out re-claim counts as a failure against
        the task (service.go:134-150); tasks over max_failures are marked
        failed and never re-dispensed.
        """
        epoch = self.current_epoch()
        if epoch is None:
            raise EdlTaskError("no epoch installed")
        if self._cache_epoch != epoch:
            self._cache_epoch, self._todo_keys = epoch, []
        # Fast path: drain cached candidates (re-read + CAS per try).
        # Bounded misses: a mostly-stale cache (another consumer drained
        # the epoch while we stalled) must not turn into O(n) sequential
        # round-trips — after a run of misses, drop it and bulk-rescan.
        misses = 0
        while self._todo_keys and misses < 16:
            rec = self.store.get(self._todo_keys.pop())
            if rec is None:
                misses += 1
                continue
            data = json.loads(rec.value)
            if data["state"] != "todo":
                misses += 1
                continue
            task = self._claim(rec, epoch, data["failures"], data)
            if task is not None:
                return task
            misses += 1
        self._todo_keys = []
        # Cache dry: full scan (also the only place expired pendings and
        # epoch completion are observed — bounded-staleness by design).
        recs, _ = self.store.get_prefix(self._task_prefix(epoch))
        now = self._clock()
        todo, expired = [], []
        for rec in recs:
            data = json.loads(rec.value)
            if data["state"] == "todo":
                todo.append((rec, data))
            elif data["state"] == "pending" and data["deadline"] <= now:
                expired.append((rec, data))
        # Contending consumers spread over the claimable set instead of
        # all CAS-racing the first record.
        random.shuffle(todo)
        for i, (rec, data) in enumerate(todo):
            task = self._claim(rec, epoch, data["failures"])
            if task is not None:
                self._todo_keys = [r.key for r, _ in todo[i + 1:]]
                return task
        for rec, data in expired:
            failures = data["failures"] + 1
            if failures > self.max_failures:
                failed = _task_record(data["spec"], "failed",
                                      failures=failures)
                if self.store.compare_and_swap(rec.key, rec.value, failed):
                    log.warning("task %s failed after %d timeouts",
                                rec.key, failures)
                continue
            task = self._claim(rec, epoch, failures)
            if task is not None:
                log.info("re-claimed expired task %s (owner was %r)",
                         rec.key, data["owner"])
                return task
        return None

    # -- consumer transitions -----------------------------------------------

    def heartbeat(self, task: Task) -> bool:
        """Extend the lease mid-task; False = ownership lost (stop work)."""
        new_raw = _task_record(task.spec, "pending", self.owner,
                               self._clock() + self.lease_timeout,
                               task.failures)
        if self.store.compare_and_swap(task._key, task._raw, new_raw):
            task._raw = new_raw
            return True
        return False

    def finished(self, task: Task) -> bool:
        """pending(us) -> done. False = we lost the lease and another
        consumer owns (or finished) it — the caller must NOT count this
        task's records as its own contribution (exactly-once accounting)."""
        done = _task_record(task.spec, "done", self.owner,
                            failures=task.failures)
        ok = self.store.compare_and_swap(task._key, task._raw, done)
        if not ok:
            log.warning("finished(%s): ownership lost", task._key)
        return ok

    def errored(self, task: Task, reason: str = "") -> None:
        """pending(us) -> todo (or failed past max_failures)."""
        failures = task.failures + 1
        state = "failed" if failures > self.max_failures else "todo"
        new_raw = _task_record(task.spec, state, failures=failures)
        if self.store.compare_and_swap(task._key, task._raw, new_raw):
            log.warning("task %s errored (%s) -> %s", task._key, reason,
                        state)

    # -- progress -----------------------------------------------------------

    def counts(self, epoch: int | None = None) -> dict[str, int]:
        if epoch is None:
            epoch = self.current_epoch()
            if epoch is None:
                raise EdlTaskError("no epoch installed")
        out = {"todo": 0, "pending": 0, "done": 0, "failed": 0}
        recs, _ = self.store.get_prefix(self._task_prefix(epoch))
        for rec in recs:
            out[json.loads(rec.value)["state"]] += 1
        return out

    def epoch_done(self, epoch: int | None = None) -> bool:
        """True when nothing is left to dispense or wait for."""
        c = self.counts(epoch)
        return c["todo"] == 0 and c["pending"] == 0
