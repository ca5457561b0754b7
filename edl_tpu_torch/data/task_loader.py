"""File-backed, elastically-dispensed batch iteration (port of
``edl_tpu.data.task_loader``; batches are host numpy, moving them to the
card is the trainer's job).

The consumer half of the task-dispenser story — the working replacement
for the reference's WIP DataLoader-over-data-server (collective/
dataloader.py:26-120 pulls file shards from the leader and skips
already-processed records; utils/data_server.py:57-108 serves records):
each pod's `TaskDataLoader` leases file-shard tasks from the `TaskMaster`
table, loads the file on host, yields fixed-size batches, and marks the
task done — so a killed pod's in-flight shards are re-dispensed to
survivors after the lease timeout, completed shards are never re-read,
and "which records are trained" is exactly the store's task table.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Sequence

import numpy as np

from edl_tpu_torch.data.task_master import Task, TaskMaster
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.data.task_loader")


def npz_loader(spec: dict) -> dict[str, np.ndarray]:
    """Load {"file": x.npz[, "start", "stop"]} into a dict of arrays."""
    with np.load(spec["file"]) as data:
        arrays = {k: data[k] for k in data.files}
    if "start" in spec:
        arrays = {k: v[spec["start"]:spec["stop"]] for k, v in arrays.items()}
    return arrays


def text_loader(spec: dict) -> dict[str, np.ndarray]:
    """Load a text file into {"line": bytes array} (reference
    TxtDataReader, collective/dataset.py:33)."""
    with open(spec["file"], "rb") as f:
        lines = f.read().splitlines()
    if "start" in spec:
        lines = lines[spec["start"]:spec["stop"]]
    return {"line": np.array(lines, dtype=object)}


class TaskDataLoader:
    """Iterate batches of the epoch's dispensed file shards.

    Args:
      master: the TaskMaster (one per pod, distinct owners).
      loader_fn: spec dict -> dict of equal-length arrays (host).
      batch_size: rows per yielded batch.
      drop_remainder: drop the file's trailing partial batch.
      transforms: (batch, np.random.Generator) -> batch host hooks.
      poll: seconds between get_task retries while peers hold leases.
      heartbeat_every: extend the task lease after this many seconds of
        yielding (long files vs short lease timeouts).
    """

    def __init__(self, master: TaskMaster, loader_fn: Callable[[dict], dict],
                 batch_size: int, *, drop_remainder: bool = False,
                 transforms: Sequence[Callable] = (), poll: float = 0.2,
                 seed: int = 0, heartbeat_every: float = 10.0):
        self.master = master
        self.loader_fn = loader_fn
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.transforms = list(transforms)
        self.poll = poll
        self.seed = seed
        self.heartbeat_every = heartbeat_every
        self.tasks_completed = 0
        self.tasks_lost = 0

    def _task_batches(self, task: Task, rng) -> Iterator[dict]:
        arrays = self.loader_fn(task.spec)
        n = len(next(iter(arrays.values())))
        stop = (n // self.batch_size * self.batch_size
                if self.drop_remainder else n)
        last_beat = time.monotonic()
        for lo in range(0, stop, self.batch_size):
            hi = min(lo + self.batch_size, stop)
            batch = {k: v[lo:hi] for k, v in arrays.items()}
            for t in self.transforms:
                batch = t(batch, rng)
            if time.monotonic() - last_beat > self.heartbeat_every:
                if not self.master.heartbeat(task):
                    # Lease lost (e.g. we stalled past the timeout and the
                    # shard was re-dispensed): stop contributing this task.
                    return
                last_beat = time.monotonic()
            yield batch

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Yield batches until the epoch's task table is drained."""
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        while True:
            task = self.master.get_task()
            if task is None:
                if self.master.epoch_done():
                    return
                time.sleep(self.poll)
                continue
            try:
                yield from self._task_batches(task, rng)
            except Exception as exc:
                self.master.errored(task, f"{type(exc).__name__}: {exc}")
                raise
            if self.master.finished(task):
                self.tasks_completed += 1
            else:
                self.tasks_lost += 1

    def __call__(self, epoch: int) -> Iterator[dict]:
        # TrainLoop data_fn signature.
        return self.epoch(epoch)
