"""Epoch-based training loop (trimmed port of ``edl_tpu.train.loop``).

``TrainLoop.run`` drives ``step_fn(state, batch) -> (state, metrics)``
over epochs from the resume cursor (``TrainStatus``): each batch is
placed on the loop's device (a pinned, non-blocking host-to-device copy
on a card), stepped, and counted; every ``log_every_steps`` the metrics
are read back (the loop's only host sync), logged and handed to the
hooks; after each epoch ``eval_fn(state, epoch)`` runs. In a world of
several ranks (``parallel/distributed``) the status counts the world,
the step's metrics are already the world's means, and only rank 0 logs.

Not ported yet, and raising when asked for: checkpoints (``ckpt_dir``,
ROADMAP Queue 1 item 8), the profiler window (``profile_dir``, item 8),
host-to-device prefetch on a staging thread (``prefetch_batches > 0``,
item 8). Elastic reform, p2p migration and the utilization publisher
come with the multi-GPU world (item 10).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch

from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.train.state import TrainStatus
from edl_tpu_torch.utils.config import field
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.train.loop")


@dataclass
class LoopConfig:
    num_epochs: int = field(1, env="EDL_TPU_NUM_EPOCHS")
    log_every_steps: int = field(20, env="EDL_TPU_LOG_EVERY")
    loader_workers: int = field(0, env="EDL_TPU_LOADER_WORKERS")
    # knobs of the JAX package's loop and entry points that the port
    # reads to refuse what it does not carry yet (here and in lm_train)
    ckpt_dir: str | None = field(None, env="EDL_TPU_CHECKPOINT_PATH")
    profile_dir: str | None = field(None, env="EDL_TPU_PROFILE_DIR")
    prefetch_batches: int = field(0, env="EDL_TPU_PREFETCH_BATCHES")
    comm_bucket_mb: float = field(0.0, env="EDL_TPU_COMM_BUCKET_MB")
    dcn_compress: str = field("off", env="EDL_TPU_DCN_COMPRESS")
    fused_opt: str = field("off", env="EDL_TPU_FUSED_OPT")
    opt_quant: str = field("", env="EDL_TPU_OPT_QUANT")

    def __post_init__(self):
        if self.ckpt_dir:
            raise NotImplementedError(
                "checkpoints (ckpt_dir / EDL_TPU_CHECKPOINT_PATH) are not "
                "ported yet (ROADMAP Queue 1 item 8)")
        if self.profile_dir:
            raise NotImplementedError(
                "the profiler window (profile_dir, torch.profiler) is not "
                "ported yet (ROADMAP Queue 1 item 8)")
        if self.prefetch_batches > 0:
            raise NotImplementedError(
                "host-to-device prefetch on a staging thread "
                "(prefetch_batches > 0) is not ported yet (ROADMAP Queue 1 "
                "item 8); batches are placed inline")


class TrainLoop:
    """Drives (state, batch) -> (state, metrics) steps over epochs.

    Args:
      step_fn: called as step_fn(state, batch) with the batch on ``device``.
      state: the TrainState.
      device: where batches go (torch.device or str).
      config: LoopConfig.
      eval_fn: optional callable(state, epoch) -> dict, run after each epoch.
      hooks: optional callables(loop, epoch, step, metrics) run at log points.
    """

    def __init__(self, step_fn: Callable, state: Any,
                 device: torch.device | str = "cuda",
                 config: LoopConfig | None = None,
                 eval_fn: Callable | None = None,
                 hooks: list[Callable] | None = None):
        self.step_fn = step_fn
        self.state = state
        self.device = torch.device(device)
        self.config = config or LoopConfig()
        self.eval_fn = eval_fn
        self.hooks = hooks or []
        self.status = TrainStatus(world_size=distributed.world_size())
        self.is_leader = distributed.rank() == 0

    def _place(self, batch: dict) -> dict:
        """Host numpy -> tensors on the device: pinned and non-blocking on
        a card (the copy overlaps the host's next dispatches)."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def run(self, data_fn: Callable[[int], Iterable]) -> TrainStatus:
        """Train to num_epochs. ``data_fn(epoch)`` returns the epoch's host
        batch iterator (seed-per-pass)."""
        for epoch in range(self.status.next_epoch(), self.config.num_epochs):
            self._run_epoch(epoch, data_fn(epoch))
            self.status.epoch = epoch
            self.status.step_in_epoch = 0
            if self.eval_fn is not None:
                results = self.eval_fn(self.state, epoch)
                if self.is_leader:
                    log.info("eval epoch %d: %s", epoch, _fmt(results))
        return self.status

    def _run_epoch(self, epoch: int, batches: Iterable) -> None:
        log_every = max(1, self.config.log_every_steps)
        window_start = time.perf_counter()
        window_samples = 0
        for batch in batches:
            n = int(next(iter(batch.values())).shape[0])
            self.state, metrics = self.step_fn(self.state, self._place(batch))
            self.status.step += 1
            self.status.step_in_epoch += 1
            self.status.samples_seen += n
            window_samples += n
            if self.status.step % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                rate = window_samples / max(
                    time.perf_counter() - window_start, 1e-9)
                if self.is_leader:
                    log.info("epoch %d step %d: %s %.1f samples/s",
                             epoch, self.status.step, _fmt(metrics), rate)
                for hook in self.hooks:
                    hook(self, epoch, self.status.step, metrics)
                window_start = time.perf_counter()
                window_samples = 0


def _fmt(metrics: dict) -> str:
    return " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
