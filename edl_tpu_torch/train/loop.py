"""Epoch-based training loop with checkpoint/resume (port of
``edl_tpu.train.loop``).

``TrainLoop.run`` restores the latest checkpoint (``try_restore``: the
state is written into its live tensors and the resume cursor
``TrainStatus`` comes back with it), then drives
``step_fn(state, batch) -> (state, metrics)`` over epochs from that
cursor. A mid-epoch checkpoint's ``step_in_epoch`` batches of the
resumed epoch are skipped before the loop places them; the loader
replays the same order, so the remainder is the uninterrupted run's. Each batch is placed
on the loop's device (with ``prefetch_batches > 0`` on a staging
thread's side stream, ``data/pipeline.prefetch_to_device``; batches the
data_fn already placed pass through), optionally augmented on the device
(``augment_fn`` with the loader's per-step seed), stepped and counted.
Saves, async by default (``ckpt_async``): every ``ckpt_every_steps``
steps, every ``ckpt_every_epochs`` epochs and at the last epoch; the
epoch's save is made durable (``wait()``) before the next epoch, and the
writer is drained on the way out, crash paths too. Every
``log_every_steps`` the metrics are read back (the loop's only host sync
outside saves), logged and handed to the hooks; after each epoch
``eval_fn(state, epoch)`` runs. ``profile_dir`` takes a torch.profiler
trace of ``profile_steps`` steps from global step
``profile_start_step`` on rank 0. The loop closes the data plane it
drives (``data_fn.close``). In a world of several ranks the status
counts the world, the step's metrics are already the world's means, rank
0 logs and writes checkpoints, and every rank restores.

Under the elastic launcher a generation is this loop in a fresh
process, resuming from the latest sealed checkpoint (stop-resume).
In-place reform, p2p migration, the graceful SIGTERM stop and the
utilization publisher come with the live half of the elastic trainer
side (ROADMAP Queue 1 item 16b).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch

from edl_tpu_torch.data import pipeline
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.state import TrainStatus
from edl_tpu_torch.utils.config import field
from edl_tpu_torch.utils.logging import get_logger
from edl_tpu_torch.utils.timeline import DeviceTrace

log = get_logger("edl_tpu_torch.train.loop")


@dataclass
class LoopConfig:
    num_epochs: int = field(1, env="EDL_TPU_NUM_EPOCHS")
    log_every_steps: int = field(20, env="EDL_TPU_LOG_EVERY")
    ckpt_dir: str | None = field(None, env="EDL_TPU_CHECKPOINT_PATH")
    ckpt_every_epochs: int = field(1, env="EDL_TPU_SAVE_CHECKPOINT_INTER")
    # step-interval saves shrink the replay window after a restart
    ckpt_every_steps: int = field(0, env=("EDL_TPU_CKPT_STEPS",
                                          "EDL_TPU_SAVE_CHECKPOINT_STEPS"))
    ckpt_max_to_keep: int = field(3, env="EDL_TPU_CHECKPOINT_KEEP")
    # async snapshot-then-write saves; False = every save a full stall,
    # the same bytes
    ckpt_async: bool = field(True, env="EDL_TPU_CKPT_ASYNC")
    ckpt_sharded: bool = field(False, env="EDL_TPU_CHECKPOINT_SHARDED")
    ckpt_remote: str | None = field(None, env="EDL_TPU_CKPT_REMOTE")
    profile_dir: str | None = field(None, env="EDL_TPU_PROFILE_DIR")
    profile_start_step: int = field(10, env="EDL_TPU_PROFILE_START")
    profile_steps: int = field(5, env="EDL_TPU_PROFILE_STEPS")
    # batches placed ahead on a staging thread (0 = inline placement)
    prefetch_batches: int = field(0, env="EDL_TPU_PREFETCH_BATCHES")
    # the entry points' DataLoader num_workers when --loader-workers is
    # not given
    loader_workers: int = field(0, env="EDL_TPU_LOADER_WORKERS")
    comm_bucket_mb: float = field(0.0, env="EDL_TPU_COMM_BUCKET_MB")
    dcn_compress: str = field("off", env="EDL_TPU_DCN_COMPRESS")
    fused_opt: str = field("off", env="EDL_TPU_FUSED_OPT")
    opt_quant: str = field("", env="EDL_TPU_OPT_QUANT")


class TrainLoop:
    """Drives (state, batch) -> (state, metrics) steps over epochs.

    Args:
      step_fn: called as step_fn(state, batch) with the batch on ``device``.
      state: the TrainState (restored in place if a checkpoint exists).
      device: where batches go (torch.device or str).
      config: LoopConfig.
      eval_fn: optional callable(state, epoch) -> dict, run after each epoch.
      hooks: optional callables(loop, epoch, step, metrics) run at log points.
      augment_fn: optional device augment ``(placed_batch, seed) ->
        batch`` (``ops.augment.make_device_augment``) for host batches
        that carry the loader's ``augment_seed``.
    """

    def __init__(self, step_fn: Callable, state: Any,
                 device: torch.device | str = "cuda",
                 config: LoopConfig | None = None,
                 eval_fn: Callable | None = None,
                 hooks: list[Callable] | None = None,
                 augment_fn: Callable | None = None):
        self.step_fn = step_fn
        self.state = state
        self.device = torch.device(device)
        self.config = config or LoopConfig()
        self.eval_fn = eval_fn
        self.hooks = hooks or []
        self.augment_fn = augment_fn
        self.status = TrainStatus(world_size=distributed.world_size())
        self.is_leader = distributed.rank() == 0
        cfg = self.config
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, cfg.ckpt_max_to_keep,
                                       sharded=cfg.ckpt_sharded,
                                       remote=cfg.ckpt_remote)
                     if cfg.ckpt_dir else None)
        self.last_metrics: dict = {}
        self._trace: DeviceTrace | None = None
        # step-loop-visible ms spent in _save (the whole write when sync,
        # the snapshot's enqueue when async) and this run's restore time
        self.ckpt_stall_ms_total = 0.0
        self.ckpt_saves = 0
        self.restore_s: float | None = None
        self.restored_version: int | None = None

    # -- checkpoint glue ---------------------------------------------------

    def try_restore(self) -> bool:
        if self.ckpt is None:
            return False
        self.ckpt.gc_stale_tmp()
        restored = self.ckpt.restore(self.state)
        self.restore_s = self.ckpt.last_restore_s
        if restored is None:
            return False
        self.state, self.status = restored
        self.restored_version = self.ckpt.last_restored_version
        self.status.world_size = distributed.world_size()
        if self.is_leader:
            log.info("resumed from ckpt-%s: epoch=%d step=%d "
                     "step_in_epoch=%d", self.restored_version,
                     self.status.epoch, self.status.step,
                     self.status.step_in_epoch)
        return True

    def _save(self, sync: bool | None = None) -> None:
        """Checkpoint now: async unless config.ckpt_async is off or
        ``sync`` says so."""
        if self.ckpt is None:
            return
        use_sync = (not self.config.ckpt_async) if sync is None else sync
        t0 = time.perf_counter()
        if use_sync:
            self.ckpt.save(self.state, self.status)
        else:
            self.ckpt.save_async(self.state, self.status)
        self.ckpt_stall_ms_total += (time.perf_counter() - t0) * 1e3
        self.ckpt_saves += 1

    def ckpt_stats(self) -> dict:
        """Checkpoint accounting for the benchmark log: the loop's stall
        totals and the manager's snapshot/write/supersede stats."""
        out = {"ckpt_save_stall_ms_total": round(self.ckpt_stall_ms_total, 3),
               "ckpt_save_stall_ms_mean": round(
                   self.ckpt_stall_ms_total / self.ckpt_saves, 3)
               if self.ckpt_saves else 0.0,
               "ckpt_saves": self.ckpt_saves,
               "ckpt_async": bool(self.config.ckpt_async)}
        if self.restore_s is not None:
            out["ckpt_restore_s"] = round(self.restore_s, 3)
        if self.ckpt is not None:
            out.update({f"ckpt_{k}": (round(v, 3)
                                      if isinstance(v, float) else v)
                        for k, v in self.ckpt.stats().items()})
        return out

    # -- main loop ---------------------------------------------------------

    def _place(self, batch: dict) -> dict:
        """A host batch onto the device (pinned, non-blocking on a card),
        then the device augment with the loader's seed; a batch of
        tensors already on the device passes through."""
        seed = None
        if self.augment_fn is not None or pipeline.AUGMENT_SEED_KEY in batch:
            batch, seed = pipeline.pop_augment_seed(batch, self.augment_fn)
        placed = {k: v if isinstance(v, torch.Tensor)
                  else pipeline.place_array(v, self.device)
                  for k, v in batch.items()}
        if self.augment_fn is not None:
            placed = self.augment_fn(placed, seed)
        return placed

    def run(self, data_fn: Callable[[int], Iterable]) -> TrainStatus:
        """Train from the resume point to num_epochs. ``data_fn(epoch)``
        returns the epoch's batch iterator, its order derived from the
        epoch number (seed-per-pass), so a restart replays it."""
        try:
            self.try_restore()
            cfg = self.config
            start_epoch = self.status.next_epoch()
            if start_epoch >= cfg.num_epochs:
                log.info("training already complete (epoch=%d)",
                         self.status.epoch)
                return self.status
            for epoch in range(start_epoch, cfg.num_epochs):
                self._run_epoch(epoch, data_fn)
                self.status.epoch = epoch
                self.status.step_in_epoch = 0
                if (epoch + 1) % max(1, cfg.ckpt_every_epochs) == 0 \
                        or epoch == cfg.num_epochs - 1:
                    self._save()
                if self.eval_fn is not None:
                    results = self.eval_fn(self.state, epoch)
                    if self.is_leader:
                        log.info("eval epoch %d: %s", epoch, _fmt(results))
                if self.ckpt is not None:
                    # the epoch's save is durable before the next epoch
                    # (its write overlapped eval), and a background
                    # failure surfaces here
                    self.ckpt.wait()
            if self._trace is not None:   # a run shorter than the window
                self._stop_trace()
            if self.ckpt_saves and self.is_leader:
                log.info("ckpt plane: %s", self.ckpt_stats())
            return self.status
        finally:
            if self._trace is not None:
                self._stop_trace()
            if self.ckpt is not None:
                # drain the pending snapshot without masking an exception
                # in flight; clean-path errors surfaced at wait() above
                self.ckpt.close(raise_errors=False)
            closer = getattr(data_fn, "close", None)
            if callable(closer):
                closer()

    def _stop_trace(self) -> None:
        trace, self._trace = self._trace, None
        log.info("profiler: trace written to %s", trace.stop())

    def _profile_window(self) -> None:
        """Open and close the torch.profiler window at the configured
        global steps (rank 0 only)."""
        cfg = self.config
        if cfg.profile_dir is None or not self.is_leader:
            return
        if self.status.step == cfg.profile_start_step \
                and self._trace is None:
            log.info("profiler: tracing steps %d..%d -> %s",
                     cfg.profile_start_step,
                     cfg.profile_start_step + cfg.profile_steps,
                     cfg.profile_dir)
            self._trace = DeviceTrace(cfg.profile_dir)
            self._trace.start()
        elif self._trace is not None and self.status.step >= \
                cfg.profile_start_step + cfg.profile_steps:
            self._stop_trace()

    def _epoch_iter(self, src: Iterable, skip: int):
        """(index, placed batch) pairs from ``skip`` on. The loop places
        no skipped batch (a data_fn that places its own, as
        imagenet_train's prefetch does, has placed them already); with
        ``prefetch_batches > 0`` placement runs on a staging thread that
        many batches ahead."""
        end = object()
        it = iter(src)
        for _ in range(skip):
            if next(it, end) is end:
                return
        if self.config.prefetch_batches > 0:
            staged = pipeline.prefetch_to_device(
                it, self.device, size=self.config.prefetch_batches,
                augment=self.augment_fn)
            try:
                yield from enumerate(staged, start=skip)
            finally:
                staged.close()
        else:
            for i, batch in enumerate(it, start=skip):
                yield i, self._place(batch)

    def _run_epoch(self, epoch: int, data_fn) -> None:
        cfg = self.config
        log_every = max(1, cfg.log_every_steps)
        window_start = time.perf_counter()
        window_samples = 0
        skip = self.status.step_in_epoch
        if skip and self.is_leader:
            log.info("resuming mid-epoch: skipping %d already-trained "
                     "batches of epoch %d", skip, epoch)
        for i, batch in self._epoch_iter(data_fn(epoch), skip):
            self._profile_window()
            n = int(next(iter(batch.values())).shape[0])
            self.state, metrics = self.step_fn(self.state, batch)
            self.status.step += 1
            self.status.step_in_epoch = i + 1
            self.status.samples_seen += n
            window_samples += n
            if cfg.ckpt_every_steps and \
                    self.status.step % cfg.ckpt_every_steps == 0:
                self._save()
            if self.status.step % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                self.last_metrics = metrics
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
