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

Under the elastic launcher (``collective/launch.py``) with
``EDL_TPU_RESIZE_P2P`` on, the loop joins the state-migration plane
(``collective/migration.py``): it serves its retained sealed snapshot to
peers, restores from live donors before the disk (``try_restore``), turns
SIGTERM into a graceful stop at a step boundary (the live state sealed,
exit 143, the process lingering as a donor), and adopts a resize that
keeps its pod IN PLACE: at a step boundary it walks the reform state
machine (``collective/reform.py``: quiesce, mesh-reform, peer-restore
with the disk fallback, then re-jit and first-step at the next step),
re-enters the epoch at its cursor in the new (rank, world) and acks the
adoption with the measured gap. ``reform_mesh(rank, world, cluster)`` is
the caller's hook that re-forms the world (``parallel/distributed.
reform_world``) and returns the step built for it, or None when this
process's world is unchanged; ``on_reform(rank, world, cluster)``
re-derives the data shard. A `UtilizationPublisher` hook writes the
pod's leased utilization record. With ``EDL_TPU_RESIZE_P2P=0``, or
outside the launcher, a generation is this loop in a fresh process
resuming from the latest sealed checkpoint (stop-resume).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch

from edl_tpu_torch.data import pipeline
from edl_tpu_torch.obs import recorder as flight
from edl_tpu_torch.obs import trace
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
    # the MoE token all-to-all (train/comm.MoEDispatchConfig): flat | hier,
    # and the cross-slice leg's wire, off | int8 (--moe-dispatch and
    # --moe-compress override)
    moe_dispatch: str = field("hier", env="EDL_TPU_MOE_DISPATCH")
    moe_compress: str = field("off", env="EDL_TPU_MOE_COMPRESS")
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
      on_reform: optional ``(rank, world, cluster)`` called after an
        in-place adoption (re-derive the data shard).
      reform_mesh: optional ``(rank, world, cluster) -> step_fn | None``:
        re-form the world and return the step for it (None = this
        process's world is unchanged, the fast adoption path).
      reform_config: the reform machine's deadlines (default: env).
    """

    def __init__(self, step_fn: Callable, state: Any,
                 device: torch.device | str = "cuda",
                 config: LoopConfig | None = None,
                 eval_fn: Callable | None = None,
                 hooks: list[Callable] | None = None,
                 augment_fn: Callable | None = None,
                 on_reform: Callable | None = None,
                 reform_mesh: Callable | None = None,
                 reform_config=None):
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
        self._first_step_done = False
        # Under the elastic launcher: this pod's leased utilization record
        # (never blocks training; a failure only disables publishing).
        try:
            from edl_tpu_torch.coord.collector import UtilizationPublisher
            self._util_publisher = UtilizationPublisher.from_env()
        except Exception:  # noqa: BLE001 — observability is optional
            self._util_publisher = None
        if self._util_publisher is not None:
            self.hooks = list(self.hooks) + [self._util_publisher]
        # The state-migration plane and the reform machine's hooks.
        self.on_reform = on_reform
        self.reform_mesh = reform_mesh
        self._reform_config = reform_config
        self._reform_machine = None
        self.last_reform: dict | None = None
        self._migration = None
        if self.ckpt is not None:
            try:
                from edl_tpu_torch.collective.migration import \
                    MigrationService
                self._migration = MigrationService.from_env(self.ckpt)
            except Exception:  # noqa: BLE001 — the plane is optional;
                log.warning("migration service unavailable",  # train on
                            exc_info=True)
        self.restore_source: str | None = None
        self.bytes_from_peers = 0
        self.reforms = 0
        self.last_reform_downtime_s: float | None = None
        self.stop_reason: str | None = None
        self._reform_t0: float | None = None
        # the in-flight adoption's span: opened at the reform, ended at
        # the first step of the new generation (its duration is the gap)
        self._reform_span = None

    # -- checkpoint glue ---------------------------------------------------

    def try_restore(self) -> bool:
        if self.ckpt is None:
            return False
        self.ckpt.gc_stale_tmp()
        restored = None
        if self._migration is not None:
            # Peer first: live donors serve the state from memory over
            # the tensor wire; disk is the fallback. The local disk
            # version is the fence: a stale donor never beats a newer
            # sealed local checkpoint.
            from edl_tpu_torch.collective.migration import PeerRestoreError
            t0 = time.perf_counter()
            try:
                state, status, stats = self._migration.restore_from_peers(
                    self.state, local_version=self.ckpt.latest_version())
                restored = (state, status)
                self.restore_source = "peers"
                self.bytes_from_peers = int(stats["bytes_from_peers"])
                self.restored_version = int(stats["version"])
                self.ckpt.last_restore_s = time.perf_counter() - t0
            except PeerRestoreError as exc:
                log.info("peer restore unavailable (%s) — falling back "
                         "to disk", exc)
        if restored is None:
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                self.restore_source = "disk"
                self.restored_version = self.ckpt.last_restored_version
        self.restore_s = self.ckpt.last_restore_s
        if restored is None:
            return False
        self.state, self.status = restored
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

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _adopt(self, reform) -> str:
        """Adopt a resize in place: the new cluster still contains this
        pod, so instead of dying into a stop-resume it walks the reform
        state machine. A world the hook reports unchanged keeps the fast
        path (no seal, no restore); a re-formed world pays quiesce-seal
        -> mesh-reform -> peer-restore (disk fallback) inside this
        process, with re-jit and first-step measured at the next step.
        Returns "reform" (in place) or "stop", the clean stop-resume
        downgrade when a phase missed its deadline or failed past its
        fallback."""
        from edl_tpu_torch.collective import reform as rf
        self._reform_t0 = time.perf_counter()
        if trace.enabled():
            from edl_tpu_torch.collective.migration import resize_trace_ctx
            self._reform_span = trace.start_span(
                "resize.adopt",
                parent=resize_trace_ctx(self._migration.store,
                                        self._migration.job_id),
                attrs={"pod": self._migration.pod_id,
                       "rank": reform.rank, "world": reform.world_size,
                       "generation": reform.generation})
        log.info("live-reform: adopting cluster v%d rank=%d world=%d in "
                 "place (no respawn)", reform.generation, reform.rank,
                 reform.world_size)
        machine = rf.ReformMachine(
            reform.generation, self._reform_config,
            trace_parent=(self._reform_span.context
                          if self._reform_span is not None else None),
            who=self._migration.pod_id)
        self._reform_machine = machine
        changed: dict = {}
        try:
            machine.run_phase("quiesce", self._reform_quiesce)
            machine.run_phase(
                "mesh-reform",
                lambda dl: changed.update(
                    step=self._reform_mesh_phase(reform, dl)))
            if changed.get("step") is not None:
                try:
                    machine.run_phase("peer-restore",
                                      self._reform_restore_peers)
                    machine.restore = "peers"
                except rf.ReformError as exc:
                    if exc.downgrade != "disk":
                        raise
                    log.warning("reform peer-restore failed (%s) — "
                                "disk-restore downgrade", exc)
                    machine.run_phase("disk-restore",
                                      self._reform_restore_disk)
                    machine.restore = "disk"
                self.status.world_size = distributed.world_size()
            machine.result = rf.IN_PLACE
        except rf.ReformError as exc:
            # The defined downgrade, a clean stop-resume: this trainer
            # behaves as on a graceful SIGTERM (run() seals the live
            # state, exits 143, the migration shutdown lingers as a
            # donor) and the launcher's adopt timeout respawns the world.
            # A half-reformed survivor never acks.
            machine.result = rf.STOP_RESUME
            machine.error = str(exc)
            self.last_reform = machine.finish()
            self._reform_machine = None
            log.warning("reform of generation %d degraded to "
                        "stop-resume: %s", reform.generation, exc)
            self.stop_reason = "reform-downgrade"
            self._migration.stop_requested.set()
            if self._reform_span is not None:
                self._reform_span.end(result=machine.result,
                                      error=machine.error)
                self._reform_span = None
            self._reform_t0 = None
            return "stop"
        if self.on_reform is not None:
            self.on_reform(reform.rank, reform.world_size, reform.cluster)
        if self._util_publisher is not None:
            # rates are tagged with the allocation that produced them
            self._util_publisher.world_size = reform.world_size
            self._util_publisher.generation = reform.generation
        self.is_leader = distributed.rank() == 0
        self._migration.adopted(reform)
        self.reforms += 1
        return "reform"

    # -- reform phase executors (collective/reform.py ladder) --------------

    def _reform_quiesce(self, deadline: float) -> None:
        """Settle the device and, for a re-formed world, seal the LIVE
        state: peer-restore then reassembles exactly this step, so a
        reform loses no progress. Adoptions without a world hook keep the
        cheap drain."""
        if self._first_step_done:
            self._sync_device()
        if self.ckpt is None:
            return
        if self.reform_mesh is not None:
            self._save()
        # TimeoutError here is the typed quiesce failure the machine
        # downgrades on (a writer that cannot drain is a torn world)
        self.ckpt.wait(timeout=max(0.1, deadline - time.monotonic()))
        if self._migration is not None and self.reform_mesh is not None:
            # make the fresh seal discoverable before peer-restore runs
            self._migration.flush_advert()

    def _reform_mesh_phase(self, reform, deadline: float):
        """Apply the new world: the hook re-forms the process group and
        returns the step built for it, or None when this process's world
        is unchanged (the fast adoption path)."""
        del deadline  # cooperative: the hook gets the machine's budget
        if self.reform_mesh is None:
            return None
        step = self.reform_mesh(reform.rank, reform.world_size,
                                reform.cluster)
        if step is None:
            return None
        log.info("reform: world re-formed — rank %d of %d",
                 distributed.rank(), distributed.world_size())
        self.step_fn = step
        return step

    def _reform_target(self):
        """The state the restore writes into: the live state, whose
        tensors a restore writes only once every chunk has arrived (a
        failed fetch leaves them as they were)."""
        return self.state

    def _reform_restore_peers(self, deadline: float) -> None:
        del deadline  # restore_from_peers carries its own wire timeouts
        # A replicated state restores from this pod's OWN just-sealed
        # snapshot: per-pod version counters are not comparable, and each
        # pod's state is its own lineage.
        state, status, stats = self._migration.restore_from_peers(
            self._reform_target(),
            local_version=self.ckpt.latest_version()
            if self.ckpt else None, pods=[self._migration.pod_id])
        self.state = state
        self.status = status
        self.restore_source = "peers"
        self.bytes_from_peers = int(stats["bytes_from_peers"])

    def _reform_restore_disk(self, deadline: float) -> None:
        del deadline
        restored = self.ckpt.restore_local(self._reform_target()) \
            if self.ckpt else None
        if restored is None:
            raise RuntimeError("no sealed local checkpoint to fall "
                               "back to")
        self.state, self.status = restored
        self.restore_source = "disk"

    def ckpt_stats(self) -> dict:
        """Checkpoint accounting for the benchmark log: the loop's stall
        totals, the manager's snapshot/write/supersede stats, and the
        migration plane's (restore source, bytes from peers, reforms and
        the last reform's gap and outcome)."""
        out = {"ckpt_save_stall_ms_total": round(self.ckpt_stall_ms_total, 3),
               "ckpt_save_stall_ms_mean": round(
                   self.ckpt_stall_ms_total / self.ckpt_saves, 3)
               if self.ckpt_saves else 0.0,
               "ckpt_saves": self.ckpt_saves,
               "ckpt_async": bool(self.config.ckpt_async)}
        if self.restore_s is not None:
            out["ckpt_restore_s"] = round(self.restore_s, 3)
        out["restore_source"] = self.restore_source
        out["bytes_from_peers"] = self.bytes_from_peers
        out["reforms"] = self.reforms
        if self.last_reform_downtime_s is not None:
            out["reform_downtime_s"] = round(
                self.last_reform_downtime_s, 4)
        if self.last_reform is not None:
            out["reform"] = self.last_reform
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
                outcome = self._run_epoch(epoch, data_fn)
                while outcome == "reform":
                    # in-place adoption: the same epoch re-entered at the
                    # step cursor in the new (rank, world); the state
                    # never left the device
                    outcome = self._run_epoch(epoch, data_fn)
                if outcome == "stop":
                    # Graceful stop (SIGTERM under the launcher): seal the
                    # live state so the donor linger serves the freshest
                    # state, then exit 143. Raising, not returning: a
                    # main that returns 0 would read to the launcher as
                    # "training complete".
                    log.info("graceful stop at epoch %d step %d",
                             epoch, self.status.step)
                    self._save()
                    raise SystemExit(143)
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
            self._close_planes()
            closer = getattr(data_fn, "close", None)
            if callable(closer):
                closer()

    def _close_planes(self) -> None:
        if self._migration is not None:
            if self._migration.stop_requested.is_set():
                # a stopping rank leaves its process group before it
                # lingers: a peer blocked in a collective with it raises
                # now instead of when this process exits
                distributed.leave()
            # after ckpt.close(), so the drained final snapshot is the
            # one served: on a graceful stop this lingers as a donor
            # until the re-formed world acks (bounded)
            try:
                self._migration.shutdown()
            except Exception:  # noqa: BLE001 — teardown
                log.exception("migration shutdown failed")
        # a dead trainer's utilization record must expire, not stay fresh
        if self._util_publisher is not None:
            self._util_publisher.stop()

    def close(self) -> None:
        """Teardown for a loop that never ran: drain the checkpoint
        writer, stop the migration donor and the utilization publisher.
        ``run()`` does the same on its way out; idempotent."""
        if self.ckpt is not None:
            self.ckpt.close(raise_errors=False)
        self._close_planes()

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

    def _run_epoch(self, epoch: int, data_fn) -> str | None:
        """One epoch from the cursor. Returns None at its end, "stop" on
        a graceful stop and "reform" after an in-place adoption (checked
        at each step boundary)."""
        cfg = self.config
        log_every = max(1, cfg.log_every_steps)
        window_start = time.perf_counter()
        window_samples = 0
        rejit_s = 0.0  # the first dispatch of an adopted generation
        skip = self.status.step_in_epoch
        if skip and self.is_leader:
            log.info("resuming mid-epoch: skipping %d already-trained "
                     "batches of epoch %d", skip, epoch)
        it = self._epoch_iter(data_fn(epoch), skip)
        for i, batch in it:
            if self._migration is not None:
                if self._migration.stop_requested.is_set():
                    # graceful stop: leave at the boundary with the cursor
                    # intact; run() seals the live state
                    self.stop_reason = "sigterm"
                    it.close()
                    return "stop"
                reform = self._migration.poll_reform()
                if reform is not None:
                    it.close()
                    return self._adopt(reform)
            self._profile_window()
            n = int(next(iter(batch.values())).shape[0])
            t_dispatch = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            if self._reform_t0 is not None:
                # the first step of the adopted generation: its call is
                # the reform ladder's re-jit phase
                rejit_s = time.perf_counter() - t_dispatch
            if not self._first_step_done:
                self._first_step()
            if self._reform_t0 is not None:
                self._first_adopted_step(rejit_s)
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
        return None

    def _first_step(self) -> None:
        """The first step of this run has executed (post-restore): log
        it and ack the restore into the migration plane."""
        self._sync_device()
        self._first_step_done = True
        log.info("first-step-complete global_step=%d restore_s=%s",
                 self.status.step + 1,
                 "%.3f" % self.restore_s if self.restore_s is not None
                 else "none")
        if self._migration is None:
            return
        # the restore ack: this pod is trained-and-running, what lingering
        # donors and a resize audit key on
        self._migration.ack(self.restore_source or "fresh",
                            version=self.restored_version,
                            bytes_from_peers=self.bytes_from_peers,
                            restore_s=self.restore_s)
        if self.restore_source == "peers" and trace.enabled() \
                and self._util_publisher is not None:
            # a grown pod's first fresh util closes the resize trace
            from edl_tpu_torch.collective.migration import resize_trace_ctx
            self._util_publisher.resize_trace = resize_trace_ctx(
                self._migration.store, self._migration.job_id)

    def _first_adopted_step(self, rejit_s: float) -> None:
        """The first step of an adopted generation: the measured gap
        (adoption -> this step done) closes the reform machine's deferred
        phases and goes into the generation-fenced adoption ack."""
        t_block = time.perf_counter()
        self._sync_device()
        now = time.perf_counter()
        gap = now - self._reform_t0
        self._reform_t0 = None
        self.last_reform_downtime_s = gap
        reform_doc = None
        if self._reform_machine is not None:
            machine, self._reform_machine = self._reform_machine, None
            machine.note_deferred("re-jit", rejit_s)
            machine.note_deferred("first-step", now - t_block)
            reform_doc = self.last_reform = machine.finish()
        log.info("reform-step-complete generation=%d downtime_s=%.3f",
                 self._migration.generation, gap)
        flight.record("resize_adopt", pod=self._migration.pod_id,
                      generation=self._migration.generation,
                      downtime_s=round(gap, 4))
        if self._reform_span is not None:
            # the span covers reform -> first step of the new generation
            self._reform_span.end(downtime_s=round(gap, 4))
            if self._util_publisher is not None:
                self._util_publisher.resize_trace = \
                    self._reform_span.context
            self._reform_span = None
        self._migration.ack(
            "adopted", downtime_s=round(gap, 4),
            bytes_from_peers=self.bytes_from_peers
            if reform_doc and reform_doc.get("restore") == "peers" else 0,
            reform=reform_doc)


def _fmt(metrics: dict) -> str:
    return " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
