"""Versioned atomic checkpoints with resume status (port of
``edl_tpu.train.checkpoint``).

The contract is the JAX package's, and so is every byte on disk:

- rank 0 writes, every rank loads; in a world rank 0 picks the version
  and broadcasts it (``torch.distributed``). A sharded save in a world
  (``sharded=True``) is every rank's: each writes its own chunks and
  ``index.{rank}.json`` into the version's temp dir between the JAX
  package's barriers (begin, clean, chunks), and rank 0 seals it
  (``_save_sharded_world``; synchronous, as the JAX package's
  multi-process sharded saves are). A sharded state
  (``parallel/sharding.shard_module``: fsdp, tp or both) in the
  replicated format is gathered to rank 0, which writes it; in the
  sharded format each slice is written once, by its replica 0; restoring
  into one reads only this rank's regions
  (``bridge.flax_to_state_sharded``);
- a save is written into a temp dir and sealed by ``os.rename`` to
  ``ckpt-{version}``; versions increase; ``latest`` is the largest
  sealed one, so a half-written temp dir is never visible;
- ``meta.json`` beside the state holds ``TrainStatus.to_dict()``;
- the newest ``max_to_keep`` versions are kept.

Two payload formats: replicated (``state.msgpack``, flax's msgpack of the
JAX TrainState's tree, written by ``serialization.to_bytes`` from
``bridge.state_snapshot``) and sharded (``sharded=True``: chunks + index,
``train/sharded_checkpoint.py``, one chunk a leaf). ``restore``
detects the format, restores any chunk layout the JAX package writes,
and writes the state into the live tensors (``bridge.flax_to_state``).

Async snapshot-then-write (``save_async``): PyTorch updates in place, so
the next step's kernels rewrite the very buffers a snapshot reads. The
step thread therefore only enqueues device -> host copies of every state
tensor into a staging arena (pinned memory on a card) on the stream the
step runs on, and records a CUDA event after them; later kernels queue
behind the copies. A single writer thread waits on that event, then
builds the tree, serializes, writes, seals, mirrors and collects
garbage. Two arenas at most are live (the one in flight and one
pending): a newer snapshot supersedes a queued unwritten one
(drop-to-latest) and reuses its arena, and an arena returns to the pool
only once the writer is done with it. ``wait()``/``close()`` are the
epoch-end and shutdown barriers; a failed background write raises
``CheckpointWriteError`` on the next save/wait/close. Sync and async
saves write identical bytes.

Sealed-snapshot retention (the state-migration donor plane,
``collective/migration.py``): with ``retain_sealed`` set, the newest
successfully sealed save's host tree is kept in memory and
``sealed_snapshot()`` serves it as a chunk table and chunks, so a donor
answers peers without reading the disk; ``on_sealed`` is called after each
such seal. A retained arena never returns to the staging pool: a fetch may
still be reading the previous snapshot when a newer one seals, and copying
the next snapshot over it would serve torn bytes. It is dropped instead,
and freed once its last reader lets go.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from edl_tpu_torch import bridge
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.parallel.sharding import is_sharded
from edl_tpu_torch.train import ckpt_io, serialization
from edl_tpu_torch.train import sharded_checkpoint as sc
from edl_tpu_torch.train.state import TrainStatus
from edl_tpu_torch.utils import fs
from edl_tpu_torch.utils.exceptions import EdlCheckpointCorrupt
from edl_tpu_torch.utils.logging import get_logger
from edl_tpu_torch.utils.timeline import timeline

log = get_logger("edl_tpu_torch.train.checkpoint")

_CKPT_RE = re.compile(r"^ckpt-(\d+)$")
_INDEX_FILE_RE = re.compile(r"^index\.(\d+)\.json$")


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed; raised on the save/wait/close
    call after the failure."""


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 process_index: int | None = None, sharded: bool = False,
                 remote: str | None = None):
        """``remote``: an optional URI root (file://, gs://, hdfs://; see
        utils/fs.py) mirroring the local dir: rank 0 uploads each sealed
        version, and a restore whose local dir lacks the wanted version
        fetches it first. ``process_index`` pins this process's index
        (default: its rank in the joined world)."""
        self.directory = directory
        self._process_index = process_index
        self.max_to_keep = max_to_keep
        self.sharded = sharded
        self.remote = remote
        self._remote_folded = False
        self.last_restore_s: float | None = None
        self.last_restored_version: int | None = None
        self._cond = threading.Condition()
        self._pending: dict | None = None   # guarded-by: _cond
        self._inflight = False              # guarded-by: _cond
        self._writer: threading.Thread | None = None  # guarded-by: _cond
        self._closed = False                # guarded-by: _cond
        self._write_error: BaseException | None = None  # guarded-by: _cond
        self._arenas: list[list[torch.Tensor]] = []   # guarded-by: _cond
        self._arena_key: tuple | None = None  # guarded-by: _cond
        # sealed-snapshot retention (the migration donor plane)
        self.retain_sealed = False
        self._sealed: dict | None = None    # guarded-by: _cond
        # called (no args, outside the lock) after each retention update
        self.on_sealed = None
        self._tl = timeline("ckpt")
        self._stats = {  # guarded-by: _cond
            "saves_async": 0, "saves_sync": 0, "superseded": 0,
            "writes": 0, "errors": 0, "state_bytes_last": 0,
            "arena_bytes": 0, "snapshot_ms_last": 0.0,
            "save_stall_ms_total": 0.0, "write_s_last": 0.0,
            "write_s_total": 0.0}
        self._obs = obs_metrics.register_stats("ckpt", self.stats)

    @property
    def process_index(self) -> int:
        if self._process_index is not None:
            return self._process_index
        return distributed.rank()

    def _world_save(self, state) -> bool:
        """Whether a save of ``state`` is collective: a sharded save in a
        world, or a sharded state (its moments and, in the replicated
        format, its slices are gathered)."""
        return ((self.sharded and distributed.world_size() > 1)
                or is_sharded(state.model))

    # -- discovery ---------------------------------------------------------

    def versions(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_CKPT_RE.match, os.listdir(self.directory)) if m)

    def latest_version(self) -> int | None:
        versions = self.versions()
        return versions[-1] if versions else None

    def _path(self, version: int) -> str:
        return os.path.join(self.directory, f"ckpt-{version}")

    # -- snapshot ----------------------------------------------------------

    def _snapshot(self, state, status: TrainStatus) -> dict:
        """Enqueue device -> host copies of every state tensor into a
        staging arena on the current stream; the job's event marks them
        done."""
        live, build = bridge.state_snapshot(state)
        key = tuple((tuple(t.shape), t.dtype, t.device.type) for t in live)
        pinned = any(t.is_cuda for t in live)
        with self._cond:
            if key != self._arena_key:
                self._arenas.clear()
                self._arena_key = key
            arena = self._arenas.pop() if self._arenas else None
        if arena is None:
            arena = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
                     for t in live]
            with self._cond:
                self._stats["arena_bytes"] = sum(
                    a.numel() * a.element_size() for a in arena)
        with torch.no_grad():
            for dst, src in zip(arena, live):
                dst.copy_(src, non_blocking=pinned)
        event = None
        if pinned:
            event = torch.cuda.Event()
            event.record()
        return {"build": build, "arena": arena, "key": key, "event": event,
                "status": TrainStatus.from_dict(status.to_dict())}

    def _recycle(self, job: dict) -> None:  # holds-lock: _cond
        retained = (self._sealed is not None
                    and self._sealed["arena"] is job["arena"])
        if (not retained and job["key"] == self._arena_key
                and len(self._arenas) < 2):
            self._arenas.append(job["arena"])

    # -- save --------------------------------------------------------------

    def save(self, state, status: TrainStatus) -> int | None:
        """Save a new checkpoint now; returns its version (None on ranks
        other than 0). The caller pays the whole write."""
        self.wait()
        t0 = time.perf_counter()
        try:
            if self._world_save(state):
                return self._save_world(state, status)
            if self.process_index != 0:
                self._gc(sealed_only=True)
                return None
            job = self._snapshot(state, status)
            try:
                return self._write(job)
            finally:
                with self._cond:
                    self._recycle(job)
        finally:
            with self._cond:
                self._stats["saves_sync"] += 1
                self._stats["save_stall_ms_total"] += (
                    time.perf_counter() - t0) * 1e3

    def save_async(self, state, status: TrainStatus) -> None:
        """Queue a checkpoint: the caller pays only for enqueueing the
        snapshot copies. Raises ``CheckpointWriteError`` if an earlier
        background write failed. A snapshot still queued behind the
        writer is superseded by this one (drop-to-latest); the write in
        flight is never aborted."""
        self._raise_pending_error()
        if self._world_save(state):
            self.save(state, status)   # collective: on this thread
            return
        if self.process_index != 0:
            self._gc(sealed_only=True)
            return
        t0 = time.perf_counter()
        with self._tl.span("snapshot"):
            with self._cond:
                if self._pending is not None:
                    old, self._pending = self._pending, None
                    self._stats["superseded"] += 1
                    # its copies are queued ahead of the new ones on the
                    # same stream, so the arena can take them
                    self._recycle(old)
            job = self._snapshot(state, status)
        stall_ms = (time.perf_counter() - t0) * 1e3
        with self._cond:
            if self._closed:
                raise RuntimeError("CheckpointManager is closed")
            self._stats["saves_async"] += 1
            self._stats["snapshot_ms_last"] = stall_ms
            self._stats["save_stall_ms_total"] += stall_ms
            self._pending = job
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, name="edl-ckpt-writer",
                    daemon=True)
                self._writer.start()
            self._cond.notify_all()

    def _write(self, job: dict) -> int:
        """Wait for the job's copies, build the tree, write and seal it.
        Runs on the caller for ``save`` and on the writer thread for
        ``save_async``: the same bytes either way."""
        if job["event"] is not None:
            job["event"].synchronize()
        tree = job["build"]([a.numpy() for a in job["arena"]])
        version = self._write_tree(tree, job["status"])
        self._retain(tree, job["arena"], version, job["status"])
        return version

    def _write_tree(self, tree, status: TrainStatus) -> int:
        latest = self.latest_version()
        mirror_this = self.remote is not None
        folded_now = False
        if self.remote is not None and not self._remote_folded:
            latest, folded_now = self._fold_remote_latest(latest)
            mirror_this = folded_now
        version = 0 if latest is None else latest + 1
        os.makedirs(self.directory, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".tmp-ckpt-", dir=self.directory)
        try:
            meta = {"version": version, "status": status.to_dict()}
            if self.sharded:
                files = sc.save_tree(tmp, tree)
                nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                             for f in files)
                meta.update(format="sharded",
                            world={"process_count": 1,
                                   "device_count": distributed.world_size()})
            else:
                payload = serialization.to_bytes(tree)
                nbytes = len(payload)
                with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
                    f.write(payload)
            with self._cond:
                self._stats["state_bytes_last"] = nbytes
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            os.rename(tmp, self._path(version))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        log.info("saved checkpoint %s (epoch=%d step=%d)",
                 self._path(version), status.epoch, status.step)
        if folded_now:
            self._remote_folded = True
        if mirror_this:
            self._mirror(version)
        self._gc()
        return version

    def _save_world(self, state, status: TrainStatus) -> int | None:
        """The collective save: a sharded state's tree (its slices as
        Shards; collective), then either every rank's chunks
        (``sharded``) or the gathered whole tree written by rank 0."""
        if is_sharded(state.model):
            tree = bridge.sharded_state_tree(state)
        else:
            tree = bridge.state_to_flax(state)
        if not self.sharded:
            tree = bridge.gather_shards(tree)
            if self.process_index != 0:
                self._gc(sealed_only=True)
                return None
            return self._write_tree(tree, status)
        version = self._save_sharded_world(
            sc.snapshot_shard_tree(tree, self.process_index), status)
        if version is not None and not is_sharded(state.model):
            # rank 0's whole tree serves migration donors, as an async
            # save's does (a sharded rank's slices are not served)
            self._retain(tree, None, version, status)
        return version

    def _save_sharded_world(self, snap: dict, status: TrainStatus
                            ) -> int | None:
        """Every rank writes its chunks into the version's temp dir; rank
        0 seals it. The JAX package's order: a begin barrier, rank 0's
        version broadcast, rank 0 clears a stale temp dir of that
        version and each rank its older ones, a barrier, the writes (a
        rank that fails drops a poison marker and still reaches the next
        barrier), a barrier, every rank's look for poison markers, a
        barrier, then rank 0 writes meta.json and renames.
        With a remote mirror (``EDL_TPU_CKPT_REMOTE``) rank 0 folds the
        mirror's LATEST into the version, and every rank uploads its own
        chunks and index (:meth:`_mirror_sharded_upload`, whose barriers
        every rank runs before any raise); rank 0 flips the mirror's
        LATEST once it holds every rank's index
        (:meth:`_mirror_sharded_finalize`)."""
        distributed.barrier()
        latest = self.latest_version()
        remote_read_ok = True
        if self.remote is not None and self.process_index == 0:
            latest, remote_read_ok = self._fold_remote_latest(latest)
        version = distributed.broadcast_int(0 if latest is None
                                            else latest + 1)
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f".tmp-ckpt-{version}")
        if self.process_index == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-ckpt-") and name != os.path.basename(tmp):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        distributed.barrier()
        failure: BaseException | None = None
        my_files: list[str] = []
        try:
            my_files = ckpt_io.write_snapshot(tmp, snap)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            failure = exc
            try:
                os.makedirs(tmp, exist_ok=True)
                open(os.path.join(
                    tmp, f"save_failed.{self.process_index}"), "w").close()
            except OSError:
                pass
        distributed.barrier()
        poisoned = [n for n in (os.listdir(tmp) if os.path.isdir(tmp)
                                else []) if n.startswith("save_failed.")]
        mirror_ok = False
        if self.remote is not None:
            # every rank runs the mirror's barriers, healthy or not,
            # before any raise below: on unshared dirs a healthy rank
            # cannot see a failed rank's poison marker
            mirror_ok = self._mirror_sharded_upload(
                tmp, version, my_files,
                ok=failure is None and not poisoned and remote_read_ok)
        else:
            # every rank has listed the temp dir before rank 0 renames or
            # removes it (a rank still listing would find it gone)
            distributed.barrier()
        if failure is not None or poisoned:
            if self.process_index == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            if failure is not None:
                raise failure
            raise RuntimeError(f"sharded save aborted: {poisoned} failed")
        if self.process_index != 0:
            self._gc(sealed_only=True)
            return None
        try:
            meta = {"version": version, "status": status.to_dict(),
                    "format": "sharded",
                    "world": {"process_count": distributed.world_size(),
                              "device_count": distributed.world_size()}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            os.rename(tmp, self._path(version))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        with self._cond:
            self._stats["state_bytes_last"] = sum(
                a.nbytes for _, a in snap["chunks"])
        log.info("saved sharded checkpoint %s (epoch=%d step=%d)",
                 self._path(version), status.epoch, status.step)
        if mirror_ok:
            self._mirror_sharded_finalize(version)
        self._gc()
        return version

    def _mirror_sharded_upload(self, tmp: str, version: int,
                               my_files: list[str], *, ok: bool) -> bool:
        """Every rank uploads its own chunks and index from its pending
        dir (local dirs need not be shared); rank 0 cleans the remote
        version dir first, and a failed clean skips the version's mirror
        world-wide. ``ok=False`` ranks run the barriers without
        uploading. Returns whether the world uploaded (rank 0's clean
        succeeded): the finalize is gated on it."""
        clean_ok = 1 if ok else 0   # rank 0's value wins the broadcast
        if self.process_index == 0 and ok:
            try:
                fs.resolve(self.remote).delete(
                    fs.join_uri(self.remote, f"ckpt-{version}"))
            except Exception as exc:  # noqa: BLE001 — mirror-only
                log.warning("remote clean of ckpt-%d failed, skipping "
                            "this version's mirror: %s", version, exc)
                clean_ok = 0
        clean_ok = distributed.broadcast_int(clean_ok)
        if ok and clean_ok:
            try:
                fs.mirror_checkpoint_files(tmp, version, self.remote,
                                           my_files)
            except Exception as exc:  # noqa: BLE001 — any transfer error
                # this rank still reaches the barrier; its missing index
                # keeps the finalize from flipping LATEST
                log.warning("sharded mirror of ckpt-%d (rank %d) failed: "
                            "%s", version, self.process_index, exc)
        distributed.barrier()
        return bool(clean_ok)

    def _mirror_sharded_finalize(self, version: int) -> None:
        """Rank 0: flip the mirror's LATEST to ``version`` once the remote
        dir holds exactly index.{0..world-1}.json (a missing index is an
        incomplete upload, an extra one a stale earlier attempt), then
        upload meta.json and prune old versions."""
        try:
            have = set(fs.resolve(self.remote).listdir(
                fs.join_uri(self.remote, f"ckpt-{version}")))
            want = {f"index.{r}.json"
                    for r in range(distributed.world_size())}
            got = {n for n in have if _INDEX_FILE_RE.match(n)}
            if got != want:
                log.warning("mirror of ckpt-%d inconsistent (missing "
                            "indexes %s, stale extras %s); LATEST not "
                            "flipped", version, sorted(want - got),
                            sorted(got - want))
                return
            fs.mirror_checkpoint_files(self._path(version), version,
                                       self.remote, ["meta.json"])
            fs.finalize_mirror(self.remote, version, keep=self.max_to_keep)
            log.info("mirrored sharded ckpt-%d -> %s", version, self.remote)
        except Exception as exc:  # noqa: BLE001 — a mirror failure must
            log.warning("mirror of ckpt-%d to %s failed: %s", version,
                        self.remote, exc)  # not kill a sealed local save

    def _fold_remote_latest(self, latest: int | None
                            ) -> tuple[int | None, bool]:
        """Fold the mirror's LATEST into the version choice (a rank 0
        restarted with an empty local dir must not reuse a published
        number). Returns (latest, read_ok); read_ok False skips this
        save's mirror."""
        try:
            remote_latest = fs.remote_latest_version(self.remote)
        except Exception as exc:  # noqa: BLE001 — mirror-only
            log.warning("remote LATEST unreadable (%s); skipping this "
                        "save's mirror", exc)
            return latest, False
        if remote_latest is not None:
            latest = remote_latest if latest is None else max(
                latest, remote_latest)
        return latest, True

    def _mirror(self, version: int) -> None:
        try:
            fs.mirror_checkpoint(self.directory, version, self.remote,
                                 keep=self.max_to_keep)
        except fs.EdlFsError as exc:
            # the local version is sealed; the next save's upload
            # supersedes a transient mirror failure
            log.warning("mirror of ckpt-%d to %s failed: %s", version,
                        self.remote, exc)

    def _gc(self, *, sealed_only: bool = False) -> None:
        versions = self.versions()
        for version in versions[: max(0, len(versions) - self.max_to_keep)]:
            shutil.rmtree(self._path(version), ignore_errors=True)
        if sealed_only or not os.path.isdir(self.directory):
            return
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-ckpt-"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def gc_stale_tmp(self) -> None:
        """Startup GC: remove ``.tmp-*`` dirs left by a killed writer.
        Call at (re)start, when no save of this run can be pending."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for name in names:
            if name.startswith(".tmp-"):
                path = os.path.join(self.directory, name)
                log.info("startup GC: removing stale partial save %s", path)
                shutil.rmtree(path, ignore_errors=True)

    # -- sealed-snapshot retention (state-migration donors) ----------------

    def _retain(self, tree, arena: list, version: int,
                status: TrainStatus) -> None:
        """Keep the just-sealed save's host tree for peer serving (no-op
        unless ``retain_sealed``). The previous retained tree is dropped,
        never recycled into the staging pool."""
        with self._cond:
            if not self.retain_sealed:
                return
            self._sealed = {"payload": tree, "arena": arena,
                            "version": version, "view": None,
                            # isolated from the loop's live cursor
                            "status": TrainStatus.from_dict(
                                status.to_dict())}
            cb = self.on_sealed
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — serving is best-effort;
                log.exception("on_sealed hook failed")  # never fail a save

    def sealed_snapshot(self) -> dict | None:
        """The newest sealed save as a serve-ready view, ``{version,
        status, process_index, leaves, chunks}``: ``leaves`` is the
        self-describing chunk table of the sharded format (with each
        chunk's crc32) and ``chunks`` maps chunk file names to host
        arrays. The donor manifest and payload a migration server answers
        peers with; None until a save seals with ``retain_sealed`` set."""
        with self._cond:
            rec = self._sealed
        if rec is None:
            return None
        if rec["view"] is None:   # built once a seal (crc32s included)
            snap = sc.snapshot_host_tree(rec["payload"])
            rec["view"] = {"version": rec["version"],
                           "status": rec["status"].to_dict(),
                           "process_index": snap["process_index"],
                           "leaves": snap["leaves"],
                           "chunks": dict(snap["chunks"])}
        return rec["view"]

    # -- the writer --------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:
                    return
                job, self._pending = self._pending, None
                self._inflight = True
            try:
                t0 = time.perf_counter()
                with self._tl.span("write"):
                    self._write(job)
                dt = time.perf_counter() - t0
                with self._cond:
                    self._stats["writes"] += 1
                    self._stats["write_s_last"] = dt
                    self._stats["write_s_total"] += dt
            except BaseException as exc:  # noqa: BLE001 — surfaced on the
                log.exception(            # next save/wait/close call
                    "async checkpoint write failed")
                with self._cond:
                    self._write_error = exc
                    self._stats["errors"] += 1
            finally:
                with self._cond:
                    self._recycle(job)
                    self._inflight = False
                    self._cond.notify_all()

    def wait(self, timeout: float | None = None) -> None:
        """Block until every queued snapshot is written; re-raises a
        background failure as ``CheckpointWriteError``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._inflight:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "checkpoint writer did not drain in time")
                self._cond.wait(remaining)
        self._raise_pending_error()

    def close(self, raise_errors: bool = True) -> None:
        """Drain the queued snapshot and stop the writer thread. With
        ``raise_errors=False`` (crash paths) a failure is only logged. The
        manager stays usable: a later ``save_async`` restarts the
        writer."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            writer = self._writer
        if writer is not None:
            writer.join()
        with self._cond:
            self._writer = None
            self._closed = False
        obs_metrics.unregister(self._obs)
        if raise_errors:
            self._raise_pending_error()

    def _raise_pending_error(self) -> None:
        with self._cond:
            exc, self._write_error = self._write_error, None
        if exc is not None:
            raise CheckpointWriteError(
                "background checkpoint write failed") from exc

    def stats(self) -> dict:
        """Save-stall and write accounting. ``save_stall_ms_total`` is
        what the step loop waited: the whole save for a sync save, the
        snapshot's enqueue for an async one."""
        with self._cond:
            s = dict(self._stats)
        saves = s["saves_async"] + s["saves_sync"]
        s["save_stall_ms_mean"] = (s["save_stall_ms_total"] / saves
                                   if saves else 0.0)
        if self.last_restore_s is not None:
            s["restore_s"] = self.last_restore_s
        return s

    # -- load --------------------------------------------------------------

    def _pick_version(self, version: int | None) -> int | None:
        """The version to load: ``version``, else the local latest or the
        mirror's newer LATEST; rank 0's choice in a world."""
        if version is None and self.process_index == 0:
            version = self.latest_version()
            if self.remote is not None:
                try:
                    remote_latest = fs.remote_latest_version(self.remote)
                except fs.EdlFsError as exc:
                    log.warning("mirror %s unreachable for restore: %s",
                                self.remote, exc)
                    remote_latest = None
                if remote_latest is not None and (
                        version is None or remote_latest > version):
                    version = remote_latest
        picked = distributed.broadcast_int(-1 if version is None
                                           else version)
        if picked < 0:
            return None
        if not os.path.isdir(self._path(picked)) and self.remote is not None:
            fs.fetch_latest_checkpoint(self.remote, self.directory,
                                       version=picked)
        return picked

    def _read(self, version: int) -> tuple[dict, TrainStatus]:
        path = self._path(version)
        if sc.is_sharded_dir(path):
            tree = sc.restore_state_dict(path)
        else:
            with open(os.path.join(path, "state.msgpack"), "rb") as f:
                tree = serialization.msgpack_restore(f.read())
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return tree, TrainStatus.from_dict(meta["status"])

    def _load_sharded(self, state, version: int) -> TrainStatus:
        """Write version ``version`` into a sharded ``state``, reading only
        this rank's regions from the chunks (whole leaves from the
        replicated format's tree)."""
        path = self._path(version)
        if sc.is_sharded_dir(path):
            merged = ckpt_io.read_merged_index(path)
            files = ckpt_io.ChunkFiles(path,
                                       crcs=ckpt_io.checksum_map(merged))
            try:
                bridge.flax_to_state_sharded(
                    sc.entry_reader(merged, files.load), state)
            finally:
                files.close()
        else:
            with open(os.path.join(path, "state.msgpack"), "rb") as f:
                tree = serialization.msgpack_restore(f.read())

            def read(p, index):
                leaf = np.asarray(bridge._lookup(tree, tuple(p)))
                return leaf if index is None else leaf[index]

            bridge.flax_to_state_sharded(read, state)
        with open(os.path.join(path, "meta.json")) as f:
            return TrainStatus.from_dict(json.load(f)["status"])

    def restore_raw(self, version: int | None = None
                    ) -> tuple[dict, TrainStatus] | None:
        """The state dict of a checkpoint (either format) and its status,
        with no target state; None when there is none."""
        version = self._pick_version(version)
        return None if version is None else self._read(version)

    def restore(self, state, version: int | None = None):
        """Restore into ``state``'s tensors in place; returns (state,
        status), or None when there is no checkpoint.

        A chunk failing its crc32 raises ``EdlCheckpointCorrupt``; with
        ``version=None`` the manager then falls back, loudly, to the next
        older sealed version."""
        if version is not None:
            return self._restore_version(state, version)
        try:
            return self._restore_version(state, None)
        except EdlCheckpointCorrupt as exc:
            last_exc = exc
        bad = self.latest_version()
        log.error("checkpoint ckpt-%s corrupt (%s); falling back to the "
                  "previous sealed version", bad, last_exc)
        for v in reversed([v for v in self.versions()
                           if bad is None or v < bad]):
            try:
                return self._restore_version(state, v)
            except EdlCheckpointCorrupt as exc:
                last_exc = exc
                log.error("checkpoint ckpt-%d also corrupt (%s)", v, exc)
        raise EdlCheckpointCorrupt(
            "every local sealed checkpoint failed its integrity check "
            f"under {self.directory}") from last_exc

    def restore_local(self, state):
        """Restore this directory's latest sealed version into ``state``
        without agreeing on the version with the world (no collective):
        the disk fallback of an in-place reform, which one rank runs
        alone. Returns (state, status), or None when there is none."""
        version = self.latest_version()
        return None if version is None else self._load(state, version)

    def _restore_version(self, state, version: int | None):
        version = self._pick_version(version)
        if version is None:
            return None
        return self._load(state, version)

    def _load(self, state, version: int):
        t0 = time.perf_counter()
        if is_sharded(state.model):
            status = self._load_sharded(state, version)
        else:
            tree, status = self._read(version)
            bridge.flax_to_state(tree, state)
        if next(state.model.parameters()).is_cuda:
            torch.cuda.synchronize()
        self.last_restore_s = time.perf_counter() - t0
        self.last_restored_version = version
        log.info("restored checkpoint %s (epoch=%d step=%d) in %.3fs",
                 self._path(version), status.epoch, status.step,
                 self.last_restore_s)
        return state, status

