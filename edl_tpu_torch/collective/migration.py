"""Peer-to-peer live state migration: the resize path without the disk
(copy of ``edl_tpu.collective.migration`` but its expert-table paths,
the reshards of an ep resize: ROADMAP Queue 1 item 14(d)).

- every trainer under the elastic launcher runs a **donor server**: the
  newest SEALED checkpoint snapshot (the checkpoint manager's retained
  host copy, no extra device -> host transfer) is served chunk by chunk
  over the tensor wire (``data/tensor_wire.py``);
- a (re)starting trainer **restores from peers**: donor manifests are
  merged into the chunk index the on-disk sharded format uses, and
  ``train/sharded_checkpoint.restore_from_index`` assembles the state
  from fetched chunks, so a peer restore and a disk restore of the same
  version give the same bits;
- **surviving** trainers never restart: a reform watch follows the
  leader-published cluster generation, and on a resize that keeps this
  pod the TrainLoop adopts the new (rank, world) in place;
- **disk remains the fallback** whenever peers cannot serve: no live
  donors, donors staler than the local disk (epoch fencing), or a donor
  dying mid-transfer raise `PeerRestoreError`, and the caller restores
  from ``CheckpointManager.restore``.

Store key layout (all under the job scope), the JAX package's:

    /{job}/migration/donors/{pod_id}  donor advert JSON, leased
                                      {pod_id, addr, port, version, step,
                                       generation, nbytes, ts}
    /{job}/migration/epoch            resize epoch doc: {epoch, ts, from,
                                      desired, donors[, trace]}
    /{job}/migration/ack/{pod_id}     restore/adoption ack {pod_id, mode:
                                      peers|disk|adopted|fresh, ts, pid,
                                      generation, version, downtime_s,
                                      bytes_from_peers, restore_s[,
                                      reform]}

The wire ops are the JAX package's (``{op: manifest}``, ``{op: fetch,
files}``, ``{error}`` frames), and so are the manifest's leaf keys (the
flax TrainState's, ``bridge.state_to_flax``), so either package restores
from the other's donor. ``EDL_TPU_RESIZE_P2P=0`` is the escape hatch back
to pure stop-resume.

The launcher imports this module for `wait_adopted`, so numpy and the
tensor wire are imported only where a snapshot is served or fetched.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Callable

from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.obs import recorder as flight
from edl_tpu_torch.obs import trace
from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.collective.migration")


class PeerRestoreError(EdlError):
    """Peer restore is unavailable or failed: the caller falls back to
    disk."""


# -- key layout -------------------------------------------------------------

def donors_prefix(job_id: str) -> str:
    return f"/{job_id}/migration/donors/"


def donor_key(job_id: str, pod_id: str) -> str:
    return f"/{job_id}/migration/donors/{pod_id}"


def epoch_key(job_id: str) -> str:
    return f"/{job_id}/migration/epoch"


def ack_prefix(job_id: str) -> str:
    return f"/{job_id}/migration/ack/"


def ack_key(job_id: str, pod_id: str) -> str:
    return f"/{job_id}/migration/ack/{pod_id}"


def p2p_enabled(environ=None) -> bool:
    if environ is None:
        return config.env_flag("EDL_TPU_RESIZE_P2P", True)
    return environ.get("EDL_TPU_RESIZE_P2P", "1") != "0"


def live_donors(store: Store, job_id: str) -> list[dict]:
    """Parsed donor adverts currently alive (leased keys)."""
    records, _ = store.get_prefix(donors_prefix(job_id))
    out = []
    for rec in records:
        try:
            out.append(json.loads(rec.value))
        except json.JSONDecodeError:
            continue
    return out


# -- donor server -----------------------------------------------------------

class MigrationServer:
    """Serve the retained sealed snapshot to peers over the tensor wire.

    Protocol (one framed request -> one framed reply, pipelined per
    connection):

      {op: "manifest"} -> meta {op, version, status, process_index,
                                leaves}
      {op: "fetch", files: [...]} -> meta {op, version}, tensors
                                     {fname: chunk}

    A donor that holds no snapshot, an unknown chunk or an unknown op
    answers an ``error`` meta instead of dropping the connection, so the
    restorer tells "donor not ready" from "donor died".
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._lock = threading.Lock()
        self._snap: dict | None = None            # guarded-by: _lock
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()   # guarded-by: _lock
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="edl-migrate-srv")
        self._accept.start()

    def publish(self, snapshot: dict) -> None:
        """Swap in a newer sealed snapshot (``CheckpointManager.
        sealed_snapshot``'s view). In-flight fetches keep their reference
        to the old one: snapshots are immutable once published, so a swap
        never tears a transfer."""
        with self._lock:
            self._snap = snapshot

    def snapshot(self) -> dict | None:
        with self._lock:
            return self._snap

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="edl-migrate-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        from edl_tpu_torch.data.tensor_wire import TensorWireError, \
            recv_tensors

        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                meta, _ = recv_tensors(conn)
                # a fetch sent under a restore span carries its context:
                # the serve work shows up inside the same resize trace
                ctx = trace.extract(meta)
                if ctx is not None:
                    with trace.span(f"migrate.serve_{meta.get('op')}",
                                    parent=ctx):
                        self._handle(conn, meta)
                else:
                    self._handle(conn, meta)
        except (TensorWireError, OSError):
            pass  # peer done / donor stopping
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn: socket.socket, meta: dict) -> None:
        # overridable seam: tests subclass this to model a donor dying
        # mid-transfer (manifest served, fetch drops the connection)
        from edl_tpu_torch.data.tensor_wire import send_tensors

        snap = self.snapshot()
        op = meta.get("op")
        if snap is None:
            send_tensors(conn, {"error": "donor holds no sealed snapshot"})
            return
        if op == "manifest":
            send_tensors(conn, {"op": "manifest",
                                "version": snap["version"],
                                "status": snap["status"],
                                "process_index": snap["process_index"],
                                "leaves": snap["leaves"]})
        elif op == "fetch":
            names = meta.get("files") or []
            missing = [n for n in names if n not in snap["chunks"]]
            if missing:
                send_tensors(conn, {"error": f"unknown chunks {missing}"})
                return
            send_tensors(conn, {"op": "fetch", "version": snap["version"]},
                         {n: snap["chunks"][n] for n in names})
        else:
            send_tensors(conn, {"error": f"unknown op {op!r}"})

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


# -- peer restore -----------------------------------------------------------

def _connect(advert: dict, timeout: float) -> socket.socket:
    sock = socket.create_connection((advert["addr"], int(advert["port"])),
                                    timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def _fetch_manifest(advert: dict, timeout: float) -> dict:
    from edl_tpu_torch.data.tensor_wire import (TensorWireError,
                                                recv_tensors, send_tensors)

    with _connect(advert, timeout) as sock:
        send_tensors(sock, trace.attach({"op": "manifest"}))
        meta, _ = recv_tensors(sock)
    if "error" in meta:
        raise TensorWireError(meta["error"])
    return meta


class _PeerChunks:
    """Chunk source for `restore_from_index` backed by donor fetches.

    One connection per (donor, reader thread); each chunk is fetched once
    per restore and cached, as the on-disk ``ChunkFiles`` cache reads
    each file once."""

    def __init__(self, owners: dict[str, dict], timeout: float,
                 expect_version: int | None = None,
                 crcs: dict[str, int] | None = None):
        from edl_tpu_torch.train.ckpt_io import verify_enabled

        self.owners = owners            # chunk fname -> donor advert
        self.timeout = timeout
        # version fence: a donor sealing a NEWER snapshot mid-restore
        # must not mix steps into the assembled state
        self.expect_version = expect_version
        # integrity fence: the donor manifests' chunk crc32s; a chunk
        # garbled on the wire fails here and the restore falls back
        self.crcs = crcs or {}
        self._verify = verify_enabled()
        self._cache: dict[str, Any] = {}
        self._cache_lock = threading.Lock()
        self._inflight: dict[str, threading.Lock] = {}
        self._local = threading.local()
        self._all_socks: list[socket.socket] = []
        self._socks_lock = threading.Lock()
        self.bytes_fetched = 0
        # fetches run on the restore's reader threads, where the
        # thread-local span is not current: capture it here as each
        # fetch's parent (it rides the wire meta to the donor)
        self._trace_parent = trace.current()

    def _sock_for(self, advert: dict) -> socket.socket:
        pool = getattr(self._local, "socks", None)
        if pool is None:
            pool = self._local.socks = {}
        key = (advert["addr"], advert["port"])
        sock = pool.get(key)
        if sock is None:
            sock = pool[key] = _connect(advert, self.timeout)
            with self._socks_lock:
                self._all_socks.append(sock)
        return sock

    def load(self, fname: str):
        # per-chunk single flight: two readers whose regions share a
        # chunk pull it over the wire once
        with self._cache_lock:
            arr = self._cache.get(fname)
            if arr is not None:
                return arr
            flight_lock = self._inflight.setdefault(fname, threading.Lock())
        with flight_lock:
            with self._cache_lock:
                arr = self._cache.get(fname)
            if arr is not None:
                return arr
            return self._fetch(fname)

    def _fetch(self, fname: str):
        from edl_tpu_torch.data.tensor_wire import recv_tensors, \
            send_tensors
        from edl_tpu_torch.train.ckpt_io import chunk_crc32

        advert = self.owners.get(fname)
        if advert is None:
            raise PeerRestoreError(f"no donor owns chunk {fname}")
        sock = self._sock_for(advert)
        with trace.span("migrate.fetch", parent=self._trace_parent,
                        attrs={"file": fname,
                               "donor": advert.get("pod_id")}) as sp:
            send_tensors(sock, trace.attach({"op": "fetch",
                                             "files": [fname]}))
            meta, tensors = recv_tensors(sock)
            if sp is not None and fname in tensors:
                sp.attrs["bytes"] = int(tensors[fname].nbytes)
        if "error" in meta or fname not in tensors:
            raise PeerRestoreError(
                f"donor {advert.get('pod_id')} failed serving {fname}: "
                f"{meta.get('error', 'chunk missing from reply')}")
        if self.expect_version is not None \
                and int(meta.get("version", -1)) != self.expect_version:
            raise PeerRestoreError(
                f"donor {advert.get('pod_id')} moved to version "
                f"{meta.get('version')} mid-restore (wanted "
                f"{self.expect_version})")
        arr = tensors[fname]
        expect = self.crcs.get(fname)
        if self._verify and expect is not None:
            got = chunk_crc32(arr)
            if got != expect:
                raise PeerRestoreError(
                    f"chunk {fname} from donor {advert.get('pod_id')} "
                    f"failed integrity check (crc32 {got:#010x} != "
                    f"manifest {expect:#010x})")
        with self._cache_lock:
            self._cache[fname] = arr
            self.bytes_fetched += arr.nbytes
        return arr

    def close(self) -> None:
        with self._socks_lock:
            socks, self._all_socks = self._all_socks, []
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass


def resize_trace_ctx(store: Store, job_id: str) -> tuple[str, str] | None:
    """The span context the last resize embedded in its epoch doc
    (`publish_resize_epoch`): how a trainer that learns of a resize
    through the store joins the decision's trace. None when tracing is
    off, there is no epoch doc, or it carries no context."""
    if not trace.enabled():
        return None
    try:
        rec = store.get(epoch_key(job_id))
        if rec is None:
            return None
        return trace.parse_context(json.loads(rec.value).get("trace"))
    except Exception:  # noqa: BLE001 — observability only
        return None


def restore_from_peers(store: Store, job_id: str, target: Any, *,
                       local_version: int | None = None,
                       threads: int | None = None,
                       timeout: float = 5.0,
                       pods: list[str] | None = None
                       ) -> tuple[Any, Any, dict]:
    """Assemble ``target``'s state from live donor snapshots, under a
    ``resize.restore_peers`` span parented onto the resize that caused
    it. ``target`` is a TrainState written in place once every chunk has
    arrived. ``pods`` restricts
    the donor set: the reform machine's survivor restores its OWN
    just-sealed snapshot this way (per-pod version counters are not
    comparable across pods, so an unfiltered merge could mix states from
    different steps)."""
    with trace.span("resize.restore_peers",
                    parent=resize_trace_ctx(store, job_id),
                    attrs={"job": job_id}) as sp:
        state, status, stats = _restore_from_peers(
            store, job_id, target, local_version=local_version,
            threads=threads, timeout=timeout, pods=pods)
        if sp is not None:
            sp.attrs.update({k: stats[k] for k in
                             ("version", "bytes_from_peers", "restore_s")})
        flight.record("peer_restore", job_id=job_id,
                      version=stats["version"],
                      bytes_from_peers=stats["bytes_from_peers"],
                      restore_s=stats["restore_s"])
        return state, status, stats


def _restore_from_peers(store: Store, job_id: str, target: Any, *,
                        local_version: int | None = None,
                        threads: int | None = None,
                        timeout: float = 5.0,
                        pods: list[str] | None = None
                        ) -> tuple[Any, Any, dict]:
    """Donor adverts are read from the store, the newest manifest
    version wins, and its donors' manifests are merged into one chunk
    index: the plan a disk restore builds from index files, so peer- and
    disk-restored states are bitwise identical. ``local_version`` is the
    epoch fence: when this pod's own disk holds a NEWER sealed version
    than any donor, peers are refused. Returns ``(state, TrainStatus,
    stats)``; raises `PeerRestoreError` wherever disk is the right
    path."""
    from edl_tpu_torch.data.tensor_wire import TensorWireError
    from edl_tpu_torch.train import ckpt_io
    from edl_tpu_torch.train import sharded_checkpoint as sc
    from edl_tpu_torch.train.state import TrainStatus

    adverts = live_donors(store, job_id)
    if pods is not None:
        adverts = [a for a in adverts if a.get("pod_id") in pods]
    if not adverts:
        raise PeerRestoreError(
            "no live donors advertised" if pods is None else
            f"no live donors among {pods}")
    # The advert is discovery only: the manifest carries the live sealed
    # version (adverts refresh off-thread and may lag a seal).
    manifests: dict[str, dict] = {}
    owners: dict[str, dict] = {}
    by_version: dict[int, list[tuple[dict, dict]]] = {}
    for advert in adverts:
        try:
            man = _fetch_manifest(advert, timeout)
        except (OSError, TensorWireError) as exc:
            log.warning("donor %s unreachable for manifest: %s",
                        advert.get("pod_id"), exc)
            continue
        by_version.setdefault(int(man["version"]), []).append((advert, man))
    if not by_version:
        raise PeerRestoreError("all donors unreachable")
    # donors may straddle a seal: the newest consistent group wins
    chosen = max(by_version)
    if local_version is not None and local_version > chosen:
        # epoch fence: a stale donor never beats this pod's own newer
        # sealed checkpoint
        raise PeerRestoreError(
            f"donors stale: best peer version {chosen} < local disk "
            f"version {local_version}")
    for advert, man in by_version[chosen]:
        manifests[advert.get("pod_id", advert["addr"])] = man
        for leaf in man["leaves"]:
            for chunk in leaf["chunks"]:
                owners.setdefault(chunk["file"], advert)
    merged = ckpt_io.merge_leaf_tables(
        [m["leaves"] for m in manifests.values()])
    source = _PeerChunks(owners, timeout, expect_version=chosen,
                         crcs=ckpt_io.checksum_map(merged))
    t0 = time.perf_counter()
    try:
        state = sc.restore_from_index(merged, source.load, target, threads)
    except PeerRestoreError:
        raise
    except Exception as exc:  # noqa: BLE001 — donor death mid-transfer,
        # coverage holes, wire errors: all mean "go restore from disk"
        raise PeerRestoreError(f"peer fetch failed: {exc}") from exc
    finally:
        source.close()
    if next(target.model.parameters()).is_cuda:
        import torch

        torch.cuda.synchronize()
    status = TrainStatus.from_dict(
        next(iter(manifests.values()))["status"])
    stats = {"version": chosen,
             "bytes_from_peers": source.bytes_fetched,
             "donors": sorted(manifests),
             "restore_s": round(time.perf_counter() - t0, 4)}
    log.info("restored v%d from %d peer(s) in %.3fs (%.1f MB over the "
             "wire)", chosen, len(manifests), stats["restore_s"],
             source.bytes_fetched / 2**20)
    return state, status, stats


# -- trainer-side service ---------------------------------------------------

class Reform:
    """A pending in-place adoption: the new cluster still contains us."""

    def __init__(self, cluster, rank: int, world_size: int):
        self.cluster = cluster
        self.rank = rank
        self.world_size = world_size
        self.generation = cluster.version


class MigrationService:
    """Everything a trainer process contributes to the migration plane.

    - serves its retained sealed snapshot (`attach` wires a
      CheckpointManager's retention hook to the donor server and a leased
      store advert, refreshed off-thread);
    - watches the leader-published cluster generation so the TrainLoop
      can adopt a resize in place (`poll_reform`);
    - turns SIGTERM into a *graceful* stop (`stop_requested`) and, on
      shutdown, lingers as a donor until the re-formed world has acked
      its restores (or a bounded deadline): how a shrink victim's state
      survives its own eviction.
    """

    def __init__(self, store: Store, job_id: str, pod_id: str, *,
                 generation: int = 0, ttl: float = 15.0,
                 linger_s: float = 10.0, addr: str | None = None,
                 owns_store: bool = False):
        from edl_tpu_torch.collective.job_env import local_addr

        self.store = store
        self.job_id = job_id
        self.pod_id = pod_id
        self.ttl = ttl
        self.linger_s = linger_s
        self.addr = addr or local_addr()
        self.generation = generation
        self._owns_store = owns_store
        self.server = MigrationServer()
        self.stop_requested = threading.Event()
        self._stop_ts: float | None = None
        self._lease: int | None = None
        self._keeper = None
        self._advert_dirty = threading.Event()
        self._advert_doc: dict | None = None  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._advert_thread: threading.Thread | None = None
        # reform watch
        self._reform: Reform | None = None    # guarded-by: _lock
        self._watch_thread: threading.Thread | None = None
        self._reform_watch = None
        self._ckpt = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_env(cls, ckpt=None) -> "MigrationService | None":
        """Build from the launcher's trainer env; None when p2p is off,
        the trainer runs standalone, or the store is down."""
        if not p2p_enabled():
            return None
        if not config.env_present("EDL_TPU_RANK"):
            return None  # not under the elastic launcher
        endpoints = config.env_str("EDL_TPU_STORE_ENDPOINTS", "") or ""
        job_id = config.env_str("EDL_TPU_JOB_ID", "") or ""
        pod_id = config.env_str("EDL_TPU_POD_ID", "") or ""
        if not (endpoints and job_id and pod_id):
            return None
        from edl_tpu_torch.coord.redis_store import connect_store
        try:
            store = connect_store(endpoints.split(",")[0])
        except Exception as exc:  # noqa: BLE001 — plane is optional
            log.warning("migration service disabled (store unreachable: "
                        "%s)", exc)
            return None
        svc = cls(store, job_id, pod_id,
                  generation=config.env_int("EDL_TPU_CLUSTER_VERSION", 0),
                  linger_s=config.env_float("EDL_TPU_DONOR_LINGER", 10.0),
                  owns_store=True)
        if ckpt is not None:
            svc.attach(ckpt)
        svc.start_reform_watch()
        svc.install_sigterm()
        return svc

    def attach(self, ckpt) -> None:
        """Wire a CheckpointManager's sealed-snapshot retention into the
        donor server: every sealed save republishes the serve-ready view
        and refreshes the leased advert (off the saving thread)."""
        self._ckpt = ckpt
        ckpt.retain_sealed = True
        ckpt.on_sealed = self._on_sealed
        if ckpt.sealed_snapshot() is not None:
            self._on_sealed()

    # -- donor advertising -------------------------------------------------

    def _on_sealed(self) -> None:
        from edl_tpu_torch.train.sharded_checkpoint import snapshot_nbytes

        snap = self._ckpt.sealed_snapshot() if self._ckpt else None
        if snap is None:
            return
        self.server.publish(snap)
        # bytes as stored: quantized moments advert (and serve) their
        # int8 planes, not an fp32 copy
        doc = {"pod_id": self.pod_id, "addr": self.addr,
               "port": self.server.port,
               "version": snap["version"],
               "step": (snap["status"] or {}).get("step"),
               "generation": self.generation,
               "nbytes": snapshot_nbytes(snap),
               "ts": time.time()}
        with self._lock:
            self._advert_doc = doc
            if self._advert_thread is None:
                self._advert_thread = threading.Thread(
                    target=self._advert_loop, daemon=True,
                    name="edl-migrate-advert")
                self._advert_thread.start()
        self._advert_dirty.set()

    def _advert_loop(self) -> None:
        while not self._stop.is_set():
            if not self._advert_dirty.wait(timeout=0.2):
                continue
            self._advert_dirty.clear()
            with self._lock:
                doc = self._advert_doc
            if doc is None:
                continue
            try:
                self.store.put(donor_key(self.job_id, self.pod_id),
                               json.dumps(doc, sort_keys=True),
                               lease=self._ensure_lease())
            except Exception as exc:  # noqa: BLE001 — best-effort: a
                # failed advert only hides this donor from peers
                log.warning("donor advert publish failed: %s", exc)
                self._lease = None

    def flush_advert(self) -> bool:
        """Publish the donor advert for the current sealed snapshot now,
        on the calling thread: the reform quiesce phase needs its fresh
        seal discoverable before peer-restore starts. False when there
        is nothing to advertise or the put failed."""
        self._on_sealed()
        with self._lock:
            doc = self._advert_doc
        if doc is None:
            return False
        try:
            self.store.put(donor_key(self.job_id, self.pod_id),
                           json.dumps(doc, sort_keys=True),
                           lease=self._ensure_lease())
            return True
        except Exception as exc:  # noqa: BLE001 — best-effort, the
            # advert loop retries; the caller falls back to disk
            log.warning("synchronous donor advert failed: %s", exc)
            return False

    def _ensure_lease(self) -> int:
        if self._lease is not None and self._keeper is not None \
                and not self._keeper.lost.is_set():
            return self._lease
        from edl_tpu_torch.coord.client import LeaseKeeper
        if self._keeper is not None:
            self._keeper.stop(revoke=False)
        self._lease = self.store.lease_grant(self.ttl)
        self._keeper = LeaseKeeper(self.store, self._lease,
                                   interval=self.ttl / 6.0).start()
        return self._lease

    # -- reform watch (in-place adoption) ----------------------------------

    def start_reform_watch(self, interval: float = 0.3) -> None:
        if self._watch_thread is not None:
            return
        self._watch_thread = threading.Thread(
            target=self._watch_loop, args=(interval,), daemon=True,
            name="edl-migrate-reform")
        self._watch_thread.start()

    def _watch_loop(self, interval: float) -> None:
        from edl_tpu_torch.collective import register as reg
        from edl_tpu_torch.collective.cluster import Cluster
        from edl_tpu_torch.coord.store import try_watch, \
            watch_resync_interval

        # event-driven: wake on the leader's cluster-snapshot PUT; the
        # fixed poll is the resync net where the store gives no watch
        key = reg.cluster_key(self.job_id)
        watch = try_watch(self.store, key)
        with self._lock:
            self._reform_watch = watch
        wait = interval if watch is None \
            else watch_resync_interval(default=max(interval * 10, 10.0))
        parsed_revision = -1
        first = True
        while not self._stop.is_set():
            if first:
                first = False  # a reform published BEFORE the watch
                # existed has no event: check once immediately
            elif watch is not None:
                watch.get(timeout=wait)  # event or resync tick
                if self._stop.is_set():
                    return
            elif self._stop.wait(interval):
                return
            try:
                rec = self.store.get(key)
            except Exception as exc:  # noqa: BLE001 — transient store
                log.debug("reform watch poll failed: %s", exc)
                continue
            if rec is None or rec.revision == parsed_revision:
                continue
            parsed_revision = rec.revision
            try:
                cluster = Cluster.from_json(rec.value)
            except (ValueError, TypeError):
                continue
            if cluster.version <= self.generation:
                continue
            rank = cluster.rank_of(self.pod_id)
            if rank < 0:
                # evicted from the new world: nothing to adopt; the
                # launcher's SIGTERM drives the graceful donor path
                continue
            with self._lock:
                self._reform = Reform(cluster, rank, cluster.world_size)

    def poll_reform(self) -> Reform | None:
        """The newest pending adoption (cleared by `adopted`)."""
        with self._lock:
            return self._reform

    def adopted(self, reform: Reform) -> None:
        """Mark `reform` consumed and re-stamp this donor's generation
        (newer pending reforms survive the clear)."""
        with self._lock:
            self.generation = reform.generation
            if self._reform is not None \
                    and self._reform.generation <= reform.generation:
                self._reform = None
        # refresh the advert's generation so peers can correlate
        self._advert_dirty.set()

    # -- acks --------------------------------------------------------------

    def live_generation(self) -> int | None:
        """The cluster generation the leader has published (what
        adoption acks are fenced against); None when the doc is
        unreadable: fencing then degrades open, and the launcher's
        `wait_adopted` generation check is the second fence."""
        from edl_tpu_torch.collective import register as reg
        from edl_tpu_torch.collective.cluster import Cluster
        try:
            rec = self.store.get(reg.cluster_key(self.job_id))
            if rec is None:
                return None
            return Cluster.from_json(rec.value).version
        except Exception:  # noqa: BLE001 — transient store error
            return None

    def ack(self, mode: str, *, version: int | None = None,
            downtime_s: float | None = None, bytes_from_peers: int = 0,
            restore_s: float | None = None, generation: int | None = None,
            reform: dict | None = None) -> bool:
        """Record that this pod is trained-and-running in the current
        generation (written after the first post-restore/post-adoption
        step): what lingering donors key their early exit on, and where
        the measured downtime is read from.

        Adoption acks are **generation-fenced**: a survivor that finished
        reforming into generation G while the leader has already
        published G' > G is half-reformed against a dead world; its ack
        BOUNCES (False, nothing written, flight-recorded). `wait_adopted`
        independently requires generation >= the awaited one."""
        gen = self.generation if generation is None else generation
        if mode == "adopted":
            live = self.live_generation()
            if live is not None and live > gen:
                log.warning("stale adoption ack bounced: generation %d "
                            "< live cluster generation %d", gen, live)
                flight.record("reform", who=self.pod_id, stale_ack=True,
                              generation=gen, live_generation=live)
                return False
        doc = {"pod_id": self.pod_id, "mode": mode, "ts": time.time(),
               "pid": os.getpid(),
               "generation": gen, "version": version,
               "downtime_s": downtime_s,
               "bytes_from_peers": int(bytes_from_peers),
               "restore_s": restore_s}
        if reform is not None:
            doc["reform"] = reform
        try:
            self.store.put(ack_key(self.job_id, self.pod_id),
                           json.dumps(doc, sort_keys=True))
            return True
        except Exception as exc:  # noqa: BLE001 — observability only
            log.warning("migration ack failed: %s", exc)
            return False

    # -- restore (consumer side) -------------------------------------------

    def restore_from_peers(self, target: Any, *,
                           local_version: int | None = None,
                           threads: int | None = None,
                           pods: list[str] | None = None):
        return restore_from_peers(self.store, self.job_id, target,
                                  local_version=local_version,
                                  threads=threads, pods=pods)

    # -- lifecycle ---------------------------------------------------------

    def install_sigterm(self) -> None:
        """Turn SIGTERM into a graceful stop: the TrainLoop finishes its
        step, seals the live state, then lingers as a donor. No-op off
        the main thread (the signal API's restriction)."""
        import signal as _signal

        def _handler(signum, frame):
            self._stop_ts = time.time()
            self.stop_requested.set()
        try:
            _signal.signal(_signal.SIGTERM, _handler)
        except ValueError:  # not the main thread
            log.debug("SIGTERM handler not installed (non-main thread)")

    def _linger(self) -> None:
        """Serve until the re-formed world acked or the deadline passes.

        Early exits: every live rank claim has a fresh ack (the new world
        is up), or there are no live claims at all (nobody left to
        serve)."""
        from edl_tpu_torch.collective import register as reg
        since = self._stop_ts or time.time()
        deadline = time.monotonic() + self.linger_s
        log.info("donor linger: serving peers up to %.1fs", self.linger_s)
        while time.monotonic() < deadline:
            try:
                claims, _ = self.store.get_prefix(
                    reg.ranks_prefix(self.job_id))
                acks, _ = self.store.get_prefix(ack_prefix(self.job_id))
            except Exception:  # noqa: BLE001 — store gone: stop serving
                return
            fresh = 0
            for rec in acks:
                try:
                    if float(json.loads(rec.value).get("ts", 0)) >= since:
                        fresh += 1
                except (ValueError, TypeError):
                    continue
            if not claims:
                return
            if fresh >= len(claims):
                log.info("donor linger: %d/%d fresh acks — done", fresh,
                         len(claims))
                return
            time.sleep(0.3)

    def shutdown(self, linger: bool | None = None) -> None:
        """Stop serving. ``linger`` defaults to 'only when a graceful
        stop was requested and we hold something worth serving'."""
        if linger is None:
            linger = (self.stop_requested.is_set()
                      and self.server.snapshot() is not None)
        if linger:
            try:
                self._linger()
            except Exception:  # noqa: BLE001 — teardown must finish
                log.exception("donor linger failed")
        self._stop.set()
        self.server.stop()
        with self._lock:
            reform_watch = self._reform_watch
            self._reform_watch = None
        if reform_watch is not None:
            reform_watch.cancel()  # wakes the blocked event wait
        for t in (self._advert_thread, self._watch_thread):
            if t is not None:
                t.join(timeout=2.0)
        self._advert_thread = self._watch_thread = None
        if self._ckpt is not None:
            self._ckpt.on_sealed = None
        if self._keeper is not None:
            self._keeper.stop(revoke=True)
            self._keeper = None
            self._lease = None
        if self._owns_store:
            self._owns_store = False
            try:
                self.store.close()
            except Exception:  # noqa: BLE001 — teardown
                pass


# -- launcher-side helpers --------------------------------------------------

def wait_adopted(store: Store, job_id: str, pod_id: str, generation: int,
                 timeout: float, poll: float = 0.2,
                 is_alive: Callable[[], bool] | None = None) -> bool:
    """Launcher side of in-place adoption: block until this pod's trainer
    acked mode ``adopted`` at generation >= `generation` (True), the
    trainer died, or the timeout passed (False: fall back to
    stop-resume). Wakes on the ack key's PUT where the store serves
    watches; the check itself stays poll-shaped."""
    from edl_tpu_torch.coord.store import try_watch
    watch = try_watch(store, ack_key(job_id, pod_id))
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            if is_alive is not None and not is_alive():
                return False
            try:
                rec = store.get(ack_key(job_id, pod_id))
            except Exception:  # noqa: BLE001 — transient store error
                rec = None
            if rec is not None:
                try:
                    doc = json.loads(rec.value)
                    if doc.get("mode") == "adopted" \
                            and int(doc.get("generation") or 0) >= generation:
                        return True
                except (ValueError, TypeError):
                    pass
            remaining = deadline - time.monotonic()
            if watch is not None:
                # the ack PUT wakes us at once; the bounded timeout keeps
                # the is_alive check fresh
                watch.get(timeout=max(0.0, min(0.5, remaining)))
            else:
                time.sleep(max(0.0, min(poll, remaining)))
        return False
    finally:
        if watch is not None:
            watch.cancel()


def publish_resize_epoch(store: Store, job_id: str, *, epoch: int,
                         desired: int, prev: int | None = None) -> dict:
    """A resize decision's record: a monotonic migration epoch stamped
    with the donor roster alive at the decision instant (what the
    JobServer's ``/resize`` publishes, `collective/job_server.py`). The
    doc carries the publishing span's context so
    trainers that adopt or restore off this resize join its trace."""
    with trace.span("resize.publish_epoch",
                    attrs={"job": job_id, "epoch": int(epoch),
                           "desired": int(desired)}):
        roster = [{k: d.get(k) for k in ("pod_id", "addr", "port",
                                         "version", "generation")}
                  for d in live_donors(store, job_id)]
        doc = {"epoch": int(epoch), "ts": time.time(), "from": prev,
               "desired": int(desired), "donors": roster}
        ctx = trace.inject()
        if ctx is not None:
            doc["trace"] = ctx
        store.put(epoch_key(job_id), json.dumps(doc, sort_keys=True))
        return doc
