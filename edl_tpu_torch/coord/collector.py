"""Trainer utilization publishing and the scheduler side that reads it
(port of ``edl_tpu.coord.collector``).

`UtilizationPublisher` is a TrainLoop hook (the ``(loop, epoch, step,
metrics)`` signature) that writes this pod's ``{pod_id, rank, epoch,
step, samples_seen, examples_per_sec, world_size, generation,
published_unix, ts}`` to the leased key ``/{job}/util/{pod_id}``; the
lease makes staleness self-cleaning (a dead trainer's record disappears
after its TTL). ``world_size`` is the ELASTIC world (the launcher's pod
count, EDL_TPU_WORLD_SIZE), the unit a scaler allocates in. TrainLoop
installs one when it runs under the elastic launcher (EDL_TPU_RANK set)
unless EDL_TPU_PUBLISH_UTIL=0.

`Collector` is one scrape point for a scheduler: a job's membership with
each pod's utilization record, service registries with a pool-level
rollup (`Collector.service_rollup`: rates and queues sum, a pool's
latency tail is its worst member's), and store health. The scaler's
controller reads jobs and teacher pools through it; ``python -m
edl_tpu_torch.coord.collector --store h:p --job J`` prints snapshots as
JSON lines. The records are the JAX package's, so either package's
collector reads either package's publishers.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from typing import Any

from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.obs import trace
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.coord.collector")


def util_prefix(job_id: str) -> str:
    return f"/{job_id}/util/"


def util_key(job_id: str, pod_id: str) -> str:
    return f"/{job_id}/util/{pod_id}"


class UtilizationPublisher:
    """Publish trainer progress to the pod's leased utilization record.

    ``__call__`` never touches the store: it builds the document and drops
    it into a ONE-SLOT latest-wins mailbox; a background thread owns the
    lease and the store writes, so a hung store cannot stall a train
    step. Publishing is best-effort with a cooldown after failures;
    ``flush()`` waits for the mailbox to drain.
    """

    def __init__(self, store: Store, job_id: str, pod_id: str, *,
                 rank: int = -1, ttl: float = 15.0,
                 min_interval: float = 1.0, generation: int | None = None,
                 world_size: int | None = None):
        self.store = store
        self.job_id = job_id
        self.pod_id = pod_id
        self.rank = rank
        self.ttl = ttl
        self.min_interval = min_interval
        # the cluster generation this trainer runs in (a scaler ties a
        # rate to the allocation that produced it)
        self.generation = generation
        # the elastic world (launcher pod count); None = unknown
        self.world_size = world_size
        # `published_unix` is monotonic per pod even across clock
        # hiccups: a scaler's staleness check subtracts it from now()
        self._pub_unix = 0.0             # guarded-by: _lock
        self._lease: int | None = None
        self._keeper = None
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._last_pub = 0.0             # guarded-by: _lock
        # the rate window seeds on the FIRST call: samples_seen may be
        # restored non-zero from a checkpoint
        self._last_samples: int | None = None  # guarded-by: _lock
        self._last_t = time.monotonic()  # guarded-by: _lock
        # publisher-thread-only until stop() joins it
        self._cooldown_until = 0.0
        self._owns_store = False  # from_env's connection: close on stop
        self._mailbox: "queue.Queue[dict]" = queue.Queue(maxsize=1)
        self._pending = 0                # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # set by the TrainLoop at an adoption or peer restore: the resize
        # trace's span context; the first publish after it emits a
        # zero-duration marker span into that trace and clears it
        self.resize_trace: tuple[str, str] | None = None

    @classmethod
    def from_env(cls) -> "UtilizationPublisher | None":
        """Build from the launcher's trainer env; None when not under the
        elastic launcher or opted out."""
        from edl_tpu_torch.utils import config
        if not config.env_flag("EDL_TPU_PUBLISH_UTIL", True):
            return None
        if not config.env_present("EDL_TPU_RANK"):
            return None  # standalone run: nothing to publish into
        endpoints = config.env_str("EDL_TPU_STORE_ENDPOINTS", "") or ""
        job_id = config.env_str("EDL_TPU_JOB_ID", "") or ""
        pod_id = config.env_str("EDL_TPU_POD_ID", "") or ""
        if not (endpoints and job_id and pod_id):
            return None
        from edl_tpu_torch.coord.redis_store import connect_store
        try:
            store = connect_store(endpoints.split(",")[0])
        except Exception as exc:  # noqa: BLE001 — never block training
            log.warning("utilization publisher disabled (store "
                        "unreachable: %s)", exc)
            return None
        world = config.env_int("EDL_TPU_WORLD_SIZE", 0)
        pub = cls(store, job_id, pod_id,
                  rank=config.env_int("EDL_TPU_RANK", -1),
                  generation=config.env_int("EDL_TPU_CLUSTER_VERSION",
                                            0) or None,
                  world_size=world or None)
        pub._owns_store = True
        return pub

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

    def __call__(self, loop, epoch: int, step: int,
                 metrics: dict | None = None) -> None:
        """Training-thread side: bookkeeping and the mailbox drop only;
        no store I/O happens here."""
        now = time.monotonic()
        with self._lock:
            if self._stop.is_set() \
                    or now - self._last_pub < self.min_interval:
                return
            samples = int(getattr(loop.status, "samples_seen", 0)) \
                if loop is not None else 0
            if self._last_samples is None:  # first call: no window yet
                self._last_samples = samples
                self._last_t = now
            rate = (samples - self._last_samples) / max(
                now - self._last_t, 1e-9) if samples > self._last_samples \
                else 0.0
            self._pub_unix = max(time.time(), self._pub_unix + 1e-4)
            doc = {"pod_id": self.pod_id, "rank": self.rank,
                   "epoch": int(epoch), "step": int(step),
                   "samples_seen": samples,
                   "examples_per_sec": round(max(rate, 0.0), 2),
                   "world_size": self.world_size,
                   "generation": self.generation,
                   "published_unix": round(self._pub_unix, 4),
                   "ts": time.time()}
            self._last_pub = now
            self._last_samples = samples
            self._last_t = now
            # latest-wins: a stalled publisher drops the OLD snapshot
            while True:
                try:
                    self._mailbox.put_nowait(doc)
                    self._pending += 1
                    break
                except queue.Full:
                    try:
                        self._mailbox.get_nowait()
                        self._pending -= 1
                    except queue.Empty:
                        pass
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._publish_loop, daemon=True,
                    name="util-publisher")
                self._thread.start()

    def _publish_loop(self) -> None:
        while not self._stop.is_set():
            try:
                doc = self._mailbox.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._publish(doc)
            finally:
                with self._lock:
                    self._pending -= 1
                    if self._pending <= 0:
                        self._drained.notify_all()

    def _publish(self, doc: dict) -> None:
        now = time.monotonic()
        if now < self._cooldown_until:
            return
        try:
            self.store.put(util_key(self.job_id, self.pod_id),
                           json.dumps(doc, sort_keys=True),
                           lease=self._ensure_lease())
            ctx, self.resize_trace = self.resize_trace, None
            if ctx is not None:
                # the first record at the new world: the tail of the
                # resize trace
                trace.instant("resize.first_fresh_util", parent=ctx,
                              attrs={"pod": self.pod_id,
                                     "world": doc.get("world_size"),
                                     "generation": doc.get("generation")})
        except Exception as exc:  # noqa: BLE001 — best-effort: a
            # publishing failure of any kind never kills training
            log.warning("utilization publish failed (%s); pausing 30s", exc)
            self._cooldown_until = now + 30.0
            self._lease = None

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait for every enqueued snapshot to be published (or dropped
        by the cooldown); True when the mailbox drained in time."""
        with self._drained:
            return self._drained.wait_for(lambda: self._pending <= 0,
                                          timeout=timeout)

    def stop(self) -> None:
        self.flush(timeout=2.0)   # best-effort final snapshot
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._lock:
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


def _parse_info(info: str) -> Any:
    if not info:
        return {}
    try:
        return json.loads(info)
    except json.JSONDecodeError:
        return info  # registrars may publish plain strings


class Collector:
    """One scrape point for a scheduler: job membership + utilization,
    service registries, store health (module docstring has the map)."""

    def __init__(self, store: Store, job_id: str | None = None,
                 services: tuple[str, ...] = (),
                 registry_root: str = "edl"):
        self.store = store
        self.job_id = job_id
        self.services = tuple(services)
        self.registry_root = registry_root

    def _job_snapshot(self, job_id: str) -> dict:
        from edl_tpu_torch.collective import register as reg
        from edl_tpu_torch.collective.cluster import Cluster
        pods, _ = reg.live_pods(self.store, job_id)
        cluster_rec = self.store.get(reg.cluster_key(job_id))
        generation, world = None, None
        if cluster_rec is not None:
            cluster = Cluster.from_json(cluster_rec.value)
            generation, world = cluster.version, cluster.world_size
        util_recs, _ = self.store.get_prefix(util_prefix(job_id))
        util = {}
        for rec in util_recs:
            util[rec.key.rsplit("/", 1)[-1]] = _parse_info(rec.value)
        complete = self.store.get(reg.complete_key(job_id)) is not None
        return {"job_id": job_id,
                "generation": generation,
                "world_size": world,
                "complete": complete,
                "pods": [{"pod_id": p.pod_id,
                          "claimed_rank": p.claimed_rank,
                          "addr": p.addr, "n_devices": p.n_devices,
                          "utilization": util.get(p.pod_id)}
                         for p in pods]}

    def _service_snapshot(self, service: str) -> list[dict]:
        from edl_tpu_torch.coord.registry import ServiceRegistry
        registry = ServiceRegistry(self.store, root=self.registry_root)
        return [{"server": m.server, "info": _parse_info(m.info)}
                for m in registry.get_service(service)]

    def service_rollup(self, service: str) -> dict:
        """Pool-level digest of one service registry — what the serving
        scaler consumes. Rates and queue depths SUM across teachers
        (pool capacity / pool backlog); ``util`` is the mean busy
        fraction (the low-water shrink signal); latency quantiles take
        the WORST reporting teacher — the pool's p95 is its slowest
        member's tail, and a conservative read can only over-provision,
        never silently violate the SLO. ``reporting`` counts teachers
        whose registrar published a parseable info doc: ``n_teachers``
        without ``reporting`` means a pool that is up but blind.

        Admission-control signals (the registrars publish them) roll up:
        ``shed_per_sec`` SUMS (pool-wide rejection pressure — the
        policy's shed-blinded-breach input: an admission-controlled
        pool keeps its p95 in-SLO *by rejecting*, so latency alone
        under-reports overload), ``queue_depth_by_class`` sums per
        class, and ``latency_ms_p95_by_class`` takes the worst teacher
        per class (graceful degradation is judged per class, not
        globally). ``draining`` counts teachers mid-drain."""
        rows, depth, inflight = 0.0, 0, 0
        shed, draining = 0.0, 0
        utils: list[float] = []
        p50s: list[float] = []
        p95s: list[float] = []
        depth_by_class: dict[str, int] = {}
        p95_by_class: dict[str, float] = {}
        members = self._service_snapshot(service)
        reporting = 0
        for m in members:
            info = m["info"]
            if not isinstance(info, dict) or not info:
                continue  # no/unparseable/empty info: a blind member
            reporting += 1
            rows += float(info.get("rows_per_sec") or 0.0)
            depth += int(info.get("queue_depth") or 0)
            inflight += int(info.get("inflight_groups") or 0)
            shed += float(info.get("shed_per_sec") or 0.0)
            draining += 1 if info.get("draining") else 0
            if info.get("util") is not None:
                utils.append(float(info["util"]))
            if info.get("latency_ms_p50") is not None:
                p50s.append(float(info["latency_ms_p50"]))
            if info.get("latency_ms_p95") is not None:
                p95s.append(float(info["latency_ms_p95"]))
            split = info.get("queue_depth_by_class")
            if isinstance(split, dict):
                for cls, n in split.items():
                    try:
                        depth_by_class[str(cls)] = (
                            depth_by_class.get(str(cls), 0) + int(n))
                    except (TypeError, ValueError):
                        pass
            lat_split = info.get("latency_ms_p95_by_class")
            if isinstance(lat_split, dict):
                for cls, p95 in lat_split.items():
                    try:
                        p95_by_class[str(cls)] = max(
                            p95_by_class.get(str(cls), 0.0), float(p95))
                    except (TypeError, ValueError):
                        pass
        return {"service": service,
                "n_teachers": len(members),
                "reporting": reporting,
                "rows_per_sec": round(rows, 2),
                "util": (round(sum(utils) / len(utils), 4)
                         if utils else None),
                "queue_depth": depth,
                "inflight_groups": inflight,
                "latency_ms_p50": max(p50s) if p50s else None,
                "latency_ms_p95": max(p95s) if p95s else None,
                "shed_per_sec": round(shed, 2),
                "queue_depth_by_class": depth_by_class,
                "latency_ms_p95_by_class": p95_by_class,
                "draining": draining}

    def snapshot(self) -> dict:
        records, revision = self.store.get_prefix("")
        doc: dict = {"ts": time.time(),
                     "store": {"revision": revision,
                               "keys": len(records),
                               "leased_keys": sum(
                                   1 for r in records if r.lease)}}
        if self.job_id:
            doc["job"] = self._job_snapshot(self.job_id)
        if self.services:
            doc["services"] = {s: self._service_snapshot(s)
                               for s in self.services}
            doc["service_rollups"] = {s: self.service_rollup(s)
                                      for s in self.services}
        return doc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.coord.collector",
        description="Scrape job/service/store metrics as JSON lines")
    parser.add_argument("--store", required=True,
                        help="store endpoint (host:port or redis://...)")
    parser.add_argument("--job", default="",
                        help="job id to snapshot (/{job}/ keys)")
    parser.add_argument("--services", default="",
                        help="comma-joined service registry names")
    parser.add_argument("--registry-root", default="edl")
    parser.add_argument("--interval", type=float, default=5.0)
    parser.add_argument("--once", action="store_true",
                        help="emit one snapshot and exit")
    args = parser.parse_args(argv)

    from edl_tpu_torch.coord.redis_store import connect_store
    store = connect_store(args.store)
    services = tuple(s for s in args.services.split(",") if s)
    collector = Collector(store, job_id=args.job or None,
                          services=services,
                          registry_root=args.registry_root)
    try:
        while True:
            print(json.dumps(collector.snapshot(), sort_keys=True),
                  flush=True)
            if args.once:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        store.close()


if __name__ == "__main__":
    sys.exit(main())
