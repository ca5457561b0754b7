"""Trainer utilization publishing (trimmed copy of
``edl_tpu.coord.collector``: its key layout and `UtilizationPublisher`).

`UtilizationPublisher` is a TrainLoop hook (the ``(loop, epoch, step,
metrics)`` signature) that writes this pod's ``{pod_id, rank, epoch,
step, samples_seen, examples_per_sec, world_size, generation,
published_unix, ts}`` to the leased key ``/{job}/util/{pod_id}``; the
lease makes staleness self-cleaning (a dead trainer's record disappears
after its TTL). ``world_size`` is the ELASTIC world (the launcher's pod
count, EDL_TPU_WORLD_SIZE), the unit a scaler allocates in. TrainLoop
installs one when it runs under the elastic launcher (EDL_TPU_RANK set)
unless EDL_TPU_PUBLISH_UTIL=0. The JAX package's `Collector`, the
scheduler side that reads these records, is ROADMAP Queue 1 item 17; the
records are the same, so it reads the port's.
"""

from __future__ import annotations

import json
import queue
import threading
import time

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
