"""Cluster membership watcher: sets a flag when the live pod set diverges
(copy of ``edl_tpu.collective.watcher``).

Fed by store watch events (rank-claim prefix + published cluster
snapshot), so a membership change or generation bump is seen at event
latency; the periodic re-check survives as a resync safety net (and as
the whole mechanism where the store gives no watch).
"""

from __future__ import annotations

import threading

from edl_tpu_torch.collective.cluster import Cluster
from edl_tpu_torch.collective import register as reg
from edl_tpu_torch.coord.store import Store, try_watch, \
    watch_resync_interval
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.collective.watcher")


class ClusterWatcher:
    """Watch the rank-claim prefix AND the published cluster version.

    `changed` fires when (a) live membership differs from the baseline
    Cluster this trainer generation was formed with, or (b) a cluster
    snapshot with a *newer version* appears. (b) matters because a pod that
    crashes and rejoins within one poll interval produces no membership
    diff — but its barrier publishes a new generation, which every peer
    must join or the collectives deadlock.
    """

    def __init__(self, store: Store, baseline: Cluster,
                 interval: float = 1.0):
        self.store = store
        self.baseline = baseline
        self.interval = interval
        self.changed = threading.Event()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._watches: list = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"cluster-watch-{baseline.job_id}")

    def start(self) -> "ClusterWatcher":
        # Event-driven: a mutation on the rank-claim prefix or the
        # published cluster snapshot wakes the checker immediately, so
        # membership changes are seen at event latency; the fixed-period
        # poll is demoted to a resync safety net. try_watch -> None
        # keeps the poll loop.
        job_id = self.baseline.job_id
        for prefix in (reg.ranks_prefix(job_id), reg.cluster_key(job_id)):
            watch = try_watch(self.store, prefix)
            if watch is not None:
                thread = threading.Thread(target=self._pump, args=(watch,),
                                          daemon=True,
                                          name=f"cluster-watch-pump-{job_id}")
                thread.start()
                self._watches.append((watch, thread))
        self._thread.start()
        return self

    def _pump(self, watch) -> None:
        while not self._stop.is_set():
            batch = watch.get(timeout=5.0)
            if batch is None:
                if watch.cancelled:
                    return
                continue
            if batch.events or batch.compacted:
                self._wake.set()

    def _run(self) -> None:
        base = self.baseline.pod_ids()
        version = self.baseline.version
        parsed_revision = -1
        # with watches the periodic re-check is only a safety net
        wait = self.interval if not self._watches \
            else watch_resync_interval(default=max(self.interval * 10, 10.0))
        first = True
        while not self._stop.is_set():
            if first:
                first = False  # a change between the baseline snapshot
                # and watch creation has no event: check immediately
            else:
                self._wake.wait(timeout=wait)
                self._wake.clear()
            if self._stop.is_set():
                return
            try:
                pods, _ = reg.live_pods(self.store, self.baseline.job_id)
                rec = self.store.get(reg.cluster_key(self.baseline.job_id))
                # Parse the snapshot only when its store revision moved.
                if rec is not None and rec.revision != parsed_revision:
                    version = Cluster.from_json(rec.value).version
                    parsed_revision = rec.revision
            except Exception as exc:
                log.warning("cluster watch poll failed: %s", exc)
                continue
            now = {p.pod_id for p in pods}
            if now != base:
                log.info("cluster change: %s -> %s",
                         sorted(base), sorted(now))
                self.changed.set()
                return
            if version > self.baseline.version:
                log.info("cluster generation advanced: v%d -> v%d",
                         self.baseline.version, version)
                self.changed.set()
                return

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        for watch, _ in self._watches:
            watch.cancel()
        for _, thread in self._watches:
            thread.join(timeout=2.0)
        self._watches = []
        self._thread.join(timeout=2.0)
