"""Stop-resume cluster barrier: stability-gated leader-published snapshots
(copy of ``edl_tpu.collective.barrier``).

The *leader* (live pod with the smallest claimed rank) waits until
membership has been stable for `stable_secs`, then CAS-publishes a
versioned Cluster snapshot; followers poll until a snapshot appears that
(a) has a version above the one they last trained under and (b) contains
them. The coordination store is the only dependency, so the barrier
inherits its fault tolerance.
"""

from __future__ import annotations

import time

from edl_tpu_torch.collective.cluster import Cluster, form_cluster
from edl_tpu_torch.collective import register as reg
from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.utils.exceptions import EdlBarrierError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.collective.barrier")


def read_cluster(store: Store, job_id: str) -> Cluster | None:
    rec = store.get(reg.cluster_key(job_id))
    return Cluster.from_json(rec.value) if rec else None


def cluster_barrier(store: Store, job_id: str, pod_id: str, *,
                    after_version: int = 0, min_nodes: int = 1,
                    stable_secs: float = 2.0, timeout: float = 300.0,
                    poll: float = 0.2) -> Cluster:
    """Block until a fresh Cluster containing `pod_id` is published.

    Any participant may act as leader the moment it observes itself as the
    smallest live claimed rank — leadership needs no election because the
    publish is a CAS keyed on the previous snapshot version (losers simply
    observe the winner's snapshot).
    """
    deadline = time.monotonic() + timeout
    stable_since: float | None = None
    last_membership: frozenset[str] | None = None

    while time.monotonic() < deadline:
        current = read_cluster(store, job_id)
        if (current is not None and current.version > after_version
                and pod_id in current.pod_ids()):
            live, _ = reg.live_pods(store, job_id)
            if current.same_membership({p.pod_id for p in live}):
                return current
            # Snapshot already stale (member died since publish) — keep
            # waiting; the leader will publish a successor.

        pods, _ = reg.live_pods(store, job_id)
        membership = frozenset(p.pod_id for p in pods)
        now = time.monotonic()
        if membership != last_membership:
            last_membership = membership
            stable_since = now
        i_am_leader = bool(pods) and pods[0].pod_id == pod_id
        enough = len(pods) >= min_nodes and pod_id in membership
        stable = stable_since is not None and now - stable_since >= stable_secs
        if i_am_leader and enough and stable:
            base_version = (current.version if current else 0)
            if base_version < after_version:
                base_version = after_version
            nxt = form_cluster(job_id, base_version + 1, pods)
            expect = current.to_json() if current else None
            if store.compare_and_swap(reg.cluster_key(job_id), expect,
                                      nxt.to_json()):
                log.info("leader %s published cluster v%d (%d pods)",
                         pod_id, nxt.version, nxt.world_size)
                return nxt
            # CAS lost: someone else published; loop re-reads it.
        time.sleep(poll)

    raise EdlBarrierError(
        f"barrier timeout after {timeout}s (job={job_id} pod={pod_id})")
