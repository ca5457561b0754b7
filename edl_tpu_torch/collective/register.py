"""Pod rank claim: smallest-free-slot CAS race with lease keepalive (copy
of ``edl_tpu.collective.register``).

Key layout:
    /{job}/ranks/{i}   -> Pod JSON, leased (ephemeral)   — the claim
    /{job}/cluster     -> Cluster JSON, permanent        — leader-published
    /{job}/complete    -> "1", permanent                 — job done marker

``release()`` revokes the lease eagerly (never a TTL drain) so the peers'
watchers see a graceful departure at once.
"""

from __future__ import annotations

import threading
import time

from edl_tpu_torch.collective.cluster import Pod
from edl_tpu_torch.coord.client import HostLeaseCoalescer, LeaseKeeper
from edl_tpu_torch.coord.store import Store, try_watch
from edl_tpu_torch.utils.exceptions import EdlRegisterError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.collective.register")


def ranks_prefix(job_id: str) -> str:
    return f"/{job_id}/ranks/"

def rank_key(job_id: str, rank: int) -> str:
    return f"/{job_id}/ranks/{rank:06d}"

def cluster_key(job_id: str) -> str:
    return f"/{job_id}/cluster"

def complete_key(job_id: str) -> str:
    return f"/{job_id}/complete"


def live_pods(store: Store, job_id: str) -> tuple[list[Pod], int]:
    """Snapshot of currently-claimed pods (sorted by claimed rank)."""
    records, revision = store.get_prefix(ranks_prefix(job_id))
    pods = [Pod.from_json(r.value) for r in records]
    return sorted(pods, key=lambda p: p.claimed_rank), revision


class PodRegister:
    """Claim + keep a rank slot for this pod.

    The claim is leased: if this process dies, the slot frees after TTL and
    the watcher on every other pod sees the membership change.
    """

    def __init__(self, store: Store, job_id: str, pod: Pod,
                 max_nodes: int = 1024, ttl: float = 10.0,
                 coalescer: HostLeaseCoalescer | None = None):
        self.store = store
        self.job_id = job_id
        self.pod = pod
        self.max_nodes = max_nodes
        self.ttl = ttl
        self.lease: int | None = None
        self.lost = threading.Event()
        self._keeper: LeaseKeeper | None = None
        # Lease coalescing: with a coalescer the claim rides the HOST
        # lease (one keepalive writer per host, not per pod) and release
        # detaches just this pod's key — siblings on the shared lease are
        # untouched.
        self._coalescer = coalescer
        self._claimed_key: str | None = None

    def claim(self, timeout: float = 60.0) -> int:
        """Race for the smallest free slot. Returns the claimed rank."""
        deadline = time.monotonic() + timeout
        watch = None
        try:
            while time.monotonic() < deadline:
                lease = self._coalescer.lease() \
                    if self._coalescer is not None \
                    else self.store.lease_grant(self.ttl)
                for i in range(self.max_nodes):
                    self.pod.claimed_rank = i
                    if self.store.put_if_absent(rank_key(self.job_id, i),
                                                self.pod.to_json(),
                                                lease=lease):
                        self.lease = lease
                        self._claimed_key = rank_key(self.job_id, i)
                        if self._coalescer is not None:
                            self._coalescer.attach(self._claimed_key,
                                                   on_lost=self._on_lost)
                        else:
                            self._keeper = LeaseKeeper(
                                self.store, lease, interval=self.ttl / 6.0,
                                on_lost=self._on_lost).start()
                        log.info("pod %s claimed rank %d",
                                 self.pod.pod_id, i)
                        return i
                # Every slot taken: revoke the unused lease and retry when
                # a slot frees (its DELETE event wakes us; the 1s re-poll
                # is the fallback where the store gives no watch).
                # A coalesced host lease is shared — never revoke it here.
                if self._coalescer is None:
                    self.store.lease_revoke(lease)
                if watch is None:
                    watch = try_watch(self.store, ranks_prefix(self.job_id))
                if watch is not None:
                    watch.get(timeout=1.0)
                else:
                    time.sleep(1.0)
            raise EdlRegisterError(
                f"no free rank slot in {self.max_nodes} after {timeout}s")
        finally:
            if watch is not None:
                watch.cancel()

    def _on_lost(self) -> None:
        log.error("pod %s lost its rank lease", self.pod.pod_id)
        self.lost.set()

    def refresh_value(self) -> None:
        """Rewrite our key (e.g. after port change), keeping the lease."""
        if self.lease is not None:
            self.store.put(rank_key(self.job_id, self.pod.claimed_rank),
                           self.pod.to_json(), lease=self.lease)

    def release(self) -> None:
        if self._coalescer is not None and self._claimed_key is not None:
            # per-pod revoke on the shared lease: delete only our key
            self._coalescer.detach(self._claimed_key, delete=True)
            self._claimed_key = None
            self.lease = None
        if self._keeper is not None:
            self._keeper.stop(revoke=True)
            self._keeper = None
            self.lease = None

    def close(self) -> None:
        """Teardown alias for `release`."""
        self.release()
