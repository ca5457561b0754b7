"""Pod/Cluster model: membership snapshot with JSON round-trip + equality
(copy of ``edl_tpu.collective.cluster``; ``to_json`` gives its bytes).

A `Pod` is one launcher. A `Cluster` is the leader-published membership
snapshot: pods ordered by their *claimed* registry rank, each assigned a
dense `rank` (the trainer's ``torch.distributed`` rank). Equality of the
pod-id set (not object identity) is the elastic change detector.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass
class Pod:
    pod_id: str                 # unique per launcher process
    addr: str                   # host ip
    port: int = 0               # trainer coordinator port (rank 0's is used)
    n_devices: int = 1          # local accelerator count
    claimed_rank: int = -1      # registry slot claimed via CAS
    rank: int = -1              # dense rank assigned at cluster formation

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Pod":
        return cls(**json.loads(s))

    @property
    def endpoint(self) -> str:
        return f"{self.addr}:{self.port}"


@dataclass
class Cluster:
    job_id: str
    version: int = 0
    pods: list[Pod] = field(default_factory=list)

    def __post_init__(self):
        self.pods = [Pod(**p) if isinstance(p, dict) else p
                     for p in self.pods]

    @property
    def world_size(self) -> int:
        return len(self.pods)

    @property
    def n_devices(self) -> int:
        return sum(p.n_devices for p in self.pods)

    @property
    def coordinator(self) -> str:
        """rank-0 pod endpoint: the world's rendezvous address."""
        return self.pods[0].endpoint if self.pods else ""

    def pod_ids(self) -> set[str]:
        return {p.pod_id for p in self.pods}

    def rank_of(self, pod_id: str) -> int:
        for p in self.pods:
            if p.pod_id == pod_id:
                return p.rank
        return -1

    def same_membership(self, other: "Cluster | set[str]") -> bool:
        ids = other if isinstance(other, set) else other.pod_ids()
        return self.pod_ids() == ids

    def to_json(self) -> str:
        return json.dumps({"job_id": self.job_id, "version": self.version,
                           "pods": [asdict(p) for p in self.pods]},
                          sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Cluster":
        return cls(**json.loads(s))


def form_cluster(job_id: str, version: int, pods: list[Pod]) -> Cluster:
    """Order pods by claimed rank and assign dense ranks 0..N-1."""
    ordered = sorted(pods, key=lambda p: p.claimed_rank)
    out = []
    for i, p in enumerate(ordered):
        q = Pod(**asdict(p))
        q.rank = i
        out.append(q)
    return Cluster(job_id=job_id, version=version, pods=out)
