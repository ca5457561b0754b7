"""Job + trainer environment contracts (copy of
``edl_tpu.collective.job_env``).

`JobEnv` is what the elastic launcher reads (``collective/launch.py``);
`trainer_environ` is the env block it hands the trainer it spawns, and
`TrainerEnv` is what that trainer reads back: its rank, world size, job
identity and the cluster document, under the same ``EDL_TPU_*`` names
and defaults as the JAX package's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from edl_tpu_torch.collective.cluster import Cluster
from edl_tpu_torch.utils import net, unique_name
from edl_tpu_torch.utils.config import field, from_env


@dataclass
class JobEnv:
    job_id: str = field("default_job", env="EDL_TPU_JOB_ID")
    pod_id: str = field("", env="EDL_TPU_POD_ID")
    store_endpoints: str = field("127.0.0.1:2379",
                                 env="EDL_TPU_STORE_ENDPOINTS")
    nodes_range: str = field("1:16", env="EDL_TPU_NODES_RANGE")  # "min:max"
    nproc_per_node: int = field(0, env="EDL_TPU_NPROC_PERNODE")  # 0 = auto
    # Multi-slice topology: how many slices the job spans (0 = auto; >1
    # partitions the pods rank-contiguously into slices).
    slices: int = field(0, env="EDL_TPU_SLICES")
    up_limit_nodes: int = field(1024, env="EDL_TPU_UP_LIMIT_NODES")
    checkpoint_path: str = field("", env="EDL_TPU_CHECKPOINT_PATH")
    job_server: str = field("", env="EDL_TPU_JOBSERVER")
    log_dir: str = field("./log", env="EDL_TPU_LOG_DIR")
    lease_ttl: float = field(10.0, env="EDL_TPU_LEASE_TTL")
    barrier_stable_secs: float = field(2.0, env="EDL_TPU_BARRIER_STABLE")
    barrier_timeout: float = field(300.0, env="EDL_TPU_BARRIER_TIMEOUT")
    # After a local crash/lease loss, how long to stay unregistered before
    # re-claiming (must exceed peers' watcher poll interval so the blip is
    # observed).
    rejoin_delay_secs: float = field(3.0, env="EDL_TPU_REJOIN_DELAY")
    # Peer-to-peer live state migration (collective/migration.py): on a
    # membership change, surviving trainers adopt the new world IN PLACE
    # and every trainer serves its sealed snapshot to (re)starting
    # peers, with disk as the fallback. 0 restores the pure
    # stop-resume-from-disk recipe.
    resize_p2p: bool = field(True, env="EDL_TPU_RESIZE_P2P")
    # How long a SIGTERM'd trainer keeps serving its snapshot to the
    # re-formed world before exiting (early-exits once every live pod has
    # acked).
    donor_linger_secs: float = field(10.0, env="EDL_TPU_DONOR_LINGER")
    # How long the launcher waits for its trainer to ack an in-place
    # adoption before falling back to stop-resume with a donor linger.
    adopt_timeout_secs: float = field(10.0, env="EDL_TPU_ADOPT_TIMEOUT")

    def __post_init__(self):
        if not self.pod_id:
            self.pod_id = unique_name.client_id()

    @property
    def min_nodes(self) -> int:
        return int(self.nodes_range.split(":")[0])

    @property
    def max_nodes(self) -> int:
        parts = self.nodes_range.split(":")
        return min(int(parts[-1]), self.up_limit_nodes)

    @classmethod
    def from_environ(cls, **overrides) -> "JobEnv":
        return from_env(cls, **overrides)


TRAINER_ENV_VARS = ("EDL_TPU_RANK", "EDL_TPU_WORLD_SIZE",
                    "EDL_TPU_COORDINATOR", "EDL_TPU_CLUSTER_JSON",
                    "EDL_TPU_JOB_ID", "EDL_TPU_POD_ID",
                    "EDL_TPU_CHECKPOINT_PATH", "EDL_TPU_STORE_ENDPOINTS",
                    "EDL_TPU_CLUSTER_VERSION", "EDL_TPU_SLICES",
                    "EDL_TPU_SLICE_ID")


@dataclass
class TrainerEnv:
    """What a spawned trainer process sees."""

    rank: int = field(0, env="EDL_TPU_RANK")
    world_size: int = field(1, env="EDL_TPU_WORLD_SIZE")
    coordinator: str = field("", env="EDL_TPU_COORDINATOR")
    cluster_json: str = field("", env="EDL_TPU_CLUSTER_JSON")
    job_id: str = field("", env="EDL_TPU_JOB_ID")
    pod_id: str = field("", env="EDL_TPU_POD_ID")
    checkpoint_path: str = field("", env="EDL_TPU_CHECKPOINT_PATH")
    store_endpoints: str = field("", env="EDL_TPU_STORE_ENDPOINTS")
    cluster_version: int = field(0, env="EDL_TPU_CLUSTER_VERSION")
    n_slices: int = field(0, env="EDL_TPU_SLICES")
    slice_id: int = field(-1, env="EDL_TPU_SLICE_ID")

    @classmethod
    def from_environ(cls, **overrides) -> "TrainerEnv":
        return from_env(cls, **overrides)

    @property
    def cluster(self) -> Cluster | None:
        return Cluster.from_json(self.cluster_json) \
            if self.cluster_json else None

    @property
    def is_leader(self) -> bool:
        return self.rank == 0


def slice_of_rank(rank: int, world_size: int, n_slices: int) -> int:
    """Rank-contiguous slice assignment: ranks [0, w/s) -> slice 0, etc.
    When each pod spans several slices (n_slices a multiple of
    world_size) no single slice id applies: -1 (auto). Anything else is
    a misconfiguration and raises."""
    if n_slices <= 1:
        return 0
    if world_size % n_slices == 0:
        return rank // (world_size // n_slices)
    if n_slices % world_size == 0:
        return -1  # pod-local multi-slice: id is per-device, not per-pod
    raise ValueError(
        f"world_size={world_size} not divisible by "
        f"EDL_TPU_SLICES={n_slices} (nor vice versa)")


def trainer_environ(cluster: Cluster, pod_id: str, job: JobEnv) -> dict:
    """Env block for the trainer subprocess: this process's env with the
    trainer contract set from the cluster and the job. Nothing here
    picks the trainer's device: that is its own command line's."""
    env = dict(os.environ)
    rank = cluster.rank_of(pod_id)
    env.update({
        "EDL_TPU_RANK": str(rank),
        "EDL_TPU_WORLD_SIZE": str(cluster.world_size),
        "EDL_TPU_COORDINATOR": cluster.coordinator,
        "EDL_TPU_CLUSTER_JSON": cluster.to_json(),
        "EDL_TPU_JOB_ID": job.job_id,
        "EDL_TPU_POD_ID": pod_id,
        "EDL_TPU_CHECKPOINT_PATH": job.checkpoint_path,
        "EDL_TPU_STORE_ENDPOINTS": job.store_endpoints,
        "EDL_TPU_CLUSTER_VERSION": str(cluster.version),
        "EDL_TPU_SLICES": str(job.slices),
        "EDL_TPU_SLICE_ID": str(
            slice_of_rank(rank, cluster.world_size, job.slices)
            if job.slices > 1 else -1),
    })
    return env


def local_addr() -> str:
    return net.host_ip()
