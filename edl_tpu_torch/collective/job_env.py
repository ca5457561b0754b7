"""The trainer's half of the job environment contract (trimmed copy of
``edl_tpu.collective.job_env``: ``TrainerEnv``).

A trainer started by the elastic launcher reads back its rank, world
size and job identity from the same ``EDL_TPU_*`` variables as the JAX
package's trainers. The launcher side (``JobEnv``, the cluster document)
comes with the multi-GPU world (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from dataclasses import dataclass

from edl_tpu_torch.utils.config import field, from_env

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
    def is_leader(self) -> bool:
        return self.rank == 0
