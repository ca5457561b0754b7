"""World formation from the launcher's env contract (trimmed port of
``edl_tpu.parallel.distributed``: ``init_from_env``).

One GPU is a world of one: ``init_from_env`` returns the parsed
``TrainerEnv`` and raises for a larger world, whose process group comes
with ROADMAP Queue 1 item 10. The JAX package's
``force_platform_from_env`` and ``make_mesh_from_env`` have no
counterpart here: an entry point takes ``--device`` instead.
"""

from __future__ import annotations

from edl_tpu_torch.collective.job_env import TrainerEnv


def init_from_env(env: TrainerEnv | None = None) -> TrainerEnv:
    """The trainer's world from the EDL_TPU_* env; a world of one only."""
    env = env or TrainerEnv.from_environ()
    if env.world_size > 1:
        raise NotImplementedError(
            f"EDL_TPU_WORLD_SIZE={env.world_size}: multi-GPU worlds "
            "(torch.distributed from the launcher's env) are not ported "
            "yet (ROADMAP Queue 1 item 10)")
    return env
