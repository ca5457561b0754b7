"""World formation from the launcher's env contract and the collectives
the port runs over it (port of ``edl_tpu.parallel.distributed``:
``init_from_env``, ``slice_topology``, ``is_initialized`` and
``shutdown``).

A world is ranks, one card each. In the JAX package one process per host
owns all of that host's chips and ``EDL_TPU_WORLD_SIZE`` counts
processes whose devices XLA joins into one mesh; here one process owns
one card: ``EDL_TPU_WORLD_SIZE`` counts ranks, and rank r trains on
``cuda:{r % torch.cuda.device_count()}`` (:func:`rank_device`). On a
host with fewer cards than ranks, ranks share a card; NCCL refuses two
ranks on one card, so such a world runs on gloo.

``init_from_env`` joins the world with
``torch.distributed.init_process_group(init_method="tcp://<coordinator>")``
(rank 0 hosts the store), on the backend the caller names: by default
``nccl`` for a CUDA device and ``gloo`` for the CPU. It is idempotent.
A world above one with an empty ``EDL_TPU_COORDINATOR`` raises
``EdlError`` before any connection is attempted.

The collectives (:func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`all_to_all`, :func:`broadcast`) take a
process group where the JAX package takes an axis name and index groups.
Without a process group the world is one rank and each is the identity.
On the gloo backend a CUDA tensor goes through host memory: the choice
is made by the backend's name, for every op, never by catching an error
of a CUDA collective. ``reform_world`` comes with the elastic items.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from edl_tpu_torch.collective.job_env import TrainerEnv
from edl_tpu_torch.parallel.mesh import SliceTopology
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.parallel.distributed")

# How long a rank waits for the others to join, and for a collective.
TIMEOUT = timedelta(minutes=5)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_from_env(env: TrainerEnv | None = None, *,
                  backend: str | None = None,
                  device: str | torch.device = "cuda") -> TrainerEnv:
    """Join the world described by the EDL_TPU_* env (no-op for a world
    of one or a repeat call). ``backend`` defaults to nccl for a CUDA
    ``device`` and gloo otherwise. Returns the parsed TrainerEnv."""
    env = env or TrainerEnv.from_environ()
    if env.world_size <= 1 or is_initialized():
        return env
    if not env.coordinator:
        raise EdlError(
            f"EDL_TPU_WORLD_SIZE={env.world_size} needs EDL_TPU_COORDINATOR "
            "(host:port of rank 0's store); refusing to guess one")
    if not 0 <= env.rank < env.world_size:
        raise EdlError(f"EDL_TPU_RANK={env.rank} outside a world of "
                       f"{env.world_size}")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    log.info("joining world: rank=%d/%d coordinator=%s backend=%s",
             env.rank, env.world_size, env.coordinator, backend)
    dist.init_process_group(backend, init_method=f"tcp://{env.coordinator}",
                            rank=env.rank, world_size=env.world_size,
                            timeout=TIMEOUT)
    return env


def shutdown() -> None:
    """Leave the world (no-op when none was joined)."""
    if is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def rank_device(device: str | torch.device, rank_: int) -> torch.device:
    """The card of rank ``rank_``: ``cuda:{rank % device_count}`` for a
    CUDA device without an index; any other device as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank_ % torch.cuda.device_count())
    return device


def slice_topology(env: TrainerEnv | None = None,
                   world: int | None = None) -> SliceTopology:
    """The job's slice topology over ``world`` ranks (default: the
    env's world size): EDL_TPU_SLICES > 1 pins the slice count, else the
    world is flat. Nothing on a GPU host reports slices, so there is no
    hardware detection."""
    env = env or TrainerEnv.from_environ()
    world = max(1, env.world_size) if world is None else world
    if env.n_slices > 1:
        if world % env.n_slices:
            raise ValueError(f"{world} ranks not divisible by "
                             f"EDL_TPU_SLICES={env.n_slices}")
        return SliceTopology(env.n_slices, world // env.n_slices)
    return SliceTopology(1, world)


# -- collectives -------------------------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through host memory: a CUDA tensor on gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    if not is_initialized():
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every member's ``t`` stacked in group-rank order: (G, *t.shape)."""
    if not is_initialized():
        return t.unsqueeze(0)
    g = dist.get_world_size(group)
    src = t.contiguous()
    if _staged(t, group):
        src = src.cpu()
    out = src.new_empty(g * src.numel())
    dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    return out.view(g, *t.shape).to(t.device)


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group of a flat ``t``, tiled: member i keeps
    chunk i of G (``psum_scatter(..., tiled=True)``)."""
    if not is_initialized():
        return t
    g = dist.get_world_size(group)
    if t.dim() != 1 or t.numel() % g:
        raise ValueError(f"reduce_scatter takes a flat tensor divisible by "
                         f"{g}, got {tuple(t.shape)}")
    src = t.contiguous()
    if _staged(t, group):
        src = src.cpu()
    out = src.new_empty(t.numel() // g)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device)


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Block i of dim 0 goes to member i; the result holds the blocks
    received, in source order (``all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``)."""
    if not is_initialized():
        return t
    src = t.contiguous()
    if _staged(t, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` to every member, in place; returns ``t``."""
    if not is_initialized():
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


def barrier() -> None:
    if is_initialized():
        dist.barrier()
