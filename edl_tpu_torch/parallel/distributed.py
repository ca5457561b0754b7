"""World formation from the launcher's env contract and the collectives
the port runs over it (port of ``edl_tpu.parallel.distributed``:
``init_from_env``, ``slice_topology``, ``make_mesh_from_env``,
``is_initialized`` and ``shutdown``).

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
Tensor parallelism's seams (:func:`copy_to_tp`, :func:`reduce_from_tp`,
:func:`gather_from_tp`, what XLA's partitioner inserts around a tp-sharded
layer in the JAX package) take a tp group's collectives: a process
group's (:class:`GroupComm`) or one process's shards' on a list of
devices (:class:`LocalComm`).
On the gloo backend a CUDA tensor goes through host memory: the choice
is made by the backend's name, for every op, never by catching an error
of a CUDA collective.

``reform_world`` re-forms the world in place for the elastic trainer's
reform state machine (``collective/reform.py``): it drops the current
process group without a barrier (a peer may be gone) and joins the new
``(rank, world, coordinator)``, on the backend the process first joined
with. A rank keeps the card it started on: the world changes, the
trainer's device does not.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from edl_tpu_torch.collective.job_env import TrainerEnv
from edl_tpu_torch.parallel import mesh as mesh_lib
from edl_tpu_torch.parallel.mesh import SliceTopology
from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.parallel.distributed")

# How long a rank waits for the others to join, and for a collective.
TIMEOUT = timedelta(minutes=5)

# the backend this process joined a world with (reform_world reuses it)
_backend: str | None = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_from_env(env: TrainerEnv | None = None, *,
                  backend: str | None = None,
                  device: str | torch.device = "cuda") -> TrainerEnv:
    """Join the world described by the EDL_TPU_* env (no-op for a world
    of one or a repeat call). ``backend`` defaults to the one an earlier
    call chose, else nccl for a CUDA ``device`` and gloo otherwise; the
    first call's backend, in a world of one too, is the one
    ``reform_world`` joins with. Returns the parsed TrainerEnv."""
    global _backend
    env = env or TrainerEnv.from_environ()
    backend = backend or _default_backend(device)
    if _backend is None:
        # the first call's backend is this process's, a world of one's
        # too: a world it grows into in place joins on it
        _backend = backend
    if env.world_size <= 1 or is_initialized():
        return env
    if not env.coordinator:
        raise EdlError(
            f"EDL_TPU_WORLD_SIZE={env.world_size} needs EDL_TPU_COORDINATOR "
            "(host:port of rank 0's store); refusing to guess one")
    if not 0 <= env.rank < env.world_size:
        raise EdlError(f"EDL_TPU_RANK={env.rank} outside a world of "
                       f"{env.world_size}")
    log.info("joining world: rank=%d/%d coordinator=%s backend=%s",
             env.rank, env.world_size, env.coordinator, backend)
    _join(env, backend, TIMEOUT)
    return env


def _default_backend(device) -> str:
    return _backend or ("nccl" if torch.device(device).type == "cuda"
                        else "gloo")


def _join(env: TrainerEnv, backend: str, timeout: timedelta) -> None:
    dist.init_process_group(backend, init_method=f"tcp://{env.coordinator}",
                            rank=env.rank, world_size=env.world_size,
                            timeout=timeout)


def reform_world(env: TrainerEnv, *, backend: str | None = None,
                 device: str | torch.device = "cuda",
                 timeout: timedelta = TIMEOUT) -> TrainerEnv:
    """Tear down the current process group and join the world ``env``
    describes: the mesh-re-formation primitive of the reform state
    machine. A surviving process keeps running and rejoins under its new
    (rank, world, coordinator). The teardown takes no barrier, since a
    peer may be gone. A world of one only tears down. ``backend``
    defaults to the one ``init_from_env`` chose for this process, else
    nccl for a CUDA ``device`` and gloo otherwise; ``timeout`` bounds the
    rendezvous and the new group's collectives.

    Every failure (a coordinator that never comes up, a backend that
    cannot join) raises ``EdlError``, the typed failure the machine's
    mesh-reform phase downgrades on, never a bare crash."""
    backend = backend or _default_backend(device)
    try:
        if is_initialized():
            dist.destroy_process_group()
        if env.world_size > 1:
            if not env.coordinator:
                raise EdlError(f"a world of {env.world_size} needs a "
                               "coordinator")
            log.info("re-forming world: rank=%d/%d coordinator=%s "
                     "backend=%s", env.rank, env.world_size,
                     env.coordinator, backend)
            _join(env, backend, timeout)
    except EdlError:
        raise
    except Exception as exc:  # noqa: BLE001 — typed for the reform
        # machine's mesh-reform downgrade (stop-resume), never a crash
        raise EdlError(f"world re-formation failed: {exc}") from exc
    return env


def leave() -> None:
    """Leave the world now, without a barrier (no-op when none was
    joined): a rank that stops while its peers run on drops its sockets
    at once, so a peer blocked in a collective with it raises instead of
    waiting for this process to exit."""
    if is_initialized():
        dist.destroy_process_group()


def shutdown() -> None:
    """Leave the world (no-op when none was joined), after a barrier: no
    rank leaves before every rank has come to leave, as the JAX package's
    ``jax.distributed.shutdown`` waits at its coordination service's
    shutdown barrier. Under the elastic launcher this keeps rank 0 (the
    checkpoint writer) alive to seal the last checkpoint: a rank that
    exits first completes the job, and the launchers stop the rest."""
    if is_initialized():
        dist.barrier()
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


def make_mesh_from_env(spec=None, env: TrainerEnv | None = None):
    """The mesh a launched trainer trains on, over the joined world:
    hybrid ICI x DCN when the job declares itself multi-slice
    (``slice_topology``), flat otherwise. Collective: every rank calls it
    (the mesh's process groups are created world-wide)."""
    topo = slice_topology(env, world_size())
    if topo.is_multi_slice:
        return mesh_lib.make_hybrid_mesh(spec, topo)
    return mesh_lib.make_mesh(spec)


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


def _shift(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Member i's ``t`` to member (i + shift) mod G; returns what member
    (i - shift) mod G sent."""
    g = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % g) \
        if group is not None else (me + shift) % g
    src_rank = dist.get_global_rank(group, (me - shift) % g) \
        if group is not None else (me - shift) % g
    src = t.contiguous()
    if _staged(t, group):
        src = src.cpu()
    out = torch.empty_like(src)
    req = dist.isend(src, dst, group=group)
    dist.recv(out, src_rank, group=group)
    req.wait()
    return out.to(t.device)


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` round a ring; its backward sends the cotangent
    the other way round, the transpose JAX derives."""

    @staticmethod
    def forward(ctx, t, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(t, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


def ppermute(t: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Member i's ``t`` to member (i + shift) mod G of ``group``
    (differentiable); the identity for a group of one."""
    if not is_initialized() or dist.get_world_size(group) == 1:
        return t
    return _PPermute.apply(t, group, shift)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` with its own transpose as its backward (block i
    to member i and back is the same permutation)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, ctx.group), None


def all_to_all_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_to_all`, differentiable (the MoE dispatch's wire)."""
    if not is_initialized():
        return t
    return _AllToAll.apply(t, group)


# -- tensor parallelism -------------------------------------------------------
#
# A tp group's collectives, behind one small interface (``size``,
# ``index``, ``all_reduce(t)`` -> the sum, a new tensor, and
# ``all_gather(t)`` -> (G, *t.shape)), with two implementations: the ranks
# of a process group (:class:`GroupComm`, the world step's tp axis) and
# the shards of one process on a list of devices (:class:`LocalComm`, the
# one-process teacher). The autograd functions below are the tp layers'
# seams.


def _sum_in_order(parts, like: torch.Tensor) -> torch.Tensor:
    """The ranks' partial sums added in rank order, a 16-bit tensor's in
    fp32 and rounded once: the same bits on every rank."""
    dtype = (torch.float32 if like.dtype in (torch.float16, torch.bfloat16)
             else like.dtype)
    acc = parts[0].to(like.device, dtype, copy=True)
    for p in parts[1:]:
        acc = acc + p.to(like.device, dtype)
    return acc.to(like.dtype)


class GroupComm:
    """tp collectives over a process group (None: the default group),
    through the staged collectives above. A 16-bit tensor's sum is an
    all-gather of the partials (in their own dtype, half the bytes of
    fp32) added in rank order (:func:`_sum_in_order`); any other
    tensor's is the backend's all-reduce."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if t.dtype in (torch.float16, torch.bfloat16):
            return _sum_in_order(self.all_gather(t).unbind(0), t)
        return all_reduce(t.clone(), self.group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather(t, self.group)


class LocalExchange:
    """The meeting point of ``size`` threads of one process, one a tp
    shard: at each collective every shard deposits its tensor and all
    read every slot once all have deposited (one barrier a collective:
    the slots alternate between two sets, and no shard can be two
    collectives ahead of another). A shard that fails breaks the
    barrier, so its peers raise instead of waiting for it; ``reset``
    readies the exchange for the next forward."""

    def __init__(self, size: int, timeout: float = TIMEOUT.total_seconds()):
        import threading

        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.reset()

    def abort(self) -> None:
        self.barrier.abort()

    def reset(self) -> None:
        self.barrier.reset()
        self.slots: list = [[None] * self.size, [None] * self.size]
        self.calls = [0] * self.size


class LocalComm:
    """tp collectives among the shards of one process (each its own
    thread, on its own device; devices may repeat). Every shard adds the
    partial sums in shard order on its own device
    (:func:`_sum_in_order`), so every shard holds the same bits."""

    def __init__(self, exchange: LocalExchange, index: int):
        self.exchange, self.index = exchange, index
        self.size = exchange.size

    def _parts(self, t: torch.Tensor) -> list[torch.Tensor]:
        ex = self.exchange
        slots = ex.slots[ex.calls[self.index] % 2]
        ex.calls[self.index] += 1
        slots[self.index] = t
        ex.barrier.wait()
        return list(slots)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _sum_in_order(self._parts(t), t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.stack([p.to(t.device) for p in self._parts(t)])


def tp_comm(mesh, axis: str = "tp"):
    """The tp collectives of this rank's ``axis`` group of ``mesh``: the
    mesh's :class:`LocalComm` as it is, else a :class:`GroupComm` over its
    process group."""
    group = mesh.group(axis)
    if isinstance(group, LocalComm):
        return group
    return GroupComm(group, mesh.axis_size(axis), mesh.coords[axis])


class _CopyToTp(torch.autograd.Function):
    """The input of a column-parallel layer: the identity forward, and the
    ranks' partial input gradients all-reduced backward."""

    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return t

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad.contiguous()), None


class _ReduceFromTp(torch.autograd.Function):
    """The output of a row-parallel layer: the ranks' partial sums
    all-reduced forward, the gradient passed through backward."""

    @staticmethod
    def forward(ctx, t, comm):
        return comm.all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTp(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim`` forward; each rank's
    own slice of the gradient backward."""

    @staticmethod
    def forward(ctx, t, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return torch.cat(comm.all_gather(t.contiguous()).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        comm = ctx.comm
        return (grad.chunk(comm.size, dim=ctx.dim)[comm.index].contiguous(),
                None, None)


def copy_to_tp(t: torch.Tensor, comm) -> torch.Tensor:
    return _CopyToTp.apply(t, comm)


def reduce_from_tp(t: torch.Tensor, comm) -> torch.Tensor:
    return _ReduceFromTp.apply(t, comm)


def gather_from_tp(t: torch.Tensor, comm, dim: int = -1) -> torch.Tensor:
    return _GatherFromTp.apply(t, comm, dim)


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


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank ``src``'s ``value`` on every rank (the value itself outside a
    world). NCCL broadcasts from the current card, gloo from the host."""
    if not is_initialized():
        return value
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.int64, device=dev)
    dist.broadcast(t, src)
    return int(t.item())


def barrier() -> None:
    if is_initialized():
        dist.barrier()
