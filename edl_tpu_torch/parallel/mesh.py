"""Named meshes of ranks, slice topology and the process groups over them
(port of ``edl_tpu.parallel.mesh``: ``dcn_axis_of``, ``SliceTopology``,
``MeshSpec`` with ``resolve``/``resolve_hybrid``, ``make_mesh``,
``make_hybrid_mesh``, ``dp_comm_groups``/``ep_comm_groups``,
``shard_batch``, ``form_global_batch``, ``replicate_host_tree``,
``dp_size``).

A world is ranks, one card each (``parallel/distributed.py``). Where the
JAX package lays devices into a ``jax.sharding.Mesh`` and lets XLA's
partitioner emit the collectives, the port's :class:`Mesh` lays RANKS
into the same grid, in the same order, and holds for this rank its
coordinate on each axis and one process group per axis (the ranks that
differ only in that coordinate). The steps call the port's staged
collectives over those groups by hand (``train/step.py``). The meshes
are not ``torch.distributed.device_mesh``: its collectives go straight
to the backend, and the port stages CUDA tensors through host memory on
gloo.

Axes (any may be size 1): dp (data parallel), fsdp (parameters sharded
zero-style), tp, sp, ep. dp and fsdp split the batch
(``train/step.WorldTrainStep``); sp splits the sequence: its ranks hold
the same batch and their sequence blocks, and attention is the ring over
``group("sp")`` (``parallel/ring_attention.py``); ep carries the MoE
token all-to-all (``train/comm.MoECommStep``: every rank its own rows,
the expert tables replicated and each rank running its own experts'
rows); tp shards the transformer's heads, MLP and vocab
(``parallel/sharding.shard_module``): its ranks hold the same rows and
their slices of those leaves, and the model's tp layers run their
collectives over ``group("tp")`` (``parallel/distributed.copy_to_tp``
and its kin). The world step reduces gradients over the ranks that share
a tp coordinate, ``cross_group("tp")``.

Multi-slice: ``make_hybrid_mesh`` places the DCN axis's major component
across slices (dp, or ep when present), everything else inside a slice.
The slice-major rank layout is ``r = s * chips_per_slice + c``; the
intra-slice groups of the manual gradient path are its contiguous
chunks, the cross-slice groups the stride-C columns (``comm_groups``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

# The axis whose collectives are allowed to cross the slow DCN boundary.
DCN_AXIS = "dp"

# The expert-parallel axis; when present it carries the DCN dimension.
EP_AXIS = "ep"

# The axes a batch is split over (the JAX package's data_sharding).
DATA_AXES = ("dp", "fsdp")

# The tensor-parallel axis: its ranks hold the same rows.
TP_AXIS = "tp"


def dcn_axis_of(axes) -> str:
    """The axis carrying the cross-slice (DCN) dimension for a set of
    mesh axis names: ``ep`` when present, else ``dp``."""
    return EP_AXIS if EP_AXIS in axes else DCN_AXIS


@dataclass(frozen=True)
class SliceTopology:
    """Two-level topology: n_slices groups of chips_per_slice ranks, a
    slow edge between slices, a fast one within. (1, n) is the flat
    world."""

    n_slices: int = 1
    chips_per_slice: int = 1

    @property
    def n_devices(self) -> int:
        return self.n_slices * self.chips_per_slice

    @property
    def is_multi_slice(self) -> bool:
        return self.n_slices > 1


@dataclass(frozen=True)
class MeshSpec:
    """Named logical axes and their sizes. -1 means 'absorb the rest'."""

    axes: dict[str, int] = field(default_factory=lambda: {"dp": -1})

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = dict(self.axes)
        wild = [k for k, v in sizes.items() if v == -1]
        fixed = int(np.prod([v for v in sizes.values() if v != -1]))
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        total = int(np.prod(list(sizes.values())))
        if total != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return sizes

    def resolve_hybrid(self, topology: SliceTopology
                       ) -> tuple[dict[str, int], dict[str, int]]:
        """Split each axis size into (dcn, ici) factors against
        (n_slices, chips_per_slice): exactly one axis crosses DCN (ep
        when the spec has one, else dp) with dcn factor n_slices; every
        other axis, and the DCN axis's remaining factor, lives inside a
        slice."""
        n_slices, per_slice = topology.n_slices, topology.chips_per_slice
        sizes = dict(self.axes)
        dcn_name = dcn_axis_of(sizes)
        if n_slices > 1 and dcn_name not in sizes:
            raise ValueError(
                f"multi-slice mesh needs a {DCN_AXIS!r} (or {EP_AXIS!r}) "
                f"axis to carry the DCN dimension; got axes {list(sizes)}")
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        dcn_total = sizes.get(dcn_name, 1)
        if dcn_total != -1 and dcn_total % n_slices != 0:
            raise ValueError(
                f"{dcn_name}={dcn_total} not divisible by n_slices="
                f"{n_slices} ({dcn_name}'s major component spans the "
                f"slices)")
        ici_fixed = int(np.prod(
            [v for k, v in sizes.items() if v != -1 and k != dcn_name]))
        if dcn_total != -1:
            ici_fixed *= dcn_total // n_slices
        if wild:
            if per_slice % ici_fixed != 0:
                raise ValueError(
                    f"chips_per_slice={per_slice} not divisible by fixed "
                    f"in-slice axes of {sizes}")
            if wild[0] == dcn_name:
                sizes[dcn_name] = n_slices * (per_slice // ici_fixed)
            else:
                sizes[wild[0]] = per_slice // ici_fixed
        dcn = {k: (n_slices if k == dcn_name else 1) for k in sizes}
        ici = {k: (v // n_slices if k == dcn_name else v)
               for k, v in sizes.items()}
        if int(np.prod(list(ici.values()))) != per_slice:
            raise ValueError(
                f"mesh {sizes} != {n_slices} slices x {per_slice} chips")
        return dcn, ici


class Mesh:
    """Ranks laid into a named grid: ``devices`` is the int array of
    ranks (the JAX mesh's device order), ``shape`` the axis sizes. For
    this rank: ``coords`` (its index on each axis) and ``group(axis)``,
    the process group of the ranks that share every other coordinate
    (None for the default group when that is the whole world; an axis
    of size 1 has no group and its collectives are the identity)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 rank: int = 0, groups: dict | None = None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not once in the mesh "
                             f"{self.devices.tolist()}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names, map(int, where[0])))
        self._groups = dict(groups or {})

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        return self._groups.get(axis)

    def cross_group(self, axis: str):
        """The group of the ranks that share this rank's ``axis``
        coordinate, every other axis varying (None: the default group,
        or no group where that is this rank alone: see ``size //
        axis_size(axis)``). Built for the tp axis only."""
        return self._groups.get(("cross", axis))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def data_index(self, batch_axes: tuple[str, ...] | None = None
                   ) -> tuple[int, int]:
        """(this rank's slice, slices) of a batch split over
        ``batch_axes`` (default: the data axes present), major to minor
        in the mesh's axis order, as ``P(batch_axes)`` splits dim 0."""
        axes = _batch_axes(self, batch_axes)
        index, count = 0, 1
        for a in axes:
            index = index * self.shape[a] + self.coords[a]
            count *= self.shape[a]
        return index, count

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords})")


def _axis_rank_groups(devices: np.ndarray, axis: int) -> list[list[int]]:
    """Every group of ranks along ``axis``: the other coordinates fixed,
    in row-major order of those coordinates."""
    moved = np.moveaxis(devices, axis, -1)
    return [list(map(int, row)) for row in moved.reshape(-1,
                                                         moved.shape[-1])]


def _build(devices: np.ndarray, names: tuple[str, ...]) -> Mesh:
    """The Mesh over ``devices`` for this process: its rank, and one
    process group per axis. ``dist.new_group`` is collective over the
    world, so every rank creates every group in the same order."""
    initialized = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if initialized else 0
    world = dist.get_world_size() if initialized else 1
    if devices.size != world:
        raise ValueError(f"mesh of {devices.size} ranks over a world of "
                         f"{world}")
    groups = {}
    if initialized:
        for i, name in enumerate(names):
            if devices.shape[i] == 1:
                continue
            for ranks in _axis_rank_groups(devices, i):
                pg = None if len(ranks) == world else dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = pg
        if TP_AXIS in names:
            i = names.index(TP_AXIS)
            tp = devices.shape[i]
            if tp > 1 and world > tp:
                for ranks in np.moveaxis(devices, i, 0).reshape(tp, -1):
                    ranks = list(map(int, ranks))
                    pg = dist.new_group(ranks)
                    if rank in ranks:
                        groups[("cross", TP_AXIS)] = pg
    return Mesh(devices, names, rank, groups)


def make_mesh(spec: MeshSpec | None = None, n_devices: int | None = None,
              devices: list | None = None) -> Mesh:
    """The mesh over the world's ranks (``devices``: ranks in order,
    default every rank of the joined world; ``n_devices`` checks the
    count), laid out as ``spec`` resolves."""
    spec = spec or MeshSpec()
    if devices is None:
        devices = list(range(_world()))
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"want {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    sizes = spec.resolve(len(devices))
    arr = np.array(devices, dtype=np.int64).reshape(tuple(sizes.values()))
    return _build(arr, tuple(sizes.keys()))


def hybrid_device_grid(spec: MeshSpec, topology: SliceTopology,
                       devices: list) -> tuple[np.ndarray, tuple[str, ...]]:
    """The JAX package's hybrid device order over ``devices`` (slice
    major, slices contiguous): each named axis dcn-major x ici-minor."""
    dcn, ici = spec.resolve_hybrid(topology)
    names = list(spec.axes.keys())
    grid = np.array(devices, dtype=np.int64).reshape(
        tuple(dcn[n] for n in names) + tuple(ici[n] for n in names))
    k = len(names)
    grid = grid.transpose(
        [x for pair in zip(range(k), range(k, 2 * k)) for x in pair])
    return grid.reshape(tuple(dcn[n] * ici[n] for n in names)), tuple(names)


def make_hybrid_mesh(spec: MeshSpec | None = None,
                     topology: SliceTopology | None = None,
                     devices: list | None = None,
                     n_devices: int | None = None) -> Mesh:
    """A two-level ICI x DCN mesh: the DCN axis's major dimension
    enumerates slices (contiguous rank chunks), everything else stays
    slice-local. Nothing on a GPU host reports slices, so ``topology``
    defaults to the flat world, which degenerates to :func:`make_mesh`."""
    spec = spec or MeshSpec()
    if devices is None:
        devices = list(range(_world()))
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"want {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    topology = topology or SliceTopology(1, len(devices))
    if topology.n_devices != len(devices):
        raise ValueError(
            f"topology {topology.n_slices}x{topology.chips_per_slice} != "
            f"{len(devices)} devices")
    if not topology.is_multi_slice:
        return make_mesh(spec, devices=devices)
    return _build(*hybrid_device_grid(spec, topology, list(devices)))


def _world() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def dp_comm_groups(n_slices: int, chips_per_slice: int
                   ) -> tuple[list[list[int]], list[list[int]]]:
    """(intra-slice, cross-slice) rank groups over a slice-major dp
    world: the C-contiguous chunks and the stride-C columns."""
    intra = [[s * chips_per_slice + c for c in range(chips_per_slice)]
             for s in range(n_slices)]
    cross = [[s * chips_per_slice + c for s in range(n_slices)]
             for c in range(chips_per_slice)]
    return intra, cross


def ep_comm_groups(n_slices: int, chips_per_slice: int
                   ) -> tuple[list[list[int]], list[list[int]]]:
    """The expert-parallel mirror of :func:`dp_comm_groups`: the same
    slice-major arithmetic, carrying the token all-to-all's legs."""
    if n_slices < 1 or chips_per_slice < 1:
        raise ValueError(
            f"ep_comm_groups needs positive factors, got "
            f"{n_slices}x{chips_per_slice}")
    return dp_comm_groups(n_slices, chips_per_slice)


def comm_groups(n_slices: int, chips_per_slice: int):
    """This rank's (intra-slice, cross-slice) process groups.

    ``dist.new_group`` is collective over the whole world, so every rank
    creates every group, in the same order (intra groups, then cross
    groups), and keeps the two it belongs to. A group spanning the whole
    world is the default group (None); a one-rank intra group is None
    too (no intra leg runs when chips_per_slice is 1).
    """
    world = dist.get_world_size()
    if n_slices * chips_per_slice != world:
        raise ValueError(f"topology {n_slices}x{chips_per_slice} does not "
                         f"cover the world of {world} ranks")
    rank = dist.get_rank()
    intra, cross = dp_comm_groups(n_slices, chips_per_slice)
    mine = []
    for groups in (intra, cross):
        own = None
        for ranks in groups:
            if len(ranks) in (1, world):
                continue
            pg = dist.new_group(ranks)
            if rank in ranks:
                own = pg
        mine.append(own)
    return mine[0], mine[1]


# -- batches over the mesh ---------------------------------------------------


def _batch_axes(mesh: Mesh, batch_axes) -> tuple[str, ...]:
    if batch_axes is None:
        batch_axes = DATA_AXES
    return tuple(a for a in batch_axes if a in mesh.axis_names)


def _as_tensor(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device) if device is not None else t


def shard_batch(mesh: Mesh, batch: dict,
                batch_axes: tuple[str, ...] | None = None,
                device=None) -> dict:
    """This rank's contiguous slice (dim 0) of a host-side GLOBAL batch,
    as tensors on ``device``: the rows ``P(batch_axes)`` places on this
    rank's device in the JAX package. No data axis: the whole batch."""
    index, count = mesh.data_index(batch_axes)
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % count:
            raise ValueError(f"batch {k!r} of {n} rows does not split over "
                             f"{count} data-parallel ranks")
        rows = n // count
        out[k] = _as_tensor(v[index * rows:(index + 1) * rows], device)
    return out


def form_global_batch(mesh: Mesh, local_batch: dict,
                      batch_axes: tuple[str, ...] | None = None,
                      device=None) -> dict:
    """Each rank passes its own contiguous slice of the global batch (in
    rank order over the data axes) and keeps it: in the port the global
    batch is the ranks' slices taken together, so this places the local
    slice on ``device``. A mesh without data axes holds the full batch on
    every rank (:func:`replicate_host_tree`)."""
    return {k: _as_tensor(v, device) for k, v in local_batch.items()}


def replicate_host_tree(mesh: Mesh, tree: dict, device=None) -> dict:
    """A host tree identical on every rank, placed whole on ``device``."""
    del mesh
    return {k: _as_tensor(v, device) for k, v in tree.items()}


def dp_size(mesh: Mesh) -> int:
    size = 1
    for axis in DATA_AXES:
        if axis in mesh.axis_names:
            size *= mesh.shape[axis]
    return size
