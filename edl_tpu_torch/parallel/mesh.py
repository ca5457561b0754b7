"""Slice topology and the process groups of the manual gradient path
(trimmed port of ``edl_tpu.parallel.mesh``: ``SliceTopology``,
``dp_comm_groups`` and ``ep_comm_groups``).

A world is ranks, one card each (``parallel/distributed.py``), laid out
slice-major: rank ``r = s * chips_per_slice + c``. The intra-slice groups
are the contiguous chunks (the dense reduce-scatter / all-gather legs),
the cross-slice groups the stride-C columns (the slow leg, the one the
int8 and top-k wires compress). ``comm_groups`` builds them as
``torch.distributed`` process groups. ``MeshSpec``, the hybrid meshes and
sharding come with ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


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
