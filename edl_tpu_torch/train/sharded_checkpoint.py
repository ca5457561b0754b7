"""Chunk + index checkpoints of whole tensors, and restore from any chunk
layout (port of ``edl_tpu.train.sharded_checkpoint``).

The format is the JAX package's (``train/ckpt_io.py``): one ``.npy`` a
chunk and ``index.{process}.json`` tables naming each leaf by
``jax.tree_util.keystr`` of its path in the TrainState tree
(``.params['Dense_0']['kernel']``, ``.opt_state.m[0].q``). The port's
tensors are whole on every rank, so rank 0 writes each leaf as one chunk
covering it, which is what the JAX package writes for a replicated leaf.

Restore reads any layout: a JAX save from an FSDP mesh of 4 or 8 devices
splits a leaf into several chunks, and ``read_region`` assembles each
leaf whole (a coverage hole raises) through a per-file handle cache that
verifies each chunk's sealed crc32 once (``EdlCheckpointCorrupt``).
The result is the state dict ``serialization.msgpack_restore`` gives for
the replicated format, rebuilt from the keys, so one ``flax_to_state``
writes either into the live state.

A rank of a sharded world (``parallel/sharding.shard_module``: fsdp, tp
or both) writes its own chunks (``snapshot_shard_tree`` of
``bridge.sharded_state_tree``): each sharded leaf's slice at its offset
in the whole leaf, in the JAX package's layout (a chunk's name from its
leaf's index and offset), when it is the slice's writer (the JAX
package's replica_id == 0: a tp slice is written by the ranks at fsdp,
dp and sp coordinate 0), and its ``index.{rank}.json``; rank 0 writes
the whole leaves. Restoring into such a state reads only the regions the
rank holds (``bridge.flax_to_state_sharded`` over ``read_region``), from
disk or, through ``restore_from_index``, from donors.

``restore_from_index`` is the same assembly with the chunk source
abstracted (``load(fname) -> ndarray``): the state-migration plane
(``collective/migration.py``) drives it with a loader that fetches chunks
from donors' memory, so a peer restore assembles exactly what a disk
restore of the same chunks does. ``snapshot_nbytes`` is what a donor
advertises: its chunks' bytes as stored.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from edl_tpu_torch.train import ckpt_io
from edl_tpu_torch.train.ckpt_io import is_sharded_dir  # noqa: F401
from edl_tpu_torch.utils import config

_KEY_PART = re.compile(r"\.([A-Za-z_]\w*)|\['([^']*)'\]|\[\"([^\"]*)\"\]"
                       r"|\[(\d+)\]")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def keyed_leaves(tree, prefix: str = "", shard=None
                 ) -> list[tuple[str, object]]:
    """(keystr, leaf) in jax's flatten order: NamedTuple fields in order
    (``.name``), dict keys sorted (``['k']``), tuple items (``[i]``);
    None has no leaf. Instances of ``shard`` are leaves."""
    if tree is None:
        return []
    if shard is not None and isinstance(tree, shard):
        return [(prefix, tree)]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in keyed_leaves(getattr(tree, f), f"{prefix}.{f}",
                                       shard)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in keyed_leaves(tree[k], f"{prefix}[{k!r}]", shard)]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in keyed_leaves(v, f"{prefix}[{i}]", shard)]
    return [(prefix, tree)]


def key_path(key: str) -> tuple[str, ...]:
    """A keystr as the state dict's path of str keys."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            raise ValueError(f"cannot parse checkpoint leaf key {key!r}")
        parts.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"cannot parse checkpoint leaf key {key!r}")
    return tuple(parts)


def snapshot_host_tree(tree) -> dict:
    """The leaf table and whole-array chunks of a host tree, process 0's.
    Each chunk's crc32 is recorded here, not only when it is written, so
    a donor serving this view hands peers the checksums to verify."""
    chunks, table = [], []
    for i, (key, leaf) in enumerate(keyed_leaves(tree)):
        arr = np.asarray(leaf)
        offset = (0,) * arr.ndim
        fname = ckpt_io.chunk_name(i, offset)
        chunks.append((fname, arr))
        table.append({"key": key, "shape": list(arr.shape),
                      "dtype": str(arr.dtype),
                      "chunks": [{"offset": list(offset),
                                  "shape": list(arr.shape), "file": fname,
                                  "crc32": ckpt_io.chunk_crc32(arr)}]})
    return {"leaves": table, "chunks": chunks, "process_index": 0}


def snapshot_nbytes(snap: dict) -> int:
    """Total payload bytes of a snapshot's chunks, as stored: what a donor
    advert quotes and a full peer restore moves over the wire. Takes the
    ``snapshot_host_tree`` list of ``(fname, array)`` pairs and the
    ``sealed_snapshot`` fname -> array dict alike."""
    chunks = snap["chunks"]
    arrays = chunks.values() if isinstance(chunks, dict) else (
        a for _, a in chunks)
    return int(sum(a.nbytes for a in arrays))


def snapshot_shard_tree(tree, process_index: int) -> dict:
    """The leaf table and this rank's chunks of a tree whose sharded
    leaves are ``bridge.Shard``s: a Shard its owner writes (the JAX
    package's replica_id == 0) is this rank's chunk at its offset; a
    whole leaf is rank 0's single chunk (the others list a leaf they do
    not write with no chunks, as the JAX package's non-owners do)."""
    from edl_tpu_torch.bridge import Shard

    chunks, table = [], []
    for i, (key, leaf) in enumerate(keyed_leaves(tree, shard=Shard)):
        if isinstance(leaf, Shard):
            arr, offset, shape = (np.asarray(leaf.array), tuple(leaf.offset),
                                  tuple(leaf.shape))
            mine = leaf.owner
        else:
            arr = np.asarray(leaf)
            offset, shape = (0,) * arr.ndim, tuple(arr.shape)
            mine = process_index == 0
        entry = {"key": key, "shape": list(shape), "dtype": str(arr.dtype),
                 "chunks": []}
        if mine:
            fname = ckpt_io.chunk_name(i, offset)
            chunks.append((fname, arr))
            entry["chunks"].append({"offset": list(offset),
                                    "shape": list(arr.shape),
                                    "file": fname})
        table.append(entry)
    return {"leaves": table, "chunks": chunks,
            "process_index": process_index}


def entry_reader(merged: dict[str, dict], load):
    """``read(path, index)`` over a merged leaf table: the region
    ``index`` (None: whole) of the leaf at ``path`` (the state dict's
    path), assembled from chunks through ``load``."""
    by_path = {key_path(k): e for k, e in merged.items()}

    def read(path, index):
        entry = by_path.get(tuple(path))
        if entry is None:
            raise ValueError(f"checkpoint has no leaf {'/'.join(path)}")
        if index is None:
            index = tuple(slice(0, n) for n in entry["shape"])
        out = ckpt_io.read_region(load, entry, index)
        return out if out.ndim else out[()]

    return read


def save_tree(directory: str, tree) -> list[str]:
    """Write ``tree`` as process 0's chunks + index; returns the files."""
    return ckpt_io.write_snapshot(directory, snapshot_host_tree(tree))


def restore_threads() -> int:
    configured = config.env_int("EDL_TPU_CKPT_RESTORE_THREADS", 0)
    if configured > 0:
        return configured
    return min(8, 2 * (os.cpu_count() or 1))


def restore_state_dict(directory: str, threads: int | None = None) -> dict:
    """Every leaf of a sharded checkpoint, assembled whole from whatever
    chunks cover it, as a nested state dict keyed by the leaves' paths."""
    merged = ckpt_io.read_merged_index(directory)
    files = ckpt_io.ChunkFiles(directory,
                               crcs=ckpt_io.checksum_map(merged))
    try:
        return tree_from_index(merged, files.load, threads)
    finally:
        files.close()


def restore_from_index(merged: dict[str, dict], load, target,
                       threads: int | None = None):
    """Assemble every leaf of ``merged`` (a merged leaf table) through
    ``load(fname) -> ndarray`` and write the tree into ``target``, a
    TrainState, in place (``bridge.flax_to_state``); returns it. Nothing
    is written until every chunk has arrived, so a source that fails
    part way leaves ``target`` as it was. An FSDP target reads only the
    regions this rank holds (``bridge.flax_to_state_sharded``), written
    as they arrive."""
    from edl_tpu_torch import bridge
    from edl_tpu_torch.parallel.sharding import is_sharded

    if is_sharded(target.model):
        return bridge.flax_to_state_sharded(entry_reader(merged, load),
                                            target)
    tree = tree_from_index(merged, load, threads)

    bridge.flax_to_state(tree, target)
    return target


def tree_from_index(merged: dict[str, dict], load,
                    threads: int | None = None) -> dict:
    """Every leaf of ``merged`` assembled whole (a coverage hole raises)
    from chunks read through ``load``, on ``threads`` readers, as a
    nested state dict keyed by the leaves' paths."""
    threads = restore_threads() if threads is None else threads

    def read(item):
        key, entry = item
        full = tuple(slice(0, s) for s in entry["shape"])
        return key, ckpt_io.read_region(load, entry, full)

    if threads > 1 and len(merged) > 1:
        with ThreadPoolExecutor(max_workers=threads,
                                thread_name_prefix="edl-ckpt-read") as ex:
            arrays = list(ex.map(read, merged.items()))
    else:
        arrays = [read(item) for item in merged.items()]
    out: dict = {}
    for key, arr in arrays:
        node = out
        *path, leaf = key_path(key)
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return out
