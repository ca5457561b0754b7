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
writes either into the live state. Restoring into sharded tensors waits
for FSDP (ROADMAP Queue 1 item 10).
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


def keyed_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(keystr, leaf) in jax's flatten order: NamedTuple fields in order
    (``.name``), dict keys sorted (``['k']``), tuple items (``[i]``);
    None has no leaf."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in keyed_leaves(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in keyed_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in keyed_leaves(v, f"{prefix}[{i}]")]
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
    """The leaf table and whole-array chunks of a host tree, process 0's
    (``write`` records each chunk's crc32)."""
    chunks, table = [], []
    for i, (key, leaf) in enumerate(keyed_leaves(tree)):
        arr = np.asarray(leaf)
        offset = (0,) * arr.ndim
        fname = ckpt_io.chunk_name(i, offset)
        chunks.append((fname, arr))
        table.append({"key": key, "shape": list(arr.shape),
                      "dtype": str(arr.dtype),
                      "chunks": [{"offset": list(offset),
                                  "shape": list(arr.shape), "file": fname}]})
    return {"leaves": table, "chunks": chunks, "process_index": 0}


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
    threads = restore_threads() if threads is None else threads

    def read(item):
        key, entry = item
        full = tuple(slice(0, s) for s in entry["shape"])
        return key, ckpt_io.read_region(files.load, entry, full)

    try:
        if threads > 1 and len(merged) > 1:
            with ThreadPoolExecutor(max_workers=threads,
                                    thread_name_prefix="edl-ckpt-read") as ex:
                arrays = list(ex.map(read, merged.items()))
        else:
            arrays = [read(item) for item in merged.items()]
    finally:
        files.close()
    out: dict = {}
    for key, arr in arrays:
        node = out
        *path, leaf = key_path(key)
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return out
