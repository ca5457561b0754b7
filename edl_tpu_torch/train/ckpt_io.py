"""Checkpoint chunk I/O: the numpy-only half of the sharded format (copy
of ``edl_tpu.train.ckpt_io``).

A sharded checkpoint directory holds one ``.npy`` file a chunk
(``leaf{i}-o{offset}.npy``) and an index per writing process
(``index.{process}.json``: each leaf's key, shape, dtype and chunk table).
Every chunk written by ``write_snapshot`` records a crc32 of its raw bytes
in the chunk table; ``ChunkFiles`` verifies it once on first load and
raises the typed ``EdlCheckpointCorrupt`` on a mismatch, so a truncated
or bit-flipped chunk becomes a recoverable error, never a garbage
restore. ``EDL_TPU_CKPT_VERIFY=0`` turns the check off. Tables without
``crc32`` keys skip it chunk by chunk. The format is the JAX package's,
byte for byte.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import zlib

import numpy as np

from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.exceptions import EdlCheckpointCorrupt

_INDEX_RE = re.compile(r"^index\.(\d+)\.json$")


def chunk_name(leaf_i: int, offset: tuple[int, ...]) -> str:
    tag = "_".join(str(o) for o in offset) if offset else "scalar"
    return f"leaf{leaf_i}-o{tag}.npy"


def slices_to_offset_shape(index: tuple, shape: tuple[int, ...]
                           ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    offset, size = [], []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        offset.append(start)
        size.append(stop - start)
    return tuple(offset), tuple(size)


def chunk_crc32(arr: np.ndarray) -> int:
    """crc32 of the array's raw bytes (C order). This is the seal-time
    fingerprint recorded in the chunk table and re-computed on every
    load path — disk mmap and peer wire alike — so the same number
    guards both."""
    arr = np.ascontiguousarray(arr)
    return zlib.crc32(memoryview(arr).cast("B")) & 0xFFFFFFFF


def verify_enabled() -> bool:
    """Integrity verification on restore (EDL_TPU_CKPT_VERIFY; default
    on). The off switch exists for corruption drills and for measuring
    the verify cost, not for production."""
    return config.env_flag("EDL_TPU_CKPT_VERIFY", True)


def write_snapshot(directory: str, snap: dict) -> list[str]:
    """Write a snapshot dict (``{"leaves": table, "chunks": [(file,
    array)], "process_index": i}``) into ``directory``.

    Safe on a background thread (pure numpy + file I/O). Records each
    chunk's crc32 into the leaf table in place before writing the index.
    Returns the basenames this process wrote (chunks + its index file),
    index last so its presence implies the chunks made it.
    """
    os.makedirs(directory, exist_ok=True)
    written: list[str] = []
    crcs: dict[str, int] = {}
    for fname, arr in snap["chunks"]:
        np.save(os.path.join(directory, fname), arr)
        crcs[fname] = chunk_crc32(arr)
        written.append(fname)
    for leaf in snap["leaves"]:
        for chunk in leaf["chunks"]:
            crc = crcs.get(chunk["file"])
            if crc is not None:
                chunk["crc32"] = crc
    index_name = f"index.{snap['process_index']}.json"
    with open(os.path.join(directory, index_name), "w") as f:
        json.dump({"leaves": snap["leaves"]}, f)
    written.append(index_name)
    return written


def merge_leaf_tables(tables: list[list[dict]]) -> dict[str, dict]:
    """key -> {shape, dtype, chunks[]} merged across per-process leaf
    tables (the `leaves` list of each index file)."""
    merged: dict[str, dict] = {}
    for leaves in tables:
        for leaf in leaves:
            entry = merged.setdefault(
                leaf["key"], {"shape": leaf["shape"], "dtype": leaf["dtype"],
                              "chunks": []})
            if entry["shape"] != leaf["shape"]:
                raise ValueError(
                    f"shape mismatch across leaf tables for {leaf['key']}")
            entry["chunks"].extend(leaf["chunks"])
    return merged


def read_merged_index(directory: str) -> dict[str, dict]:
    """key -> {shape, dtype, chunks[]} merged across all process indexes."""
    paths = glob.glob(os.path.join(directory, "index.*.json"))
    if not paths:
        raise FileNotFoundError(f"no index.*.json under {directory}")
    tables = []
    for p in sorted(paths):
        with open(p) as f:
            tables.append(json.load(f)["leaves"])
    return merge_leaf_tables(tables)


def checksum_map(merged: dict[str, dict]) -> dict[str, int]:
    """chunk file -> expected crc32 from a merged leaf table (chunks
    from pre-integrity checkpoints are absent: no crc, no check)."""
    out: dict[str, int] = {}
    for entry in merged.values():
        for chunk in entry["chunks"]:
            crc = chunk.get("crc32")
            if crc is not None:
                out[chunk["file"]] = int(crc)
    return out


class ChunkFiles:
    """Per-restore cache of memory-mapped chunk files.

    A resharding restore reads the same chunk for every target region it
    intersects; re-running np.load per region paid a file open + header
    parse each time. One handle per file, shared across regions (and
    across reader threads — numpy memmap reads are thread-safe).

    With ``crcs`` set (the merged index's checksum_map), each file is
    verified ONCE on first load — a full read of the chunk, which the
    intersecting regions were about to page in anyway — and a mismatch
    or an unloadable file raises ``EdlCheckpointCorrupt`` naming the
    chunk, so the caller can fall back instead of assembling garbage."""

    def __init__(self, directory: str, crcs: dict[str, int] | None = None,
                 verify: bool | None = None):
        self.directory = directory
        self._crcs = crcs or {}
        self._verify = verify_enabled() if verify is None else verify
        self._handles: dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    def load(self, fname: str) -> np.ndarray:
        with self._lock:
            h = self._handles.get(fname)
            if h is None:
                path = os.path.join(self.directory, fname)
                try:
                    h = np.load(path, mmap_mode="r")
                except (OSError, ValueError, EOFError) as exc:
                    raise EdlCheckpointCorrupt(
                        f"chunk {fname} unreadable under {self.directory}:"
                        f" {exc}") from exc
                expect = self._crcs.get(fname)
                if self._verify and expect is not None:
                    got = chunk_crc32(np.asarray(h))
                    if got != expect:
                        raise EdlCheckpointCorrupt(
                            f"chunk {fname} failed integrity check "
                            f"(crc32 {got:#010x} != sealed "
                            f"{expect:#010x}) under {self.directory}")
                self._handles[fname] = h
            return h

    def close(self) -> None:
        self._handles.clear()  # memmaps close when the views are collected


def read_region(load, entry: dict, index: tuple) -> np.ndarray:
    """Assemble the region `index` (tuple of slices) from saved chunks.

    ``load(fname) -> ndarray`` is the chunk source (a `ChunkFiles`
    mmap cache for on-disk checkpoints)."""
    shape = tuple(entry["shape"])
    offset, size = slices_to_offset_shape(index, shape)
    out = np.empty(size, dtype=np.dtype(entry["dtype"]))
    # Coverage mask (not an element count): overlapping chunks — e.g. a
    # half-written dir mixing two world shapes — must not mask a hole.
    covered = np.zeros(size, dtype=bool)
    for chunk in entry["chunks"]:
        coff, cshape = chunk["offset"], chunk["shape"]
        lo = [max(o, co) for o, co in zip(offset, coff)]
        hi = [min(o + s, co + cs)
              for o, s, co, cs in zip(offset, size, coff, cshape)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = load(chunk["file"])
        src_sel = tuple(slice(a - co, b - co)
                        for a, b, co in zip(lo, hi, coff))
        dst_sel = tuple(slice(a - o, b - o)
                        for a, b, o in zip(lo, hi, offset))
        out[dst_sel] = src[src_sel]
        covered[dst_sel] = True
    if not covered.all():
        missing = int(covered.size - np.count_nonzero(covered))
        raise ValueError(
            f"chunks leave {missing}/{covered.size} elements of region "
            f"{offset}+{size} unwritten — checkpoint incomplete for this "
            f"resharding")
    return out


def is_sharded_dir(directory: str) -> bool:
    try:
        return any(_INDEX_RE.match(n) for n in os.listdir(directory))
    except FileNotFoundError:
        return False
