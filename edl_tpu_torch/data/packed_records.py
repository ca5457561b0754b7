"""Packed pre-decoded record format (port of
``edl_tpu.data.packed_records``; the file format is byte for byte the
JAX package's, so each package reads the other's files).

A packed record file removes the input plane's host work instead of
parallelizing it:

- **decode once, offline**: the `pack` CLI eats any random-access source
  (a `JpegFileListSource` with a deterministic decode/resize, or `.npz`
  shards) and writes every sample PRE-DECODED at a fixed stride, so the
  train-time host never touches cv2 again;
- **O(1) mmap random access**: fields live as contiguous `(n, *shape)`
  tables at fixed offsets, read through an `np.memmap`, so a shuffled
  epoch touches only the pages it reads (no shard LRU);
- **one gather per batch**: `PackedSource.batch(idx)` is a single
  `np.take` per field into a freshly-owned contiguous buffer;
- **augmentation moves on-device** (`ops/augment.py`): the loader ships
  raw bytes + the parent-drawn per-step seed, and crop/flip/normalize
  run on the card on the staging thread's stream.

`PackedSource` implements the loader's `__len__` + `batch(idx)` source
contract, so it flows through `materialize_batch`, the decode-thread
pool and the shm-ring mp path unchanged.

File layout (all little-endian, offsets 64-aligned):

    [0:8)      magic  b"EDLPACK1"
    [8:12)     uint32 header_len (JSON bytes; header block is 4 KiB)
    [12:12+L)  JSON header:
               {"version": 1, "n": <rows>,
                "fields": {key: {"shape": [...per-sample tail...],
                                 "dtype": "<numpy dtype str>",
                                 "offset": <bytes>}, ...}}
    [4096:...) field tables, each a contiguous (n, *shape) array

CLI:

    python -m edl_tpu_torch.data.packed_records pack --out train.pack \
        --jpeg-list train.txt --root data/ --size 224      # or
    python -m edl_tpu_torch.data.packed_records pack --out train.pack \
        --npz-dir shards/                                  # or --npz f.npz
    python -m edl_tpu_torch.data.packed_records info train.pack
    python -m edl_tpu_torch.data.packed_records selftest
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Sequence

import numpy as np

from edl_tpu_torch.utils.exceptions import EdlDataError

MAGIC = b"EDLPACK1"
_VERSION = 1
# Fixed header block: the JSON must fit under it so field offsets are
# independent of header growth (and page-aligned for the mmap).
HEADER_BLOCK = 4096
_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class PackedWriter:
    """Streaming writer for one packed record file.

    Row count and per-field (shape tail, dtype) are declared up front
    (every supported source knows its length), so field offsets are
    fixed before the first row lands and `add()` can interleave writes
    to each field's table.
    """

    def __init__(self, path: str,
                 n: int, fields: dict[str, tuple[tuple[int, ...], np.dtype]]):
        if n <= 0:
            raise EdlDataError(f"packed file needs n > 0 rows, got {n}")
        if not fields:
            raise EdlDataError("packed file needs at least one field")
        self.path = path
        self.n = n
        self._rows = 0
        self._fields: dict[str, dict] = {}
        off = HEADER_BLOCK
        for key in sorted(fields):
            shape, dtype = fields[key]
            dtype = np.dtype(dtype)
            row_bytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self._fields[key] = {"shape": tuple(int(s) for s in shape),
                                 "dtype": dtype, "offset": off,
                                 "row_bytes": row_bytes}
            off = _align(off + n * row_bytes)
        header = {"version": _VERSION, "n": n,
                  "fields": {k: {"shape": list(f["shape"]),
                                 "dtype": f["dtype"].str,
                                 "offset": f["offset"]}
                             for k, f in self._fields.items()}}
        blob = json.dumps(header).encode()
        if len(blob) > HEADER_BLOCK - 12:
            raise EdlDataError(
                f"packed header {len(blob)}B exceeds the {HEADER_BLOCK}B "
                "header block (too many / too-long field keys)")
        self._f = open(path, "wb")
        try:
            self._f.write(MAGIC)
            self._f.write(np.uint32(len(blob)).tobytes())
            self._f.write(blob)
        except BaseException:
            self._f.close()
            raise

    def add(self, batch: dict[str, np.ndarray]) -> None:
        """Append `len(batch[k])` rows (every declared field required)."""
        sizes = {k: len(np.asarray(v)) for k, v in batch.items()}
        if set(sizes) != set(self._fields) or len(set(sizes.values())) != 1:
            raise EdlDataError(
                f"batch fields {sizes} do not match declared "
                f"{list(self._fields)}")
        rows = next(iter(sizes.values()))
        if self._rows + rows > self.n:
            raise EdlDataError(
                f"packed overflow: {self._rows}+{rows} rows > declared "
                f"{self.n}")
        for key, f in self._fields.items():
            arr = np.ascontiguousarray(batch[key], dtype=f["dtype"])
            if arr.shape[1:] != f["shape"]:
                raise EdlDataError(
                    f"field {key!r}: sample shape {arr.shape[1:]} != "
                    f"declared {f['shape']} (packed records are "
                    "fixed-stride — resize/crop to one shape when packing)")
            self._f.seek(f["offset"] + self._rows * f["row_bytes"])
            self._f.write(arr.tobytes())
        self._rows += rows

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            if self._rows != self.n:
                raise EdlDataError(
                    f"packed file closed at {self._rows}/{self.n} rows")
            # materialize the full extent so a reader's size check holds
            # (alignment gaps between field tables are holes; the last
            # field's final add already wrote the true end)
            end = max(f["offset"] + self.n * f["row_bytes"]
                      for f in self._fields.values())
            self._f.truncate(end)
        finally:
            self._f.close()

    def __enter__(self) -> "PackedWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:  # abort: leave no half-valid file behind
            self._f.close()
            try:
                os.unlink(self.path)
            except OSError:
                pass
            return
        self.close()


def read_header(path: str) -> dict:
    """Parse + validate a packed file's header; raises EdlDataError with
    a specific reason for anything short of a well-formed file (a
    truncated or corrupt file must never be read as garbage batches)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:8] != MAGIC:
                raise EdlDataError(
                    f"{path}: not a packed records file (bad magic; "
                    "expected EDLPACK1)")
            hlen = int(np.frombuffer(head[8:12], np.uint32)[0])
            if not 0 < hlen <= HEADER_BLOCK - 12:
                raise EdlDataError(
                    f"{path}: corrupt packed header (length {hlen})")
            blob = f.read(hlen)
        if len(blob) != hlen:
            raise EdlDataError(f"{path}: truncated packed header")
        header = json.loads(blob)
    except EdlDataError:
        raise
    except (OSError, ValueError, UnicodeDecodeError) as exc:
        raise EdlDataError(f"{path}: corrupt packed header ({exc})") from exc
    if header.get("version") != _VERSION:
        raise EdlDataError(
            f"{path}: unsupported packed version {header.get('version')}")
    n = header.get("n")
    fields = header.get("fields")
    if not isinstance(n, int) or n <= 0 or not isinstance(fields, dict) \
            or not fields:
        raise EdlDataError(f"{path}: corrupt packed header (n/fields)")
    end = 0
    for key, f in fields.items():
        try:
            shape = tuple(int(s) for s in f["shape"])
            dtype = np.dtype(f["dtype"])
            off = int(f["offset"])
        except (KeyError, TypeError, ValueError) as exc:
            raise EdlDataError(
                f"{path}: corrupt packed field {key!r} ({exc})") from exc
        if off < HEADER_BLOCK or any(s <= 0 for s in shape):
            raise EdlDataError(
                f"{path}: corrupt packed field {key!r} (offset/shape)")
        row = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        end = max(end, off + n * row)
    if size < end:
        raise EdlDataError(
            f"{path}: truncated packed file ({size}B < expected {end}B) — "
            "repack; refusing to serve garbage batches")
    return header


class PackedSource:
    """Random-access source over one packed record file.

    Implements the loader source contract (`__len__` + `batch(idx) ->
    dict`), so it drops into `DataLoader` in every execution mode.
    Construction maps the field tables (`np.memmap` — reads only the
    header; sample pages fault in lazily on access) and `batch` is one
    `np.take` gather per field into a contiguous owned buffer: the host
    cost of a batch is a memcpy of exactly the requested rows.
    """

    def __init__(self, path: str):
        header = read_header(path)
        self.path = path
        self._n = header["n"]
        self._maps: dict[str, np.memmap] = {}
        for key in sorted(header["fields"]):
            f = header["fields"][key]
            self._maps[key] = np.memmap(
                path, dtype=np.dtype(f["dtype"]), mode="r",
                offset=int(f["offset"]),
                shape=(self._n,) + tuple(int(s) for s in f["shape"]))

    def __len__(self) -> int:
        return self._n

    @property
    def fields(self) -> dict[str, tuple[tuple[int, ...], np.dtype]]:
        return {k: (m.shape[1:], m.dtype) for k, m in self._maps.items()}

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        idx = np.asarray(idx, dtype=np.intp)
        out = {}
        for key, mm in self._maps.items():
            buf = np.empty((len(idx),) + mm.shape[1:], mm.dtype)
            # one C-level gather per field, straight off the mapping —
            # no per-sample Python loop, no re-collation, and `buf`
            # owns its memory (prefetch_to_device places it copy-free)
            np.take(mm, idx, axis=0, out=buf)
            out[key] = buf
        return out


# -- packing ----------------------------------------------------------------

def pack_source(source, out_path: str, *, batch_size: int = 256,
                sample_transform: Callable | None = None,
                log: Callable[[str], None] | None = None) -> dict:
    """Pack any random-access source into `out_path`.

    Without `sample_transform` the source's `batch(idx)` dicts are
    written as-is (the npz path — dtypes/shapes preserved).  With it,
    `source.samples(idx)` records are mapped through the transform
    (e.g. `eval_image_transform`: decode + resize-short + center-crop
    to ONE fixed shape) and collated — the pack step runs the decode
    exactly once so train time never does.
    """
    n = len(source)
    if n == 0:
        raise EdlDataError("cannot pack an empty source")

    def get_batch(lo: int, hi: int) -> dict[str, np.ndarray]:
        idx = np.arange(lo, hi)
        if sample_transform is None:
            return source.batch(idx)
        done = [sample_transform(s, None) for s in source.samples(idx)]
        return {k: np.stack([d[k] for d in done]) for k in done[0]}

    first = get_batch(0, min(batch_size, n))
    fields = {k: (np.asarray(v).shape[1:], np.asarray(v).dtype)
              for k, v in first.items()}
    with PackedWriter(out_path, n, fields) as w:
        w.add(first)
        for lo in range(batch_size, n, batch_size):
            w.add(get_batch(lo, min(lo + batch_size, n)))
            if log is not None:
                log(f"packed {min(lo + batch_size, n)}/{n} rows")
    return {"n": n,
            "fields": {k: (list(s), d.str) for k, (s, d) in fields.items()},
            "bytes": os.path.getsize(out_path)}


def pack_jpeg_list(list_file: str, root: str, out_path: str, *,
                   size: int = 224, short: int | None = None,
                   batch_size: int = 256,
                   log: Callable[[str], None] | None = None) -> dict:
    """Pack a `<path> <label>` JPEG file list: deterministic decode +
    resize-short + center-crop to (size, size, 3) uint8 — train-time
    augmentation (random crop/flip) moves ON DEVICE (`ops/augment.py`),
    so the pack step bakes only the deterministic geometry."""
    from edl_tpu_torch.data.image import JpegFileListSource, eval_image_transform
    src = JpegFileListSource(list_file, root=root)
    t = eval_image_transform(size, short=short or size * 8 // 7)
    return pack_source(src, out_path, batch_size=batch_size,
                       sample_transform=t, log=log)


def pack_npz(files: Sequence[str], out_path: str, *,
             batch_size: int = 256,
             log: Callable[[str], None] | None = None) -> dict:
    """Pack .npz shard files (FileSource order, dtypes preserved)."""
    from edl_tpu_torch.data.pipeline import FileSource
    return pack_source(FileSource(files), out_path, batch_size=batch_size,
                       log=log)


# -- CLI --------------------------------------------------------------------

def _selftest() -> int:
    """Smoke: pack a tiny synthetic dataset, prove round-trip byte
    equality, mode-invariant streams (inline vs mp) with emitted device
    seeds, and corrupt-file rejection. numpy-only (no torch, no cv2), so
    it runs anywhere the loader does."""
    import shutil
    import tempfile

    from edl_tpu_torch.data.pipeline import DataLoader

    d = tempfile.mkdtemp(prefix="edl-pack-selftest-")
    try:
        rng = np.random.default_rng(0)
        files = []
        for i in range(2):
            path = os.path.join(d, f"train-{i}.npz")
            np.savez(path,
                     image=rng.integers(0, 256, size=(24, 8, 8, 3),
                                        dtype=np.uint8),
                     label=rng.integers(0, 10, size=24).astype(np.int32))
            files.append(path)
        out = os.path.join(d, "train.pack")
        info = pack_npz(files, out, batch_size=7)
        src = PackedSource(out)
        from edl_tpu_torch.data.pipeline import FileSource
        ref = FileSource(files)
        idx = np.arange(len(src))
        got, want = src.batch(idx), ref.batch(idx)
        for k in want:
            if not np.array_equal(got[k], want[k]):
                print(f"FAIL round-trip field {k}")
                return 1
        print(f"PASS pack round-trip ({info['n']} rows, "
              f"{info['bytes']}B)")
        with DataLoader(src, 8, seed=3, emit_batch_seed=True) as inline:
            a = [{k: np.array(v) for k, v in b.items()}
                 for b in inline.epoch(1)]
        with DataLoader(src, 8, seed=3, emit_batch_seed=True,
                        num_workers=1) as mp:
            b = [{k: np.array(v) for k, v in bb.items()}
                 for bb in mp.epoch(1)]
        for x, y in zip(a, b):
            for k in x:
                if not np.array_equal(x[k], y[k]):
                    print(f"FAIL mode invariance field {k}")
                    return 1
        if "augment_seed" not in a[0]:
            print("FAIL emitted seed missing")
            return 1
        print(f"PASS mode-invariant stream ({len(a)} batches, seeds "
              "emitted)")
        bad = os.path.join(d, "bad.pack")
        with open(out, "rb") as f, open(bad, "wb") as g:
            g.write(f.read(HEADER_BLOCK + 100))  # truncate the tables
        try:
            PackedSource(bad)
        except EdlDataError as exc:
            print(f"PASS truncated file rejected ({exc})")
        else:
            print("FAIL truncated file accepted")
            return 1
        return 0
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.data.packed_records")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pack", help="pack a jpeg list / npz shards")
    p.add_argument("--out", required=True)
    p.add_argument("--jpeg-list", help="'<path> <label>' file list")
    p.add_argument("--root", default="", help="jpeg path root")
    p.add_argument("--size", type=int, default=224,
                   help="packed image side (decode + resize-short + "
                        "center-crop)")
    p.add_argument("--short", type=int, default=None,
                   help="resize-short target before the crop "
                        "(default size*8/7)")
    p.add_argument("--npz-dir", help="directory of train-*.npz shards")
    p.add_argument("--npz", nargs="+", help="explicit npz shard files")
    p.add_argument("--batch", type=int, default=256)
    i = sub.add_parser("info", help="print a packed file's header")
    i.add_argument("path")
    sub.add_parser("selftest", help="pack+read smoke on synthetic data")
    args = parser.parse_args(argv)

    if args.cmd == "selftest":
        return _selftest()
    if args.cmd == "info":
        header = read_header(args.path)
        header["bytes"] = os.path.getsize(args.path)
        print(json.dumps(header, indent=2))
        return 0
    chosen = [x for x in (args.jpeg_list, args.npz_dir, args.npz) if x]
    if len(chosen) != 1:
        parser.error("pack needs exactly one of --jpeg-list / --npz-dir "
                     "/ --npz")
    if args.jpeg_list:
        info = pack_jpeg_list(args.jpeg_list, args.root, args.out,
                              size=args.size, short=args.short,
                              batch_size=args.batch, log=print)
    else:
        files = args.npz or sorted(
            os.path.join(args.npz_dir, f)
            for f in os.listdir(args.npz_dir)
            if f.startswith("train-") and f.endswith(".npz"))
        if not files:
            parser.error(f"no train-*.npz shards under {args.npz_dir}")
        info = pack_npz(files, args.out, batch_size=args.batch, log=print)
    print(json.dumps({"out": args.out, **info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
