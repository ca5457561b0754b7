"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into
``ops/_build/lib<name>-<digest>.so`` (a directory git ignores); the
digest covers the source, the shared headers ``csrc/*.cuh`` and the
source's own flags (``flags(name)``: the common ones plus
``SOURCE_FLAGS[name]``), so an edited source, header or flag never
loads a stale library. No PyTorch headers are included, so a build takes
seconds. A failed build raises: there is no fallback to a plain version.

``scratch_words`` holds the device words the table kernels fold their
abs-maxes and counts into (K6, K7, K8), one array per (device, stream).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source on top of NVCC_FLAGS. The fused optimizer updates
# and the int8 pack are held bit for bit against their plain PyTorch
# versions: no contraction into fma, IEEE division and square root, no
# flush to zero.
_BITWISE = ("-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false")
SOURCE_FLAGS: dict[str, tuple[str, ...]] = {
    "adam_fp32": _BITWISE,
    "sgdm": _BITWISE,
    "adam_q": _BITWISE,
    "pack": _BITWISE,
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}   # guarded-by: _lock
_words: dict[tuple, torch.Tensor] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "CUDA kernels are built from source at first use")
    return found


def flags(name: str) -> tuple[str, ...]:
    """nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a reader never sees a partial .so
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> dict[str, dict]:
    """Compile every source of ``csrc/`` with one nvcc each, all started
    together. Returns ``{name: {"seconds", "log"}}``; raises after every
    nvcc has ended if any failed."""
    t0 = time.monotonic()
    started = {p.stem: _start(p.stem) for p in sorted(CSRC.glob("*.cu"))}
    results, errors = {}, []
    for n, (proc, tmp, out) in started.items():
        try:
            log = _finish(n, proc, tmp, out)
        except RuntimeError as exc:
            errors.append(str(exc))
            continue
        results[n] = {"seconds": time.monotonic() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _finish(name, *_start(name))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def scratch_words(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 words on ``device`` for the kernels' scratch,
    one array per (device, current stream): launches on one stream run in
    order, so every call on it reuses the array. Grown to the largest
    call seen, never shrunk; each kernel call zeroes the words it uses."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    words = _words.get(key)
    if words is None or words.numel() < n:
        words = _words[key] = torch.empty(
            max(n, 0 if words is None else words.numel()), dtype=torch.int32,
            device=device)
    return words
