"""Fused optimizer updates over flat parameter buckets (port of
``edl_tpu.ops.opt_kernels``).

A bucket is one flat fp32 buffer of several parameters, padded to a
multiple of 128 elements (``train/comm.plan_buckets(align=128)``); the
zero padding is a fixed point of both updates. ``_sgdm_math`` and
``_adam_math`` are the single source of the arithmetic, in the JAX
package's expression order; the bucket functions update ``p`` and the
moments IN PLACE (the JAX package returns new arrays) and return them.

Quantized resident moments (``quant='int8'``/``'fp8'``): between steps a
moment plane lives as a :class:`QPlane` — the symmetric quantization of
the moment (int8, or float8 e4m3 bits viewed as int8) and of its rounding
residual, each with one fp32 scale per bucket. The scales are 0-dim fp32
tensors on the bucket's device, rewritten in place, so a step never reads
them back to the host. Adam's second moment always rides the fp8 codec
(``V_QUANT``).

Dispatch is by the tensors' device, never by a fallback:

- a CPU tensor runs the plain version (``_sgdm_plain``/``_adam_plain``:
  the math above with ``_dq2``/``_rq2`` around it);
- a CUDA tensor launches the kernel or raises, each built at first use by
  ``ops/_build.py``: momentum-SGD runs K4 (``sgdm_fp32`` on one bucket,
  ``sgdm_fp32_buckets`` once over every bucket of a step;
  ``csrc/sgdm.cu``) or K6 (``sgdm_q`` on one bucket, ``sgdm_q_buckets``
  over every bucket of a step: a memset and three passes over a table of
  the buckets, no workspace; same file), Adam(W) runs K5 (``adam_fp32``
  on one bucket, ``adam_fp32_buckets`` in one launch over every bucket of
  a step; ``csrc/adam_fp32.cu``) or K7 (``adam_q`` on one bucket,
  ``adam_q_buckets`` over every bucket of a step, K6's scheme for two
  moments; ``csrc/adam_q.cu``). One bucket is the one-entry table. Each
  launcher counts its calls in ``.launches`` (``sgdm_q``, ``adam_q``: the
  calls of the C entry, each a whole K6 or K7).

The scalars lr, c1 = 1 - b1^t and c2 = 1 - b2^t are host floats. The
plain version makes them, and the codecs' constants, 0-dim fp32 tensors on
the bucket's device: a Python-float divisor would make a CUDA division a
multiplication by its reciprocal, one rounding away from the kernel's IEEE
division.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops.pack import (_const, dequantize_int8, quantize_int8,
                                    symmetric_scale)

_LANE = 128         # buckets are padded to a multiple of this

OPTIMIZERS = ("sgdm", "adam")
QUANT_MODES = ("off", "int8", "fp8")


# -- fp8 plane codec (rides the int8 wire) ----------------------------------

FP8_MAX = 448.0     # float8_e4m3fn finite max
_FP8 = torch.float8_e4m3fn


def _fp8_scale(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().max()
    return torch.where(amax > 0, amax / _const(FP8_MAX, x), _const(1.0, x))


def _quantize_fp8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x.float() / scale).to(_FP8).view(torch.int8)


def _dequantize_fp8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.view(_FP8).float() * scale.float()


# -- quantized moment plane --------------------------------------------------

# Adam's second moment always uses the fp8-e4m3 codec: v spans many
# orders of magnitude under a square root, where a linear int8 grid
# zero-floors small entries (the JAX package's reasoning, V_QUANT there).
V_QUANT = "fp8"


class QPlane(NamedTuple):
    """One moment plane at rest: value payload + error-feedback residual.

    q/rq are int8 (fp8 mode: float8 e4m3 bits viewed as int8); scale and
    rscale are 0-dim fp32 tensors on the plane's device, updated in place.
    """

    q: torch.Tensor
    scale: torch.Tensor
    rq: torch.Tensor
    rscale: torch.Tensor


def _dq2(q, scale, rq, rscale, quant: str) -> torch.Tensor:
    """Reassemble the full-precision moment: payload + residual."""
    if quant == "int8":
        return dequantize_int8(q, scale) + dequantize_int8(rq, rscale)
    return _dequantize_fp8(q, scale) + _dequantize_fp8(rq, rscale)


def _rq2(m: torch.Tensor, quant: str) -> tuple:
    """Requantize an updated moment; the rounding error becomes the new
    residual (itself quantized)."""
    if quant == "int8":
        scale = symmetric_scale(m)
        q = quantize_int8(m, scale)
        r = m - dequantize_int8(q, scale)
        rscale = symmetric_scale(r)
        rq = quantize_int8(r, rscale)
    else:
        scale = _fp8_scale(m)
        q = _quantize_fp8(m, scale)
        r = m - _dequantize_fp8(q, scale)
        rscale = _fp8_scale(r)
        rq = _quantize_fp8(r, rscale)
    return q, scale, rq, rscale


def quant_plane(m: torch.Tensor, quant: str) -> QPlane:
    """Full-precision moment -> resident QPlane."""
    return QPlane(*_rq2(m.float(), quant))


def dequant_plane(plane: QPlane, quant: str) -> torch.Tensor:
    """Resident QPlane -> full-precision moment (payload + residual)."""
    return _dq2(*plane, quant)


def zero_plane(n: int, quant: str,
               device: str | torch.device = "cpu") -> QPlane:
    """Quantized zero moment (exact: both codecs encode zero as q=0,
    scale=1)."""
    del quant
    return QPlane(q=torch.zeros(n, dtype=torch.int8, device=device),
                  scale=torch.ones((), dtype=torch.float32, device=device),
                  rq=torch.zeros(n, dtype=torch.int8, device=device),
                  rscale=torch.ones((), dtype=torch.float32, device=device))


def _store(plane: QPlane, new: tuple) -> None:
    for dst, src in zip(plane, new):
        dst.copy_(src)


# -- optimizer math (the single source of truth) ----------------------------
# Expression order matters: it is the JAX package's, so the plain version
# differs from JAX only where XLA contracts a multiply-add into an fma,
# and the CUDA kernels (no contraction) match the plain version bitwise.


def _sgdm_math(p, g, m, lr, mu: float, wd: float):
    if wd:
        g = g + wd * p
    m_new = g + mu * m
    p_new = p + m_new * (-lr)
    return p_new, m_new


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The fp32 square root of fp32 ``x``, correctly rounded on any device,
    as JAX's and the kernels' (__fsqrt_rn) are. torch's CPU roots are not:
    its vectorized fp32 root is an ulp off for some inputs, and its
    float64 root, usually within an ulp, comes on some first calls in a
    process from a path accurate to about 2^-34, which can flip an fp32
    rounding. So the float64 root rounded to fp32 is only a candidate r,
    moved to the neighbour that is the correct rounding: r is right when
    (r - ulp/2)^2 <= x < (r + ulp/2)^2, where the midpoints (25 bits) and
    their squares (50 bits) are exact in float64. No fp32 x has its root
    on a midpoint, so there are no ties."""
    r = torch.sqrt(x.double()).float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    xd, rd = x.double(), r.double()
    hi, lo = (rd + up.double()) * 0.5, (rd + down.double()) * 0.5
    r = torch.where(xd >= hi * hi, up, r)
    return torch.where(xd < lo * lo, down, r)


def _adam_math(p, g, m, v, lr, c1, c2, b1: float, b2: float,
               eps: float, wd: float):
    # v >= +0.0 exactly on the fp32 path, so the clamp is bitwise-neutral
    # there; it guards a dequantized v's negative residual error.
    v = torch.clamp_min(v, 0.0)
    m_new = (1 - b1) * g + b1 * m
    v_new = (1 - b2) * (g * g) + b2 * v
    u = (m_new / c1) / (_sqrt_rn(v_new / c2) + eps)
    if wd:
        u = u + wd * p
    p_new = p + u * (-lr)
    return p_new, m_new, v_new


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _sgdm_plain(p, g, m_state, lr: float, mu: float, wd: float,
                quant: str) -> None:
    """The plain version of one momentum-SGD bucket step, in place, on
    any device."""
    m = m_state if quant == "off" else _dq2(*m_state, quant)
    p_new, m_new = _sgdm_math(p, g, m, _scalar(lr, p), mu, wd)
    p.copy_(p_new)
    if quant == "off":
        m_state.copy_(m_new)
    else:
        _store(m_state, _rq2(m_new, quant))


def _adam_plain(p, g, m_state, v_state, lr: float, c1: float, c2: float,
                b1: float, b2: float, eps: float, wd: float,
                quant: str) -> None:
    """The plain version of one Adam(W) bucket step, in place, on any
    device."""
    if quant == "off":
        m, v = m_state, v_state
    else:
        m, v = _dq2(*m_state, quant), _dq2(*v_state, V_QUANT)
    p_new, m_new, v_new = _adam_math(
        p, g, m, v, _scalar(lr, p), _scalar(c1, p), _scalar(c2, p), b1, b2,
        eps, wd)
    p.copy_(p_new)
    if quant == "off":
        m_state.copy_(m_new)
        v_state.copy_(v_new)
    else:
        _store(m_state, _rq2(m_new, quant))
        _store(v_state, _rq2(v_new, V_QUANT))


# -- argument checks ---------------------------------------------------------


def _check_quant(quant: str) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")


def _check_q(name: str, quant: str) -> None:
    if quant not in ("int8", "fp8"):
        raise ValueError(f"{name} takes quant int8 or fp8, got {quant!r}")


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} needs contiguous 16-byte aligned buckets")


def _check_bucket(name: str, *bufs: torch.Tensor) -> None:
    p = bufs[0]
    for t in bufs:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes fp32 buckets, got {t.dtype}")
        if t.shape != p.shape or t.dim() != 1:
            raise ValueError(f"{name} takes flat buckets of one length, got "
                             + " ".join(str(tuple(b.shape)) for b in bufs))
        if t.device != p.device:
            raise ValueError(f"{name}: buckets on different devices")
        _check_aligned(name, t)
    if p.numel() % _LANE:
        raise ValueError(f"{name}: bucket length {p.numel()} is not a "
                         f"multiple of {_LANE}")


def _check_plane(name: str, p: torch.Tensor, plane) -> None:
    if not isinstance(plane, QPlane):
        raise TypeError(f"{name}: a quantized moment is a QPlane, got "
                        f"{type(plane).__name__}")
    for t in (plane.q, plane.rq):
        if t.dtype != torch.int8 or t.shape != p.shape:
            raise ValueError(f"{name}: QPlane payloads must be int8 of the "
                             f"bucket's shape {tuple(p.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        _check_aligned(name, t)
    for t in (plane.scale, plane.rscale):
        if t.dtype != torch.float32 or t.dim() != 0:
            raise ValueError(f"{name}: QPlane scales must be 0-dim fp32")
    if any(t.device != p.device for t in plane):
        raise ValueError(f"{name}: QPlane and bucket on different devices")


# -- the CUDA launchers ------------------------------------------------------

_P, _F, _I, _L = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, \
    ctypes.c_longlong
# C signature of each kernel library's entry point
_SIGNATURES = {
    "adam_fp32_buckets": ("edl_adam_fp32_buckets",
                          [_P, _P, _I] + [_F] * 9 + [_I, _P]),
    "sgdm": ("edl_sgdm_fp32", [_P] * 3 + [_L] + [_F] * 3 + [_I, _P]),
    "sgdm_buckets": ("edl_sgdm_fp32_buckets",
                     [_P] * 4 + [_I] + [_F] * 3 + [_I, _P]),
    "sgdm_q_buckets": ("edl_sgdm_q_buckets",
                       [_P, _P, _I, _P] + [_F] * 3 + [_I, _I, _P]),
    "sgdm_q_pass": ("edl_sgdm_q_pass",
                    [_P, _P, _I, _P, _I] + [_F] * 3 + [_I, _I, _P]),
    "adam_q_buckets": ("edl_adam_q_buckets",
                       [_P, _P, _I, _P] + [_F] * 9 + [_I, _I, _P]),
    "adam_q_pass": ("edl_adam_q_pass",
                    [_P, _P, _I, _P, _I] + [_F] * 9 + [_I, _I, _P]),
}
_SOURCE = {"adam_fp32_buckets": "adam_fp32", "sgdm": "sgdm",
           "sgdm_buckets": "sgdm", "sgdm_q_buckets": "sgdm",
           "sgdm_q_pass": "sgdm", "adam_q_buckets": "adam_q",
           "adam_q_pass": "adam_q"}
# Buckets one launch takes (MAX_BUCKETS of sgdm.cu, adam_fp32.cu and
# adam_q.cu): each table is passed by value as a kernel parameter, within
# 4 KB for K4 and K5; K6's 56 and K7's 88 bytes a bucket take CUDA 12.1's
# larger parameter space.
SGDM_TABLE_MAX = 96
SGDM_Q_TABLE_MAX = 96
ADAM_TABLE_MAX = 90
ADAM_Q_TABLE_MAX = 96
# Device words a bucket: K6's two abs-maxes and its last pass's count;
# K7's four abs-maxes and its count.
_SGDM_Q_WORDS = 3
_ADAM_Q_WORDS = 5


_entries: dict[str, tuple] = {}


def _entry(kind: str):
    """The C entry point of ``kind`` (its library built at first use) and
    the library's error-string function."""
    entry = _entries.get(kind)
    if entry is None:
        lib = _build.load(_SOURCE[kind])
        fn_name, argtypes = _SIGNATURES[kind]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
        entry = _entries[kind] = (fn, lib.edl_cuda_error_string)
    return entry


def _stream(device: torch.device) -> int:
    """The current stream of ``device`` (where a launch goes)."""
    return torch.cuda.current_stream(device).cuda_stream


def _launch(kind: str, name: str, device: torch.device, *args) -> None:
    fn, err_string = _entry(kind)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + err_string(err).decode())


def _launch_tables(kind: str, name: str, device: torch.device, limit: int,
                   rows: list[tuple], *args) -> int:
    """Launch the table entry ``kind`` once per ``limit`` buckets: rows[i]
    holds bucket i's tensors in its table's order (its first, p, gives the
    elements), passed as one flat array of pointers, then the sizes and
    the count, then ``args``. Returns the entry calls made."""
    calls = 0
    for i in range(0, len(rows), limit):
        part = rows[i:i + limit]
        ptrs = [t.data_ptr() for row in part for t in row]
        sizes = [row[0].numel() for row in part]
        _launch(kind, name, device, (ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_longlong * len(part))(*sizes), len(part), *args)
        calls += 1
    return calls


def _check_lists(name: str, ps, gs, *moments, quant: str = "off"
                 ) -> torch.device:
    """The checks of an entry over every bucket of a step: lists of one
    length, each bucket as its one-bucket entry takes it, all on one
    device. Returns the device."""
    if not ps or any(len(x) != len(ps) for x in (gs, *moments)):
        raise ValueError(f"{name} takes one or more buckets and as many "
                         f"gradients and moments, got "
                         + ", ".join(str(len(x)) for x in (ps, gs, *moments)))
    device = ps[0].device
    for p, g, *ms in zip(ps, gs, *moments):
        if quant == "off":
            _check_bucket(name, p, g, *ms)
        else:
            _check_bucket(name, p, g)
            for plane in ms:
                _check_plane(name, p, plane)
        if p.device != device:
            raise ValueError(f"{name}: buckets on different devices: "
                             f"{device} and {p.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    return device


def sgdm_fp32(p, g, m, lr: float, *, mu: float, wd: float) -> None:
    """Launch K4 on one bucket: p and m rewritten in place."""
    _check_bucket("sgdm_fp32", p, g, m)
    _launch("sgdm", "sgdm_fp32", p.device, p.data_ptr(), g.data_ptr(),
            m.data_ptr(), p.numel(), float(lr), float(mu), float(wd),
            int(bool(wd)))
    sgdm_fp32.launches += 1


def sgdm_fp32_buckets(ps, gs, ms, lr: float, *, mu: float,
                      wd: float) -> None:
    """Momentum-SGD over every bucket of a step, p and m rewritten in
    place: on the card K4 once over a table of all the buckets (once per
    SGDM_TABLE_MAX of them), counted in ``sgdm_fp32.launches``; on the CPU
    the plain version bucket by bucket."""
    device = _check_lists("sgdm_fp32_buckets", ps, gs, ms)
    if device.type == "cpu":
        for p, g, m in zip(ps, gs, ms):
            _sgdm_plain(p, g, m, lr, mu, wd, "off")
        return
    for i in range(0, len(ps), SGDM_TABLE_MAX):
        part = slice(i, i + SGDM_TABLE_MAX)
        n = len(ps[part])
        ptrs = [(ctypes.c_void_p * n)(*(t.data_ptr() for t in ts[part]))
                for ts in (ps, gs, ms)]
        sizes = (ctypes.c_longlong * n)(*(p.numel() for p in ps[part]))
        _launch("sgdm_buckets", "sgdm_fp32_buckets", device, *ptrs, sizes, n,
                float(lr), float(mu), float(wd), int(bool(wd)))
        sgdm_fp32.launches += 1


def _sgdm_q_rows(ps, gs, planes) -> list[tuple]:
    return [(p, g, *m) for p, g, m in zip(ps, gs, planes)]


def _sgdm_scalars(lr, mu, wd, quant) -> tuple:
    """The C entries' arguments of K6 after the table: lr, mu, wd, use_wd
    and the codec (1: fp8)."""
    return (float(lr), float(mu), float(wd), int(bool(wd)),
            int(quant == "fp8"))


def sgdm_q_buckets(ps, gs, planes, lr: float, *, mu: float, wd: float,
                   quant: str) -> None:
    """Momentum-SGD with a quantized momentum over every bucket of a step,
    p and the QPlanes rewritten in place: on the card K6 (a memset and its
    three passes over a table of the buckets, once per SGDM_Q_TABLE_MAX
    of them), each call of its entry counted in ``sgdm_q.launches``; on
    the CPU the plain version bucket by bucket."""
    _check_q("sgdm_q_buckets", quant)
    device = _check_lists("sgdm_q_buckets", ps, gs, planes, quant=quant)
    if device.type == "cpu":
        for p, g, m in zip(ps, gs, planes):
            _sgdm_plain(p, g, m, lr, mu, wd, quant)
        return
    words = _build.scratch_words(
        device, _SGDM_Q_WORDS * min(len(ps), SGDM_Q_TABLE_MAX))
    sgdm_q.launches += _launch_tables(
        "sgdm_q_buckets", "sgdm_q_buckets", device, SGDM_Q_TABLE_MAX,
        _sgdm_q_rows(ps, gs, planes), words.data_ptr(),
        *_sgdm_scalars(lr, mu, wd, quant))


def sgdm_q_pass(ps, gs, planes, lr: float, *, mu: float, wd: float,
                quant: str, which: int) -> None:
    """One pass of K6 alone over a table of CUDA buckets, for timing
    (csrc/sgdm.cu, edl_sgdm_q_pass): ``which`` 0, 1, 2 = passes A, B, C.
    Not counted in ``sgdm_q.launches``: no step runs it."""
    _check_q("sgdm_q_pass", quant)
    device = _check_lists("sgdm_q_pass", ps, gs, planes, quant=quant)
    if device.type != "cuda" or len(ps) > SGDM_Q_TABLE_MAX:
        raise ValueError(f"sgdm_q_pass times one table of at most "
                         f"{SGDM_Q_TABLE_MAX} CUDA buckets")
    words = _build.scratch_words(device, _SGDM_Q_WORDS * len(ps))
    _launch_tables("sgdm_q_pass", "sgdm_q_pass", device, SGDM_Q_TABLE_MAX,
                   _sgdm_q_rows(ps, gs, planes), words.data_ptr(), int(which),
                   *_sgdm_scalars(lr, mu, wd, quant))


def sgdm_q(p, g, plane: QPlane, lr: float, *, mu: float, wd: float,
           quant: str) -> None:
    """Launch K6 on one bucket (the one-entry table): p and the QPlane
    (payloads and scales) rewritten in place."""
    sgdm_q_buckets([p], [g], [plane], lr, mu=mu, wd=wd, quant=quant)


def _adam_scalars(lr, c1, c2, b1, b2, eps, wd) -> tuple:
    """The C entries' fp32 scalars of Adam(W), after the table:
    lr, c1, c2, b1, 1 - b1, b2, 1 - b2, eps, wd, use_wd."""
    return (float(lr), float(c1), float(c2), float(b1), float(1 - b1),
            float(b2), float(1 - b2), float(eps), float(wd), int(bool(wd)))


def adam_fp32_buckets(ps, gs, ms, vs, lr: float, c1: float, c2: float, *,
                      b1: float, b2: float, eps: float, wd: float) -> None:
    """Adam(W) over every bucket of a step, p, m and v rewritten in place:
    on the card K5 once over a table of all the buckets (once per
    ADAM_TABLE_MAX of them), counted in ``adam_fp32.launches``; on the CPU
    the plain version bucket by bucket."""
    device = _check_lists("adam_fp32_buckets", ps, gs, ms, vs)
    if device.type == "cpu":
        for p, g, m, v in zip(ps, gs, ms, vs):
            _adam_plain(p, g, m, v, lr, c1, c2, b1, b2, eps, wd, "off")
        return
    adam_fp32.launches += _launch_tables(
        "adam_fp32_buckets", "adam_fp32_buckets", device, ADAM_TABLE_MAX,
        list(zip(ps, gs, ms, vs)), *_adam_scalars(lr, c1, c2, b1, b2, eps, wd))


def adam_fp32(p, g, m, v, lr: float, c1: float, c2: float, *, b1: float,
              b2: float, eps: float, wd: float) -> None:
    """Launch K5 on one bucket (the one-entry table): p, m, v rewritten in
    place."""
    adam_fp32_buckets([p], [g], [m], [v], lr, c1, c2, b1=b1, b2=b2, eps=eps,
                      wd=wd)


def _adam_q_rows(ps, gs, m_planes, v_planes) -> list[tuple]:
    return [(p, g, *m, *v) for p, g, m, v in zip(ps, gs, m_planes, v_planes)]


def adam_q_buckets(ps, gs, m_planes, v_planes, lr: float, c1: float,
                   c2: float, *, b1: float, b2: float, eps: float, wd: float,
                   quant: str) -> None:
    """Adam(W) with quantized moments over every bucket of a step, p and
    both QPlanes rewritten in place (m on ``quant``'s codec, v on
    ``V_QUANT``'s): on the card K7 (a memset and its three passes over a
    table of the buckets, once per ADAM_Q_TABLE_MAX of them), each call
    of its entry counted in ``adam_q.launches``; on the CPU the plain
    version bucket by bucket."""
    _check_q("adam_q_buckets", quant)
    device = _check_lists("adam_q_buckets", ps, gs, m_planes, v_planes,
                          quant=quant)
    if device.type == "cpu":
        for p, g, m, v in zip(ps, gs, m_planes, v_planes):
            _adam_plain(p, g, m, v, lr, c1, c2, b1, b2, eps, wd, quant)
        return
    words = _build.scratch_words(
        device, _ADAM_Q_WORDS * min(len(ps), ADAM_Q_TABLE_MAX))
    adam_q.launches += _launch_tables(
        "adam_q_buckets", "adam_q_buckets", device, ADAM_Q_TABLE_MAX,
        _adam_q_rows(ps, gs, m_planes, v_planes), words.data_ptr(),
        *_adam_scalars(lr, c1, c2, b1, b2, eps, wd), int(quant == "fp8"))


def adam_q_pass(ps, gs, m_planes, v_planes, lr: float, c1: float,
                c2: float, *, b1: float, b2: float, eps: float, wd: float,
                quant: str, which: int) -> None:
    """One pass of K7 alone over a table of CUDA buckets, for timing
    (csrc/adam_q.cu, edl_adam_q_pass): ``which`` 0, 1, 2 = passes A, B, C;
    3 = C's loads and stores without its arithmetic. Not counted in
    ``adam_q.launches``: no step runs it."""
    _check_q("adam_q_pass", quant)
    device = _check_lists("adam_q_pass", ps, gs, m_planes, v_planes,
                          quant=quant)
    if device.type != "cuda" or len(ps) > ADAM_Q_TABLE_MAX:
        raise ValueError(f"adam_q_pass times one table of at most "
                         f"{ADAM_Q_TABLE_MAX} CUDA buckets")
    words = _build.scratch_words(device, _ADAM_Q_WORDS * len(ps))
    _launch_tables("adam_q_pass", "adam_q_pass", device, ADAM_Q_TABLE_MAX,
                   _adam_q_rows(ps, gs, m_planes, v_planes), words.data_ptr(),
                   int(which), *_adam_scalars(lr, c1, c2, b1, b2, eps, wd),
                   int(quant == "fp8"))


def adam_q(p, g, m_plane: QPlane, v_plane: QPlane, lr: float, c1: float,
           c2: float, *, b1: float, b2: float, eps: float, wd: float,
           quant: str) -> None:
    """Launch K7 on one bucket (the one-entry table): p and both QPlanes
    rewritten in place; m on ``quant``'s codec, v on ``V_QUANT``'s."""
    adam_q_buckets([p], [g], [m_plane], [v_plane], lr, c1, c2, b1=b1, b2=b2,
                   eps=eps, wd=wd, quant=quant)


sgdm_fp32.launches = 0
sgdm_q.launches = 0
adam_fp32.launches = 0
adam_q.launches = 0


# -- per-bucket public entry points ------------------------------------------


def adam_bucket(p, g, m_state, v_state, lr: float, c1: float, c2: float, *,
                b1: float, b2: float, eps: float, wd: float,
                quant: str = "off"):
    """Fused Adam(W) update of one bucket, in place.

    m_state/v_state: fp32 buffers (quant='off') or :class:`QPlane`s.
    c1/c2 are the bias-correction denominators (1 - b^t), precomputed by
    the caller so the kernel and the plain version consume identical
    scalars. Returns (p, m_state, v_state).
    """
    _check_quant(quant)
    hyper = dict(b1=b1, b2=b2, eps=eps, wd=wd)
    if p.device.type == "cuda":
        if quant == "off":
            adam_fp32(p, g, m_state, v_state, lr, c1, c2, **hyper)
        else:
            adam_q(p, g, m_state, v_state, lr, c1, c2, quant=quant, **hyper)
    elif p.device.type == "cpu":
        if quant == "off":
            _check_bucket("adam_bucket", p, g, m_state, v_state)
        else:
            _check_bucket("adam_bucket", p, g)
            _check_plane("adam_bucket", p, m_state)
            _check_plane("adam_bucket", p, v_state)
        _adam_plain(p, g, m_state, v_state, lr, c1, c2, quant=quant,
                    **hyper)
    else:
        raise ValueError(f"adam_bucket runs on cpu or cuda, not {p.device}")
    return p, m_state, v_state


def sgdm_bucket(p, g, m_state, lr: float, *, mu: float, wd: float,
                quant: str = "off"):
    """Fused momentum-SGD update of one bucket, in place.

    m_state: fp32 buffer (quant='off') or :class:`QPlane`. Returns
    (p, m_state).
    """
    _check_quant(quant)
    if p.device.type == "cuda":
        if quant == "off":
            sgdm_fp32(p, g, m_state, lr, mu=mu, wd=wd)
        else:
            sgdm_q(p, g, m_state, lr, mu=mu, wd=wd, quant=quant)
    elif p.device.type == "cpu":
        if quant == "off":
            _check_bucket("sgdm_bucket", p, g, m_state)
        else:
            _check_bucket("sgdm_bucket", p, g)
            _check_plane("sgdm_bucket", p, m_state)
        _sgdm_plain(p, g, m_state, lr, mu, wd, quant)
    else:
        raise ValueError(f"sgdm_bucket runs on cpu or cuda, not {p.device}")
    return p, m_state
