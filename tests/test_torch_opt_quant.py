"""The port's quantized resident moments (ops/pack.py, the QPlane codec and
the quantized bucket updates of ops/opt_kernels.py, the quantized modes of
train/fused_opt.py) against the JAX package's.

On the CPU the bucket updates run their plain versions; the CUDA kernels
K4, K6 and K7 are held against those bit for bit on the card by
chip_smoke.py. JAX's side runs its Pallas kernels in interpret mode
(``_FORCE_INTERPRET`` set through monkeypatch, so nothing leaks into
other tests). Tolerances:

- the codec alone (quant_plane / dequant_plane / zero_plane, eager JAX):
  bitwise;
- three bucket steps: JAX runs the update jitted, where XLA contracts
  the residual m - q*scale (and the update's multiply-adds) into fmas.
  One rounding apart, a residual code may move by one step: the
  reassembled moments agree within two steps of the residual codec at
  its coarsest (int8: 2 x rscale; fp8 e4m3: 2 x 32 x rscale, the code
  spacing just below 448); the payload codes q agree on at least 99% of
  the elements; the scales within 1e-4 relative (one residual step of
  an int8 moment is 1/(127 x 254) of its abs-max, 3.1e-5 relative, and
  the residual's own abs-max moves by an ulp of the moment, up to
  254 x 2^-24); the parameters within 1e-5 (lr x the moment gaps, summed
  over the steps; lr 0.1 for momentum-SGD, 1e-3 for Adam). The fp32
  moments (quant 'off') keep the fp32 tests' rtol 1e-6 / atol 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edl_tpu.ops.opt_kernels as jok
from edl_tpu.ops import pack as jpack
from edl_tpu.train import fused_opt as jfo
from edl_tpu_torch.ops import opt_kernels as tok
from edl_tpu_torch.ops import pack as tpack
from edl_tpu_torch.train import fused_opt as tfo

QUANTS = ["int8", "fp8"]
# code spacing of the residual codec at its largest codes, in rscales
RESID_STEP = {"int8": 1.0, "fp8": 32.0}


@pytest.fixture
def interpret(monkeypatch):
    """JAX's bucket updates through its Pallas kernels in interpret
    mode, for this test only."""
    monkeypatch.setattr(jok, "_FORCE_INTERPRET", True)


def _moment(n=4096, seed=0, std=0.05, pin=None):
    x = np.random.default_rng(seed).normal(0, std, n).astype(np.float32)
    if pin is not None:
        x[pin] = -7.0 * std      # the bucket's abs-max: one pinned element
    return x


def _planes_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("pin", [None, 1234])
@pytest.mark.parametrize("quant", QUANTS)
def test_codec_matches_jax_bitwise(quant, pin):
    x = _moment(pin=pin)
    want = jok.quant_plane(jnp.asarray(x), quant)
    got = tok.quant_plane(torch.from_numpy(x), quant)
    assert got.q.dtype == torch.int8 and got.scale.dim() == 0
    _planes_equal(want, got)
    np.testing.assert_array_equal(
        np.asarray(jok.dequant_plane(want, quant)),
        tok.dequant_plane(got, quant).numpy())
    if pin is not None:
        edge = 127 if quant == "int8" else 0x7E    # -127 / e4m3 -448 bits
        code = int(got.q[pin])
        assert code == (-edge if quant == "int8" else edge | -0x80)


def test_int8_codec_matches_jax_pack():
    x = _moment(seed=3, pin=7)
    s_j = jpack.symmetric_scale(jnp.asarray(x))
    s_t = tpack.symmetric_scale(torch.from_numpy(x))
    assert float(s_j) == float(s_t)
    q_j = jpack.quantize_int8(jnp.asarray(x), s_j)
    q_t = tpack.quantize_int8(torch.from_numpy(x), s_t)
    np.testing.assert_array_equal(np.asarray(q_j), q_t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jpack.dequantize_int8(q_j, s_j)),
        tpack.dequantize_int8(q_t, s_t).numpy())


@pytest.mark.parametrize("quant", QUANTS)
def test_zero_plane_matches_jax_and_is_exact(quant):
    want = jok.zero_plane(256, quant)
    got = tok.zero_plane(256, quant)
    _planes_equal(want, got)
    assert not tok.dequant_plane(got, quant).any()
    # an all-zero moment quantizes to the zero plane (scales 1.0)
    _planes_equal(want, tok.quant_plane(torch.zeros(256), quant))


def test_fp8_rounds_the_edge_to_448():
    """x / scale at the abs-max element can land just above 448; JAX,
    torch (and the kernel's __nv_cvt_float_to_fp8) all give 448."""
    x = np.float32([448.00003, -448.00003, 447.9, 1e-9, -1e-9])
    one = np.float32(1.0)
    got = tok._quantize_fp8(torch.from_numpy(x), torch.tensor(one))
    want = jok._quantize_fp8(jnp.asarray(x), jnp.asarray(one))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert tok._dequantize_fp8(got, torch.tensor(one))[:2].tolist() == [
        448.0, -448.0]


def _bucket_steps(opt, quant, wd, interpret_, payload=4096, padded=4096,
                  zero=False, steps=3):
    """``steps`` bucket updates of each package from the same p and
    gradients; returns (jax p, jax moments, port p, port moments)."""
    rng = np.random.default_rng(11)

    def buf(std):
        x = np.zeros(padded, np.float32)
        if not zero:
            x[:payload] = rng.normal(0, std, payload)
        return x

    p0 = buf(0.1)
    grads = [buf(0.02) for _ in range(steps)]
    # lr 0.1 for momentum-SGD, 1e-3 for Adam (whose update is ~1 an
    # element): the scalars both packages' updates take
    ttx = (tfo.fused_sgd(0.1) if opt == "sgdm" else tfo.fused_adam(1e-3))
    zero_j = ((lambda: jnp.zeros(padded, jnp.float32)) if quant == "off"
              else (lambda: jok.zero_plane(padded, quant)))
    zero_t = ((lambda: torch.zeros(padded)) if quant == "off"
              else (lambda: tok.zero_plane(padded, quant)))
    n_mom = 1 if opt == "sgdm" else 2
    jp, jm = jnp.asarray(p0), [zero_j() for _ in range(n_mom)]
    tp, tm = torch.from_numpy(p0.copy()), [zero_t() for _ in range(n_mom)]
    for step, g in enumerate(grads):
        lr, c1, c2 = ttx.scalars(step)
        if opt == "sgdm":
            jp, m = jok.sgdm_bucket(jp, jnp.asarray(g), jm[0], lr, mu=0.9,
                                    wd=wd, quant=quant)
            jm = [m]
            tok.sgdm_bucket(tp, torch.from_numpy(g), tm[0], lr, mu=0.9,
                            wd=wd, quant=quant)
        else:
            jp, m, v = jok.adam_bucket(jp, jnp.asarray(g), jm[0], jm[1], lr,
                                       c1, c2, b1=0.9, b2=0.999, eps=1e-8,
                                       wd=wd, quant=quant)
            jm = [m, v]
            tok.adam_bucket(tp, torch.from_numpy(g), tm[0], tm[1], lr, c1,
                            c2, b1=0.9, b2=0.999, eps=1e-8, wd=wd,
                            quant=quant)
    return np.asarray(jp), jm, tp.numpy(), tm


def _assert_moments_close(jm, tm, quant, opt):
    for i, (a, b) in enumerate(zip(jm, tm)):
        if quant == "off":
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-8)
            continue
        codec = quant if i == 0 else tok.V_QUANT
        step = RESID_STEP[codec] * float(a.rscale)
        np.testing.assert_allclose(
            tok.dequant_plane(b, codec).numpy(),
            np.asarray(jok.dequant_plane(a, codec)), rtol=0, atol=2 * step)
        assert np.mean(np.asarray(a.q) == b.q.numpy()) >= 0.99
        for s_j, s_t in ((a.scale, b.scale), (a.rscale, b.rscale)):
            np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-4)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("quant", ["off"] + QUANTS)
@pytest.mark.parametrize("opt", ["sgdm", "adam"])
def test_bucket_steps_match_jax_pallas(interpret, opt, quant, wd):
    jp, jm, tp, tm = _bucket_steps(opt, quant, wd, interpret)
    np.testing.assert_allclose(tp, jp, rtol=0,
                               atol=1e-6 if quant == "off" else 1e-5)
    _assert_moments_close(jm, tm, quant, opt)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("opt", ["sgdm", "adam"])
def test_ragged_bucket_keeps_zero_padding(interpret, opt, quant):
    """A bucket whose payload stops short of its 128-aligned length: the
    padding of p and of every plane stays zero, and the payload matches
    JAX as above."""
    jp, jm, tp, tm = _bucket_steps(opt, quant, 1e-4, interpret,
                                   payload=4000, padded=4096)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    _assert_moments_close(jm, tm, quant, opt)
    assert not tp[4000:].any()
    for plane in tm:
        assert not plane.q[4000:].any() and not plane.rq[4000:].any()


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("opt", ["sgdm", "adam"])
def test_all_zero_bucket_stays_exact(interpret, opt, quant):
    jp, jm, tp, tm = _bucket_steps(opt, quant, 1e-4, interpret, zero=True)
    assert not tp.any() and not np.asarray(jp).any()
    for a, b in zip(jm, tm):
        _planes_equal(a, b)
        assert float(b.scale) == float(b.rscale) == 1.0


@pytest.mark.parametrize("quant", QUANTS)
def test_residual_carryover_tracks_fp32_moments(quant):
    """The port of the JAX package's test (tests/test_fused_opt.py):
    across 6 steps the residual re-contributes what requantization
    rounded away, so the quantized moments and params stay within 1e-3
    of the fp32 fused run's."""
    def run(q):
        params, grads = tfo._gate_world(1)
        tx = tfo.fused_sgd(0.1, 0.9, 1e-4, quant=q, bucket_mb=0.05)
        return tfo._run_fused(tx, params, grads, 6)

    dense, quantized = run("off"), run(quant)
    for m_fp32, plane in zip(dense.m, quantized.m):
        m_q = tok.dequant_plane(plane, quant)
        assert float((m_fp32 - m_q).abs().max()) < 1e-3
    err = max(float((a - b).abs().max())
              for a, b in zip(dense.p, quantized.p))
    assert err < 1e-3


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("opt", ["sgdm", "adam"])
def test_opt_state_bytes_cut(opt, quant):
    """The quantized planes cut the resident state >= 1.8x, and count the
    same bytes as the JAX package's QPlane leaves."""
    params, _ = tfo._gate_world()
    make = tfo.fused_sgd if opt == "sgdm" else tfo.fused_adam
    dense = tfo.opt_state_bytes(make(0.1, bucket_mb=0.05).init(params))
    st = make(0.1, quant=quant, bucket_mb=0.05).init(params)
    quantized = tfo.opt_state_bytes(st)
    assert dense >= 1.8 * quantized
    jparams = {n: jnp.asarray(p.detach().numpy()) for n, p in params}
    jmake = jfo.fused_sgd if opt == "sgdm" else jfo.fused_adam
    jstate = jmake(0.1, quant=quant, bucket_mb=0.05).init(jparams)
    # the JAX state also counts its int32 step counter
    assert quantized == jfo.opt_state_bytes(jstate) - 4


@pytest.mark.parametrize("quant", QUANTS)
def test_fused_quantized_adam_matches_jax_over_three_steps(interpret,
                                                           quant):
    """FusedOptimizer end to end on the gate world (a multi-bucket plan,
    lane padding): params and moments against the JAX package's fused
    tx, within the bucket tolerances above."""
    params, grads = tfo._gate_world(2)
    names = [n for n, _ in params]
    jparams = {n: jnp.asarray(p.detach().numpy()) for n, p in params}
    jgrads = {n: jnp.asarray(g.numpy()) for n, g in zip(names, grads)}
    jtx = jfo.fused_adam(1e-3, weight_decay=1e-4, quant=quant,
                         bucket_mb=0.01)
    ttx = tfo.fused_adam(1e-3, weight_decay=1e-4, quant=quant,
                         bucket_mb=0.01)
    jstate, tstate = jtx.init(jparams), ttx.init(params)
    for _ in range(3):
        jparams, jstate = jtx.fused_apply(jgrads, jstate, jparams)
        _, tstate = ttx.fused_apply(grads, tstate, params)
    assert len(tstate.m) == len(jstate.m) > 1
    for n, p in params:
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[n]), atol=1e-5)
    for jm, tm in zip(zip(jstate.m, jstate.v), zip(tstate.m, tstate.v)):
        _assert_moments_close(jm, tm, quant, "adam")


def test_quantized_plane_checks():
    p = torch.zeros(256)
    bad = tok.QPlane(torch.zeros(256, dtype=torch.int16), torch.tensor(1.0),
                     torch.zeros(256, dtype=torch.int8), torch.tensor(1.0))
    with pytest.raises(ValueError, match="int8"):
        tok.sgdm_bucket(p, p, bad, 0.1, mu=0.9, wd=0.0, quant="int8")
    with pytest.raises(TypeError, match="QPlane"):
        tok.sgdm_bucket(p, p, torch.zeros(256), 0.1, mu=0.9, wd=0.0,
                        quant="int8")
    with pytest.raises(ValueError, match="quant"):
        tok.sgdm_bucket(p, p, torch.zeros(256), 0.1, mu=0.9, wd=0.0,
                        quant="int4")
