"""K6's entry over every bucket of a step
(``edl_tpu_torch.ops.opt_kernels.sgdm_q_buckets``: momentum-SGD with an
int8 or fp8 momentum plane) against the JAX package's per-bucket
update, on the CPU.

On a CPU tensor the entry runs its plain version, ``_sgdm_plain`` bucket
by bucket; on a card it is K6's memset and three passes over a table of
the buckets, held bit for bit against the same plain version by
chip_smoke.py. The plan is ragged: buckets of several lengths, one whose
payload stops short of its 128-aligned length, an all-zero one and one
whose abs-max is a single pinned element (x / scale lands on the codec's
edge). Tolerances:

- JAX's XLA path (``_sgdm_xla_q``) run op by op (``jax.disable_jit``):
  bitwise, p and every tensor of the plane. Jitted, XLA contracts the
  update's multiply-adds into fmas, one rounding away.
- JAX's Pallas kernel in interpret mode (``_sgdm_q_pallas(...,
  interpret=True)``): interpret mode compiles the kernel body, where XLA
  contracts and divides amax by 127 as a multiplication by its rounded
  reciprocal (tests/test_torch_pack.py), even op by op. So the bounds
  are tests/test_torch_opt_quant.py's (``_assert_moments_close``: the
  moment within two steps of the residual codec, 99% of the payload
  codes equal, the scales within 1e-4 relative; p within 1e-5 at lr
  0.1), and the all-zero bucket stays exactly zero on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import opt_kernels as jok
from edl_tpu_torch.ops import opt_kernels as tok
from edl_tpu_torch.train import fused_opt as tfo
from test_torch_adam_buckets import _Launches
from test_torch_opt_quant import _assert_moments_close

MU = 0.9


def _plan(seed: int = 0):
    """(parameter buckets, 3 steps of gradient buckets, payload lengths):
    the fused optimizer's gate world plus a ragged 5000-element leaf in
    buckets of 0.01 MiB, then an all-zero bucket and one with a pinned
    abs-max in p and in every gradient."""
    params, grads = tfo._gate_world(seed)
    rng = np.random.default_rng(seed + 1)
    params.append(("zz_big", torch.nn.Parameter(torch.from_numpy(
        rng.normal(0, 0.1, 5000).astype(np.float32)))))
    grads.append(torch.from_numpy(
        rng.normal(0, 0.02, 5000).astype(np.float32)))
    tx = tfo.fused_sgd(0.1, MU, 1e-4, bucket_mb=0.01)
    state = tx.init(params)
    leaves = [p for _, p in params]
    steps = []
    for k in range(3):
        scaled = [g * (1.0 + 0.5 * k) for g in grads]
        steps.append([g.clone() for g in
                      tfo._grad_buckets(tx.plan(params), leaves, scaled)])
    p_bufs = [p.detach().clone() for p in state.p]
    payload = [b.size for b in tx.plan(params).buckets]
    # an all-zero bucket, and one whose abs-max is one pinned element
    pinned = rng.normal(0, 0.1, 1024).astype(np.float32)
    pinned[333] = -4.0
    p_bufs += [torch.zeros(256), torch.from_numpy(pinned)]
    for k, g_bufs in enumerate(steps):
        g = rng.normal(0, 0.02, 1024).astype(np.float32)
        g[77] = 0.9 * (k + 1)
        g_bufs += [torch.zeros(256), torch.from_numpy(g)]
    payload += [256, 1024]
    return p_bufs, steps, payload


def _lr(step: int) -> float:
    return float(np.float32(0.1 * (step + 1) / 3))


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _port_steps(quant: str, wd: float):
    """3 steps of sgdm_q_buckets from zero planes: (p, planes) after each
    step, copied."""
    p_bufs, steps, _ = _plan()
    planes = [tok.zero_plane(p.numel(), quant) for p in p_bufs]
    out = []
    for step, g_bufs in enumerate(steps):
        tok.sgdm_q_buckets(p_bufs, g_bufs, planes, _lr(step), mu=MU, wd=wd,
                           quant=quant)
        out.append(([p.clone() for p in p_bufs],
                    [tok.QPlane(*(t.clone() for t in m)) for m in planes]))
    return out


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_q_buckets_match_jax_xla_bucket_by_bucket_bitwise(quant, wd):
    p_bufs, steps, payload = _plan()
    sizes = [p.numel() for p in p_bufs]
    assert len(p_bufs) >= 6 and max(sizes) > 2 * min(sizes)
    assert any(n < p.numel() for n, p in zip(payload, p_bufs))
    launches = tok.sgdm_q.launches
    got = _port_steps(quant, wd)
    assert tok.sgdm_q.launches == launches   # the plain version on the CPU
    jp = [jnp.asarray(p.numpy()) for p in p_bufs]
    jm = [jok.zero_plane(n, quant) for n in sizes]
    for step, g_bufs in enumerate(steps):
        with jax.disable_jit():
            for i, g in enumerate(g_bufs):
                out = jok._sgdm_xla_q(jp[i], jnp.asarray(g.numpy()), *jm[i],
                                      jnp.float32(_lr(step)), mu=MU, wd=wd,
                                      quant=quant)
                jp[i], jm[i] = out[0], jok.QPlane(*out[1:])
        tp, tm = got[step]
        for i in range(len(p_bufs)):
            msg = f"bucket {i}, step {step}"
            np.testing.assert_array_equal(_bits(jp[i]), _bits(tp[i].numpy()),
                                          err_msg=msg)
            for a, b in zip(jm[i], tm[i]):
                np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                              err_msg=msg)
    tp, tm = got[-1]
    for p, m, n in zip(tp, tm, payload):
        assert not p[n:].any() and not m.q[n:].any() and not m.rq[n:].any()
    # the all-zero bucket stays exact; the pinned one is at the codec's edge
    assert not tp[-2].any() and float(tm[-2].scale) == 1.0
    codes = (tm[-1].q.float() if quant == "int8"
             else tok._dequantize_fp8(tm[-1].q, torch.tensor(1.0)))
    assert float(codes.abs().max()) == (127.0 if quant == "int8" else 448.0)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_q_buckets_match_jax_pallas_interpret(quant, wd):
    p_bufs, steps, _ = _plan()
    tp, tm = _port_steps(quant, wd)[-1]
    for i, p in enumerate(p_bufs):
        jp, jm = jnp.asarray(p.numpy()), jok.zero_plane(p.numel(), quant)
        for step, g_bufs in enumerate(steps):
            o = jok._sgdm_q_pallas(
                jok._lanes(jp), jok._lanes(jnp.asarray(g_bufs[i].numpy())),
                jok._lanes(jm.q), jok._s11(jm.scale), jok._lanes(jm.rq),
                jok._s11(jm.rscale), jok._s11(_lr(step)), mu=MU, wd=wd,
                quant=quant, interpret=True)
            jp = o[0].reshape(-1)
            jm = jok.QPlane(o[1].reshape(-1), o[2].reshape(()),
                            o[3].reshape(-1), o[4].reshape(()))
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5, err_msg=f"bucket {i}")
        _assert_moments_close([jm], [tm[i]], quant, "sgdm")
        if i == len(p_bufs) - 2:   # the all-zero bucket: exact on both sides
            for t in (jp, jm.q, jm.rq, tp[i], tm[i].q, tm[i].rq):
                assert not np.asarray(t).any()


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_q_buckets_equal_the_per_bucket_entry(quant):
    """One call over the plan equals sgdm_bucket on each bucket in turn
    (the per-bucket API the JAX package mirrors), bit for bit, from
    nonzero planes."""
    p_bufs, steps, _ = _plan(seed=3)
    rng = np.random.default_rng(5)
    a, b = [p.clone() for p in p_bufs], [p.clone() for p in p_bufs]
    ma, mb = [], []
    for p in p_bufs:
        m = torch.from_numpy(rng.normal(0, 0.01, p.numel()).astype(np.float32))
        ma.append(tok.quant_plane(m, quant))
        mb.append(tok.quant_plane(m, quant))
    tok.sgdm_q_buckets(a, steps[0], ma, 0.05, mu=MU, wd=1e-4, quant=quant)
    for p, g, m in zip(b, steps[0], mb):
        tok.sgdm_bucket(p, g, m, 0.05, mu=MU, wd=1e-4, quant=quant)
    for x, y in zip(a + [t for m in ma for t in m],
                    b + [t for m in mb for t in m]):
        assert tfo.bitwise_equal(x, y)


def test_q_buckets_refuse_what_the_kernel_does_not_take():
    z = [torch.zeros(256), torch.zeros(128)]
    mz = [tok.zero_plane(256, "int8"), tok.zero_plane(128, "int8")]

    def call(ps, gs, ms, quant="int8"):
        tok.sgdm_q_buckets(ps, gs, ms, 0.1, mu=MU, wd=0.0, quant=quant)

    with pytest.raises(ValueError, match="as many"):
        call(z, z[:1], mz)
    with pytest.raises(ValueError, match="as many"):
        call(z, z, mz[:1])
    with pytest.raises(ValueError, match="one or more"):
        call([], [], [])
    with pytest.raises(ValueError, match="one length"):
        call(z, [z[1], z[0]], mz)
    with pytest.raises(ValueError, match="multiple of 128"):
        call([torch.zeros(100)], [torch.zeros(100)],
             [tok.zero_plane(100, "int8")])
    shifted = torch.zeros(260)[1:257]          # 4 bytes past an aligned base
    with pytest.raises(ValueError, match="16-byte aligned"):
        call([shifted], [z[0]], mz[:1])
    with pytest.raises(TypeError, match="QPlane"):
        call(z, z, z)
    with pytest.raises(ValueError, match="int8 or fp8"):
        call(z, z, mz, quant="off")
    meta = torch.zeros(128, device="meta")
    mmeta = tok.zero_plane(128, "int8", device="meta")
    with pytest.raises(ValueError, match="different devices"):
        call([z[1], meta], [z[1], meta], [mz[1], mmeta])
    with pytest.raises(ValueError, match="cpu or cuda"):
        call([meta], [meta], [mmeta])
    with pytest.raises(ValueError, match="CUDA buckets"):
        tok.sgdm_q_pass(z, z, mz, 0.1, mu=MU, wd=0.0, quant="int8", which=0)


def test_a_plan_longer_than_the_table_is_split(monkeypatch):
    """Above the table maximum a step takes one entry call per table's
    worth of buckets, each handed its buckets' pointers in order (p, g,
    q, scale, rq, rscale), the words and the scalars, and each counted
    once in sgdm_q.launches."""
    limit = tok.SGDM_Q_TABLE_MAX
    n = 2 * limit + 3
    rec = _Launches(6)
    card = torch.device("cuda", 0)
    monkeypatch.setattr(tok, "_launch", rec)
    monkeypatch.setattr(tok, "_check_lists", lambda *a, **k: card)
    words = torch.zeros(3 * limit, dtype=torch.int32)
    monkeypatch.setattr(tok._build, "scratch_words",
                        lambda device, k: words[:k])
    ps = [torch.zeros(128 * (1 + i % 3)) for i in range(n)]
    gs = [torch.zeros_like(p) for p in ps]
    ms = [tok.zero_plane(p.numel(), "fp8") for p in ps]
    before = tok.sgdm_q.launches
    tok.sgdm_q_buckets(ps, gs, ms, 0.1, mu=MU, wd=1e-4, quant="fp8")
    assert tok.sgdm_q.launches - before == 3
    assert [c["count"] for c in rec.calls] == [limit, limit, 3]
    assert [x for c in rec.calls for x in c["ptrs"]] == [
        t.data_ptr() for p, g, m in zip(ps, gs, ms) for t in (p, g, *m)]
    assert [x for c in rec.calls for x in c["sizes"]] == [
        p.numel() for p in ps]
    # the words, lr, mu, wd, use_wd, then the codec (1: fp8)
    for c in rec.calls:
        assert c["kind"] == "sgdm_q_buckets"
        assert c["args"] == (words.data_ptr(), 0.1, MU, 1e-4, 1, 1)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_fused_apply_takes_every_sgdm_q_bucket_in_one_call(monkeypatch,
                                                          quant):
    """fused_apply hands quantized momentum-SGD to sgdm_q_buckets once a
    step, with every bucket, and never to the per-bucket entry."""
    calls, per_bucket = [], []
    entry = tok.sgdm_q_buckets

    def spy(ps, *args, **kw):
        calls.append(len(ps))
        entry(ps, *args, **kw)

    monkeypatch.setattr(tok, "sgdm_q_buckets", spy)
    monkeypatch.setattr(tok, "sgdm_bucket",
                        lambda *a, **k: per_bucket.append(a))
    params, grads = tfo._gate_world(0)
    tx = tfo.fused_sgd(0.1, MU, 1e-4, quant=quant, bucket_mb=0.01)
    state = tx.init(params)
    for _ in range(2):
        _, state = tx.fused_apply(grads, state, params)
    assert len(state.p) > 1
    assert calls == [len(state.p)] * 2 and not per_bucket
    assert state.count == 2
