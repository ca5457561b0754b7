"""The Adam(W) entries over every bucket of a step
(``edl_tpu_torch.ops.opt_kernels.adam_fp32_buckets`` for K5 and
``adam_q_buckets`` for K7) against the JAX package's per-bucket
``edl_tpu.ops.opt_kernels.adam_bucket``, on the CPU.

On a CPU tensor each entry runs its plain version, ``_adam_plain``
bucket by bucket; on a card it is K5 in one launch, or K7's memset and
three passes, over a table of the buckets, held bit for bit against the
same plain version by chip_smoke.py. Tolerances:

- fp32 moments: bitwise. The JAX side runs op by op
  (``jax.disable_jit``): jitted, XLA contracts the update's
  multiply-adds into fmas, one rounding away from the plain version.
- quantized moments: JAX's per-bucket update runs its plain reference
  jitted, where XLA contracts, so the bounds are those of
  tests/test_torch_opt_quant.py (``_assert_moments_close``: the moments
  within two steps of the residual codec, 99% of the payload codes equal,
  the scales within 1e-4 relative; the parameters within 1e-5 at lr
  1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import opt_kernels as jok
from edl_tpu_torch.ops import opt_kernels as tok
from edl_tpu_torch.train import fused_opt as tfo
from test_torch_opt_quant import _assert_moments_close

HYPER = dict(b1=0.9, b2=0.999, eps=1e-8)


def _ragged_plan(seed: int = 0):
    """The fused optimizer's gate world plus one oversized leaf whose
    length is not a multiple of 128, packed into buckets of 0.01 MiB:
    (parameter buckets, gradient buckets)."""
    params, grads = tfo._gate_world(seed)
    rng = np.random.default_rng(seed + 1)
    big = rng.normal(0, 0.1, 5000).astype(np.float32)
    params.append(("zz_big", torch.nn.Parameter(torch.from_numpy(big))))
    grads.append(torch.from_numpy(
        rng.normal(0, 0.02, 5000).astype(np.float32)))
    tx = tfo.fused_adam(1e-3, bucket_mb=0.01)
    state = tx.init(params)
    g_bufs = tfo._grad_buckets(tx.plan(params), [p for _, p in params],
                               grads)
    return [p.detach().clone() for p in state.p], g_bufs


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _scalars(step: int) -> tuple[float, float, float]:
    """(lr, c1, c2) of ``step`` under a rising schedule, as fp32 values."""
    tx = tfo.fused_adam(lambda count: 1e-3 * (count + 1) / 3)
    return tx.scalars(step)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fp32_buckets_match_jax_bucket_by_bucket_bitwise(wd):
    p_bufs, g_bufs = _ragged_plan()
    sizes = [p.numel() for p in p_bufs]
    assert len(p_bufs) >= 4 and max(sizes) > 2 * min(sizes)
    assert all(n % 128 == 0 for n in sizes)
    jp = [jnp.asarray(p.numpy()) for p in p_bufs]
    jm = [jnp.zeros_like(x) for x in jp]
    jv = [jnp.zeros_like(x) for x in jp]
    tp = [p.clone() for p in p_bufs]
    tm = [torch.zeros_like(p) for p in p_bufs]
    tv = [torch.zeros_like(p) for p in p_bufs]
    launches = tok.adam_fp32.launches
    for step in range(3):
        lr, c1, c2 = _scalars(step)
        with jax.disable_jit():
            for i, g in enumerate(g_bufs):
                jp[i], jm[i], jv[i] = jok.adam_bucket(
                    jp[i], jnp.asarray(g.numpy()), jm[i], jv[i], lr, c1, c2,
                    wd=wd, **HYPER)
        tok.adam_fp32_buckets(tp, g_bufs, tm, tv, lr, c1, c2, wd=wd, **HYPER)
        for a, b in zip(jp + jm + jv, tp + tm + tv):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    # the plain version on the CPU: no kernel launched
    assert tok.adam_fp32.launches == launches
    assert all(p.abs().sum() > 0 for p in tp)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_q_buckets_match_jax_bucket_by_bucket(quant, wd):
    p_bufs, g_bufs = _ragged_plan(seed=1)
    jp = [jnp.asarray(p.numpy()) for p in p_bufs]
    jm = [(jok.zero_plane(p.numel(), quant),
           jok.zero_plane(p.numel(), jok.V_QUANT)) for p in p_bufs]
    tp = [p.clone() for p in p_bufs]
    t_m = [tok.zero_plane(p.numel(), quant) for p in p_bufs]
    t_v = [tok.zero_plane(p.numel(), tok.V_QUANT) for p in p_bufs]
    launches = tok.adam_q.launches
    for step in range(3):
        lr, c1, c2 = _scalars(step)
        for i, g in enumerate(g_bufs):
            jp[i], m, v = jok.adam_bucket(
                jp[i], jnp.asarray(g.numpy()), *jm[i], lr, c1, c2, wd=wd,
                quant=quant, **HYPER)
            jm[i] = (m, v)
        tok.adam_q_buckets(tp, g_bufs, t_m, t_v, lr, c1, c2, wd=wd,
                           quant=quant, **HYPER)
    assert tok.adam_q.launches == launches
    for i in range(len(p_bufs)):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[i]), rtol=0,
                                   atol=1e-5)
        _assert_moments_close(jm[i], (t_m[i], t_v[i]), quant, "adam")


def _moments(p_bufs, quant: str, seed: int = 5):
    """Nonzero starting moments of every bucket: fp32 buffers, or the
    QPlanes of them (v on its own codec)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in p_bufs:
        m = torch.from_numpy(rng.normal(0, 0.01, p.numel()).astype(np.float32))
        v = torch.from_numpy(
            np.abs(rng.normal(0, 1e-4, p.numel())).astype(np.float32))
        if quant == "off":
            out.append((m, v))
        else:
            out.append((tok.quant_plane(m, quant),
                        tok.quant_plane(v, tok.V_QUANT)))
    return out


def _flat(p_bufs, moments) -> list[torch.Tensor]:
    out = list(p_bufs)
    for pair in moments:
        for mom in pair:
            out.extend(mom if isinstance(mom, tok.QPlane) else (mom,))
    return out


@pytest.mark.parametrize("quant", ["off", "int8", "fp8"])
def test_buckets_equal_the_per_bucket_entry(quant):
    """One call over the plan equals adam_bucket on each bucket in turn
    (the per-bucket API the JAX package mirrors), bit for bit."""
    p_bufs, g_bufs = _ragged_plan(seed=3)
    a, b = [p.clone() for p in p_bufs], [p.clone() for p in p_bufs]
    ma, mb = _moments(p_bufs, quant), _moments(p_bufs, quant)
    lr, c1, c2 = _scalars(1)
    if quant == "off":
        tok.adam_fp32_buckets(a, g_bufs, *zip(*ma), lr, c1, c2, wd=0.01,
                              **HYPER)
    else:
        tok.adam_q_buckets(a, g_bufs, *zip(*ma), lr, c1, c2, wd=0.01,
                           quant=quant, **HYPER)
    for p, g, (m, v) in zip(b, g_bufs, mb):
        tok.adam_bucket(p, g, m, v, lr, c1, c2, wd=0.01, quant=quant,
                        **HYPER)
    for x, y in zip(_flat(a, ma), _flat(b, mb)):
        assert tfo.bitwise_equal(x, y)


def _call(quant: str, ps, gs, ms, vs):
    if quant == "off":
        tok.adam_fp32_buckets(ps, gs, ms, vs, 1e-3, 0.1, 0.001, wd=0.0,
                              **HYPER)
    else:
        tok.adam_q_buckets(ps, gs, ms, vs, 1e-3, 0.1, 0.001, wd=0.0,
                           quant=quant, **HYPER)


def _zero_moment(n: int, quant: str, device="cpu"):
    if quant == "off":
        return torch.zeros(n, device=device)
    return tok.zero_plane(n, quant, device=device)


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_buckets_refuse_what_the_kernel_does_not_take(quant):
    z = [torch.zeros(256), torch.zeros(128)]
    mz = [_zero_moment(256, quant), _zero_moment(128, quant)]
    with pytest.raises(ValueError, match="as many"):
        _call(quant, z, z[:1], mz, mz)
    with pytest.raises(ValueError, match="as many"):
        _call(quant, z, z, mz, mz[:1])
    with pytest.raises(ValueError, match="one or more"):
        _call(quant, [], [], [], [])
    with pytest.raises(ValueError, match="one length"):
        _call(quant, z, [z[1], z[0]], mz, mz)
    with pytest.raises(ValueError, match="multiple of 128"):
        odd = [torch.zeros(100)]
        _call(quant, odd, odd, odd if quant == "off" else
              [_zero_moment(100, quant)], odd if quant == "off" else
              [_zero_moment(100, quant)])
    shifted = torch.zeros(260)[1:257]          # 4 bytes past an aligned base
    with pytest.raises(ValueError, match="16-byte aligned"):
        _call(quant, [shifted], [z[0]], mz[:1], mz[:1])
    meta = torch.zeros(128, device="meta")
    mmeta = _zero_moment(128, quant, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        _call(quant, [z[1], meta], [z[1], meta], [mz[1], mmeta],
              [mz[1], mmeta])
    with pytest.raises(ValueError, match="cpu or cuda"):
        _call(quant, [meta], [meta], [mmeta], [mmeta])


def test_q_buckets_refuse_fp32_moments_and_other_modes():
    z = [torch.zeros(128)]
    planes = [tok.zero_plane(128, "int8")]
    with pytest.raises(TypeError, match="QPlane"):
        tok.adam_q_buckets(z, z, z, z, 1e-3, 0.1, 0.001, wd=0.0,
                           quant="int8", **HYPER)
    with pytest.raises(ValueError, match="int8 or fp8"):
        tok.adam_q_buckets(z, z, planes, planes, 1e-3, 0.1, 0.001, wd=0.0,
                           quant="off", **HYPER)


class _Launches:
    """Stands in for ``opt_kernels._launch``: records each entry call's
    kind, pointers, sizes, count and remaining arguments."""

    def __init__(self, ptrs_per_bucket: int):
        self.per = ptrs_per_bucket
        self.calls: list[dict] = []

    def __call__(self, kind, name, device, ptrs, sizes, count, *args):
        self.calls.append({
            "kind": kind, "count": count, "args": args,
            "ptrs": [ptrs[i] for i in range(self.per * count)],
            "sizes": [sizes[i] for i in range(count)]})


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_a_plan_longer_than_the_table_is_split(monkeypatch, quant):
    """Above the table maximum a step takes one entry call per table's
    worth of buckets, each handed its buckets' pointers in order, and each
    counted once in the kernel's launches."""
    limit = tok.ADAM_TABLE_MAX if quant == "off" else tok.ADAM_Q_TABLE_MAX
    per = 4 if quant == "off" else 10
    n = 2 * limit + 3
    rec = _Launches(per)
    card = torch.device("cuda", 0)
    monkeypatch.setattr(tok, "_launch", rec)
    monkeypatch.setattr(tok, "_check_lists", lambda *a, **k: card)
    words = torch.zeros(5 * limit, dtype=torch.int32)
    monkeypatch.setattr(tok._build, "scratch_words",
                        lambda device, n: words[:n])
    ps = [torch.zeros(128 * (1 + i % 3)) for i in range(n)]
    gs = [torch.zeros_like(p) for p in ps]
    ms = [_zero_moment(p.numel(), quant) for p in ps]
    vs = [_zero_moment(p.numel(), quant) for p in ps]
    counter = tok.adam_fp32 if quant == "off" else tok.adam_q
    before = counter.launches
    _call(quant, ps, gs, ms, vs)
    assert counter.launches - before == 3
    assert [c["count"] for c in rec.calls] == [limit, limit, 3]
    rows = ([(p, g, m, v) for p, g, m, v in zip(ps, gs, ms, vs)]
            if quant == "off" else tok._adam_q_rows(ps, gs, ms, vs))
    assert [x for c in rec.calls for x in c["ptrs"]] == [
        t.data_ptr() for row in rows for t in row]
    assert [x for c in rec.calls for x in c["sizes"]] == [
        p.numel() for p in ps]
    if quant != "off":
        # the words, the scalars, then the m codec (0: int8)
        assert all(c["args"][0] == words.data_ptr() for c in rec.calls)
        assert all(c["args"][-1] == 0 for c in rec.calls)
    assert {c["kind"] for c in rec.calls} == {
        "adam_fp32_buckets" if quant == "off" else "adam_q_buckets"}


@pytest.mark.parametrize("quant", ["off", "int8", "fp8"])
def test_fused_apply_takes_every_adam_bucket_in_one_call(monkeypatch, quant):
    """fused_apply hands Adam(W) to its entry once a step, with every
    bucket: adam_fp32_buckets for fp32 moments, adam_q_buckets for
    quantized ones."""
    calls = {"adam_fp32_buckets": [], "adam_q_buckets": []}

    def spy(name):
        entry = getattr(tok, name)

        def run(ps, *args, **kw):
            calls[name].append(len(ps))
            entry(ps, *args, **kw)
        return run

    for name in calls:
        monkeypatch.setattr(tok, name, spy(name))
    params, grads = tfo._gate_world(0)
    tx = tfo.fused_adam(1e-3, weight_decay=0.01, quant=quant, bucket_mb=0.01)
    state = tx.init(params)
    for _ in range(2):
        _, state = tx.fused_apply(grads, state, params)
    used = "adam_fp32_buckets" if quant == "off" else "adam_q_buckets"
    assert len(state.p) > 1
    assert calls[used] == [len(state.p)] * 2
    assert calls["adam_q_buckets" if quant == "off"
                 else "adam_fp32_buckets"] == []
