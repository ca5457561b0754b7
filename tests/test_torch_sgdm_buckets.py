"""K4's entry over every bucket of a step
(``edl_tpu_torch.ops.opt_kernels.sgdm_fp32_buckets``) against the JAX
package's per-bucket ``edl_tpu.ops.opt_kernels.sgdm_bucket``, on the CPU.

On a CPU tensor the entry runs its plain version, ``_sgdm_plain`` bucket
by bucket; on a card it is one K4 launch over a table of the buckets,
held bit for bit against the same plain version by chip_smoke.py. The
JAX side runs op by op (``jax.disable_jit``): jitted, XLA contracts the
update's multiply-adds into fmas, one rounding away from the plain
version. Op by op the two agree bit for bit, so the bound here is
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import opt_kernels as jok
from edl_tpu_torch.ops import opt_kernels as tok
from edl_tpu_torch.train import fused_opt as tfo


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
    tx = tfo.fused_sgd(0.1, 0.9, 1e-4, bucket_mb=0.01)
    state = tx.init(params)
    g_bufs = tfo._grad_buckets(tx.plan(params), [p for _, p in params],
                               grads)
    return [p.detach().clone() for p in state.p], g_bufs


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_buckets_match_jax_bucket_by_bucket_bitwise(wd):
    p_bufs, g_bufs = _ragged_plan()
    sizes = [p.numel() for p in p_bufs]
    assert len(p_bufs) >= 4 and max(sizes) > 2 * min(sizes)
    assert all(n % 128 == 0 for n in sizes)
    jp = [jnp.asarray(p.numpy()) for p in p_bufs]
    jm = [jnp.zeros_like(x) for x in jp]
    tp = [p.clone() for p in p_bufs]
    tm = [torch.zeros_like(p) for p in p_bufs]
    launches = tok.sgdm_fp32.launches
    for step in range(3):
        lr = float(np.float32(0.1 * (step + 1) / 3))
        with jax.disable_jit():
            for i, g in enumerate(g_bufs):
                jp[i], jm[i] = jok.sgdm_bucket(
                    jp[i], jnp.asarray(g.numpy()), jm[i], lr, mu=0.9, wd=wd)
        tok.sgdm_fp32_buckets(tp, g_bufs, tm, lr, mu=0.9, wd=wd)
        for a, b in zip(jp + jm, tp + tm):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    # the plain version on the CPU: no kernel launched
    assert tok.sgdm_fp32.launches == launches
    # the zero padding of every bucket stays zero
    assert all(p.abs().sum() > 0 for p in tp)


def test_buckets_equal_the_per_bucket_entry():
    """One call over the plan equals sgdm_bucket on each bucket in turn
    (the per-bucket API the JAX package mirrors)."""
    p_bufs, g_bufs = _ragged_plan(seed=3)
    a = [p.clone() for p in p_bufs]
    b = [p.clone() for p in p_bufs]
    ma = [torch.full_like(p, 0.01) for p in p_bufs]
    mb = [m.clone() for m in ma]
    tok.sgdm_fp32_buckets(a, g_bufs, ma, 0.05, mu=0.9, wd=1e-4)
    for p, g, m in zip(b, g_bufs, mb):
        tok.sgdm_bucket(p, g, m, 0.05, mu=0.9, wd=1e-4)
    for x, y in zip(a + ma, b + mb):
        assert tfo.bitwise_equal(x, y)


def test_buckets_refuse_what_the_kernel_does_not_take():
    z = [torch.zeros(256), torch.zeros(128)]
    with pytest.raises(ValueError, match="as many"):
        tok.sgdm_fp32_buckets(z, z[:1], z, 0.1, mu=0.9, wd=0.0)
    with pytest.raises(ValueError, match="one or more"):
        tok.sgdm_fp32_buckets([], [], [], 0.1, mu=0.9, wd=0.0)
    with pytest.raises(ValueError, match="one length"):
        tok.sgdm_fp32_buckets(z, [z[1], z[0]], z, 0.1, mu=0.9, wd=0.0)
    with pytest.raises(ValueError, match="multiple of 128"):
        odd = [torch.zeros(100)]
        tok.sgdm_fp32_buckets(odd, odd, odd, 0.1, mu=0.9, wd=0.0)
    shifted = torch.zeros(260)[1:257]          # 4 bytes past an aligned base
    with pytest.raises(ValueError, match="16-byte aligned"):
        tok.sgdm_fp32_buckets([shifted], [z[0]], [z[0]], 0.1, mu=0.9,
                              wd=0.0)
    with pytest.raises(TypeError, match="fp32"):
        h = [torch.zeros(128, dtype=torch.float16)]
        tok.sgdm_fp32_buckets(h, h, h, 0.1, mu=0.9, wd=0.0)
    meta = torch.zeros(128, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        tok.sgdm_fp32_buckets([z[1], meta], [z[1], meta], [z[1], meta], 0.1,
                              mu=0.9, wd=0.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tok.sgdm_fp32_buckets([meta], [meta], [meta], 0.1, mu=0.9, wd=0.0)


def test_fused_apply_takes_every_sgdm_bucket_in_one_call(monkeypatch):
    """fused_apply hands momentum-SGD with fp32 momentum to the entry
    once a step, with every bucket; the quantized modes go to their own
    entry (tests/test_torch_sgdm_q_buckets.py)."""
    calls = []
    entry = tok.sgdm_fp32_buckets

    def spy(ps, gs, ms, lr, **kw):
        calls.append(len(ps))
        entry(ps, gs, ms, lr, **kw)

    monkeypatch.setattr(tok, "sgdm_fp32_buckets", spy)
    for quant, want in (("off", 1), ("int8", 0)):
        calls.clear()
        params, grads = tfo._gate_world(0)
        tx = tfo.fused_sgd(0.1, 0.9, 1e-4, quant=quant, bucket_mb=0.01)
        state = tx.init(params)
        for _ in range(2):
            _, state = tx.fused_apply(grads, state, params)
        assert len(calls) == 2 * want
        assert all(n == len(state.p) for n in calls)
