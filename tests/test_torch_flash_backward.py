"""The port's flash attention backward (edl_tpu_torch/ops/flash_attention.py)
against the JAX package's.

On the CPU the port runs its plain version, `_bwd_blockwise` (the CUDA
kernels K2/K3 are held against it on the card by chip_smoke.py). The
JAX side runs its XLA `_bwd_blockwise` and its Pallas kernels
(`_bwd_pallas`) in interpret mode, and for the gradient through the
public API both of its off-TPU dispatch modes. Inputs come from a numpy
seed. Bounds are tests/test_flash_attention.py's: 5e-5 for fp32
gradients; 3e-2 for bf16 (inputs and outputs rounded to bf16 on each
side around an fp32 computation).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("edl_tpu.ops.flash_attention")
tfa = importlib.import_module("edl_tpu_torch.ops.flash_attention")

ATOL = {"float32": 5e-5, "bfloat16": 3e-2}


def _arrays(b=2, s=128, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((b, s, h)).astype(np.float32)
    return q, k, v, do, dlse


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_jax_rows(x):
    """(B, S, H) -> the JAX package's internal (B*H, S) layout."""
    b, s, h = x.shape
    return jnp.asarray(np.ascontiguousarray(
        np.asarray(x).transpose(0, 2, 1)).reshape(b * h, s))


def plain_vs_jax(jax_bwd, with_dlse, causal, dtype):
    """The port's `_bwd_blockwise` against the JAX package's backward
    ``jax_bwd`` ("xla_blockwise" or "pallas_interpret") on the same
    (o, lse), with or without a dlse cotangent."""
    q, k, v, do, dlse = _arrays()
    scale = 1.0 / q.shape[-1] ** 0.5
    tq, tk, tv, tdo = (torch.from_numpy(a).to(getattr(torch, dtype))
                       for a in (q, k, v, do))
    # both sides differentiate the same (o, lse): the port's forward
    to, tlse = tfa._fwd_blockwise(tq, tk, tv, blk=64, scale=scale,
                                  causal=causal)
    got = tfa._bwd_blockwise(tq, tk, tv, tlse, tdo, blk=64,
                             scale=scale, causal=causal,
                             dlse=torch.from_numpy(dlse) if with_dlse
                             else None)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jo = jnp.asarray(_np(to), jdt)
    jlse = _to_jax_rows(tlse.numpy())
    jdlse = _to_jax_rows(dlse) if with_dlse else None
    if jax_bwd == "xla_blockwise":
        want = jfa._bwd_blockwise(jq, jk, jv, jo, jlse, jdo, blk=32,
                                  scale=scale, causal=causal, dlse=jdlse)
    else:
        want = jfa._bwd_pallas(jq, jk, jv, jo, jlse, jdo, blk_q=64,
                               blk_k=32, scale=scale, causal=causal,
                               dlse=jdlse, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and g.shape == tq.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_dlse", [False, True])
def test_plain_backward_matches_jax_blockwise(with_dlse, causal, dtype):
    plain_vs_jax("xla_blockwise", with_dlse, causal, dtype)


@pytest.fixture(params=["xla_fallback", "pallas_interpret"])
def jax_path(request):
    ctx = (jfa.force_interpret_kernels()
           if request.param == "pallas_interpret"
           else contextlib.nullcontext())
    with ctx:
        yield request.param


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_through_both_outputs_matches_jax_grad(jax_path, causal):
    """torch.autograd.grad through flash_attention_lse, with a loss on o
    AND lse (so both cotangents flow), against jax.grad."""
    q, k, v, _, _ = _arrays(h=1, seed=3)

    def j_loss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, causal=causal,
                                         block_q=64, block_k=64)
        return jnp.sum(jnp.sin(o)) + jnp.sum(jnp.cos(lse))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = tfa.flash_attention_lse(tq, tk, tv, causal=causal,
                                     block_q=64, block_k=64)
    got = torch.autograd.grad(o.sin().sum() + lse.cos().sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=5e-5)


def test_flash_attention_grad_with_lse_unused_matches_jax():
    """`flash_attention` drops lse: its cotangent is undefined on the
    port's side, zero on JAX's, and both fold it away."""
    q, k, v, _, _ = _arrays(s=128, seed=4)
    want = jax.grad(lambda q: jnp.sum(jfa.flash_attention(
        q, jnp.asarray(k), jnp.asarray(v)) ** 2))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    out = tfa.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v))
    (got,) = torch.autograd.grad((out ** 2).sum(), (tq,))
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5)


def test_cpu_backward_launches_no_kernel():
    counts = (tfa.flash_attention_lse.launches, tfa.flash_bwd_dkdv.launches,
              tfa.flash_bwd_dq.launches)
    q, k, v, _, _ = _arrays(s=128)
    tq = torch.from_numpy(q).requires_grad_()
    tfa.flash_attention(tq, torch.from_numpy(k),
                        torch.from_numpy(v)).sum().backward()
    assert tq.grad is not None
    assert (tfa.flash_attention_lse.launches, tfa.flash_bwd_dkdv.launches,
            tfa.flash_bwd_dq.launches) == counts


def _bwd_rejected():
    f32 = torch.zeros((1, 128, 2, 64))
    bf = f32.to(torch.bfloat16)
    return [
        ((f32.half(),) * 4, TypeError, "fp32 or bf16"),
        ((bf, bf, f32, bf), TypeError, "mismatch"),
        ((torch.zeros((1, 128, 2, 48)),) * 4, ValueError, "head dims"),
    ]


@pytest.mark.parametrize("args,exc,match", _bwd_rejected())
def test_backward_wrapper_rejects_what_the_kernels_do_not_take(args, exc,
                                                               match):
    """The CUDA backward validates dtype and head dim before it builds or
    launches anything."""
    q, k, v, do = args
    with pytest.raises(exc, match=match):
        tfa._bwd_cuda(q, k, v, torch.zeros(q.shape[:3]), do, scale=0.125,
                      causal=True)
