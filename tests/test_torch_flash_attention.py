"""The port's flash attention forward (edl_tpu_torch/ops/flash_attention.py)
against the JAX package's.

On the CPU the port runs its plain version (the blockwise scan); the JAX
side runs through both of its off-TPU dispatch modes: the XLA blockwise
fallback, and the Pallas kernel in interpret mode under
`force_interpret_kernels()`. Inputs come from a numpy seed. Bounds are
those of tests/test_flash_attention.py: 2e-5 fp32, 3e-2 bf16 (the bf16
outputs round once more, on each side, after an fp32 computation).
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu_torch.ops import _build

# the modules, not the same-named functions their packages may export
jfa = importlib.import_module("edl_tpu.ops.flash_attention")
tfa = importlib.import_module("edl_tpu_torch.ops.flash_attention")

ATOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 3e-2}


def _qkv(b=2, s=256, h=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _both(arrays, dtype):
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture(params=["xla_fallback", "pallas_interpret"])
def jax_path(request):
    ctx = (jfa.force_interpret_kernels()
           if request.param == "pallas_interpret"
           else contextlib.nullcontext())
    with ctx:
        yield request.param


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax(jax_path, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(), dtype)
    jo, jlse = jfa.flash_attention_lse(jq, jk, jv, causal=causal,
                                       block_q=128, block_k=128)
    to, tlse = tfa.flash_attention_lse(tq, tk, tv, causal=causal,
                                       block_q=128, block_k=128)
    assert to.dtype == getattr(torch, dtype)
    assert tlse.dtype == torch.float32 and tlse.shape == (2, 256, 4)
    np.testing.assert_allclose(_np(to), _np(jo), atol=ATOL[dtype])
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=ATOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_fp16_matches_jax(jax_path, causal):
    """fp16 (lm_train --fp16): the plain version computes in fp32 and
    rounds o to fp16, as the JAX function does; held at the bf16 bound."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(seed=5), "float16")
    jo, jlse = jfa.flash_attention_lse(jq, jk, jv, causal=causal,
                                       block_q=128, block_k=128)
    to, tlse = tfa.flash_attention_lse(tq, tk, tv, causal=causal,
                                       block_q=128, block_k=128)
    assert to.dtype == torch.float16 and jo.dtype == jnp.float16
    assert tlse.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), atol=ATOL["float16"])
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=ATOL["float16"])


@pytest.mark.parametrize("s,block_q,block_k", [(256, 128, 256),
                                               (256, 256, 128),
                                               (128, 512, 512)])
def test_uneven_and_clamped_blocks(jax_path, s, block_q, block_k):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s=s, seed=1), "float32")
    jo, jlse = jfa.flash_attention_lse(jq, jk, jv, block_q=block_q,
                                       block_k=block_k)
    to, tlse = tfa.flash_attention_lse(tq, tk, tv, block_q=block_q,
                                       block_k=block_k)
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5)
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=2e-5)


def test_custom_scale_and_flash_attention_output():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s=128, seed=2), "float32")
    jo = jfa.flash_attention(jq, jk, jv, scale=0.05)
    to = tfa.flash_attention(tq, tk, tv, scale=0.05)
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5)


@pytest.mark.parametrize("s,want", [(128, 512), (256, 128), (640, 512),
                                    (1024, 512), (384, 256), (200, 512),
                                    (200, 128), (96, 64), (520, 512)])
def test_fit_block_agrees(s, want):
    try:
        expect = jfa._fit_block(s, want)
    except ValueError as exc:
        with pytest.raises(ValueError, match="divisible"):
            tfa._fit_block(s, want)
        assert "divisible" in str(exc)
        return
    assert tfa._fit_block(s, want) == expect


def test_shape_and_block_validation():
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(s=128))
    with pytest.raises(ValueError, match="mismatch"):
        tfa.flash_attention(tq, tk[:, :64], tv)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(tq, tk, tv, block_q=96)


def test_no_quiet_fallback_off_cpu():
    """A tensor on neither CPU nor CUDA raises; it is never computed by
    the plain version somewhere else."""
    q = torch.empty((1, 128, 2, 32), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention(q, q, q)


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """A build that cannot run raises RuntimeError: no fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises((RuntimeError, OSError)):
        _build.load("flash_fwd")
    assert not list(tmp_path.glob("*.so"))


def test_cpu_launches_no_kernel():
    before = tfa.flash_attention_lse.launches
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(s=128))
    tfa.flash_attention(tq, tk, tv)
    assert tfa.flash_attention_lse.launches == before


def _cases_rejected_before_launch():
    f32 = torch.zeros((1, 128, 2, 64))
    bf = f32.to(torch.bfloat16)
    odd = torch.zeros((1, 128, 2, 70), dtype=torch.bfloat16)[..., :64]
    return [
        ((f32.double(),) * 3, {}, TypeError, "fp32 or bf16"),
        ((bf, bf, f32), {}, TypeError, "mismatch"),
        ((torch.zeros((1, 128, 2, 48)),) * 3, {}, ValueError, "head dims"),
        ((f32.transpose(2, 3),) * 3, {}, ValueError, "head dims|contiguous"),
        ((odd,) * 3, {}, ValueError, "16-byte"),
    ]


def test_kernel_wrapper_takes_fp16_with_the_16_bit_checks():
    """fp16 passes the dtype check (dtype code 2: the wgmma body compiled
    for fp16) and meets the 16-byte row check of the TMA copies."""
    assert tfa._DTYPE_CODES[torch.float16] == 2
    half = torch.zeros((1, 128, 2, 64), dtype=torch.float16)
    tfa._check_kernel_inputs("flash_fwd", half, half, half)
    odd = torch.zeros((1, 128, 2, 70), dtype=torch.float16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_kernel_inputs("flash_fwd", odd, odd, odd)
    with pytest.raises(TypeError, match="mismatch"):
        tfa._check_kernel_inputs("flash_fwd", half, half,
                                 half.to(torch.bfloat16))


@pytest.mark.parametrize("args,kw,exc,match", _cases_rejected_before_launch())
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(args, kw, exc,
                                                              match):
    """The CUDA wrapper validates dtype, head dim, layout and (for bf16,
    which runs on the tensor cores) 16-byte rows before it builds or
    launches."""
    with pytest.raises(exc, match=match):
        tfa._fwd_cuda(*args, scale=0.125, causal=True, **kw)
