"""The port's plain flash backward against the JAX package's Pallas
backward kernels (`_bwd_pallas`: dK/dV and dQ) run in interpret mode,
on the same inputs and (o, lse), with and without a dlse cotangent.
Bounds as tests/test_torch_flash_backward.py: 5e-5 fp32, 3e-2 bf16."""

import pytest

from test_torch_flash_backward import plain_vs_jax


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_dlse", [False, True])
def test_plain_backward_matches_jax_pallas_kernels(with_dlse, causal, dtype):
    plain_vs_jax("pallas_interpret", with_dlse, causal, dtype)
