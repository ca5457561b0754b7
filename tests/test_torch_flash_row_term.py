"""The row term of the flash backward, held against the exact gradient.

The score gradient is dS_ij = p_ij (dP_ij - rt_i) with the row term
rt_i = sum_j p_ij dP_ij, so sum_j dS_ij = 0 and dq_i = scale sum_j dS_ij
k_j does not see the keys' common mean. The JAX package takes rt_i =
rowsum(dO_i * O_i) from the forward's output O rounded to the input
dtype; in bf16 that rounding leaves sum_j dS_ij != 0, and dq picks up the
error times the keys' mean. Where a head's keys and values share one
large component (as trained heads do), that error is of the order of the
true dq. The port (edl_tpu_torch/ops/flash_attention.py, and K3 on the
card) sums rt from p and dP in fp32 instead.

Inputs come from a numpy seed: per head, keys and values are one shared
vector of norm ``key_mean`` plus noise of 0.3 a component; queries and
the output cotangent are standard normal; all rounded to bf16. The exact
dq is fp64 autograd of dense attention on those bf16 values. Bounds:
the port within 5e-3 relative L2 (its output is rounded to bf16, 2^-9
relative); with no shared component the JAX package's dq is as close; at
``key_mean`` 8 its dq is at least 20 times further off than the port's.
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

PORT_REL = 5e-3
JAX_WORSE_BY = 20.0


def _inputs(key_mean, b=1, s=128, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)

    def shared():
        mu = rng.standard_normal((1, 1, h, d))
        mu *= key_mean / np.linalg.norm(mu, axis=-1, keepdims=True)
        return mu + 0.3 * rng.standard_normal((b, s, h, d))

    q = rng.standard_normal((b, s, h, d))
    k, v = shared(), shared()
    do = rng.standard_normal((b, s, h, d))
    return tuple(torch.from_numpy(x.astype(np.float32)).bfloat16()
                 for x in (q, k, v, do))


def _exact_dq(q, k, v, do, causal):
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    s, d = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q64, k64) / d ** 0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v64)
    return torch.autograd.grad(o, q64, do.double())[0].numpy()


def _rel(got, exact):
    return float(np.linalg.norm(got - exact) / np.linalg.norm(exact))


@pytest.fixture(params=["xla_fallback", "pallas_interpret"])
def jax_path(request):
    ctx = (jfa.force_interpret_kernels()
           if request.param == "pallas_interpret"
           else contextlib.nullcontext())
    with ctx:
        yield request.param


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("key_mean", [0.0, 8.0])
def test_dq_against_exact_with_shared_key_component(jax_path, key_mean,
                                                    causal):
    q, k, v, do = _inputs(key_mean)
    exact = _exact_dq(q, k, v, do, causal)

    tq = q.clone().requires_grad_()
    o = tfa.flash_attention(tq, k, v, causal=causal, block_q=64,
                            block_k=64)
    port = torch.autograd.grad(o, tq, do)[0].float().numpy()

    def j_attn(q):
        return jfa.flash_attention(q, jnp.asarray(k.float().numpy(),
                                                  jnp.bfloat16),
                                   jnp.asarray(v.float().numpy(),
                                               jnp.bfloat16),
                                   causal=causal, block_q=64, block_k=64)

    _, vjp = jax.vjp(j_attn, jnp.asarray(q.float().numpy(), jnp.bfloat16))
    (jdq,) = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    jax_dq = np.asarray(jdq.astype(jnp.float32))

    port_rel, jax_rel = _rel(port, exact), _rel(jax_dq, exact)
    assert port_rel <= PORT_REL, port_rel
    if key_mean == 0.0:
        assert jax_rel <= PORT_REL, jax_rel
    else:
        assert jax_rel >= JAX_WORSE_BY * port_rel, (jax_rel, port_rel)
