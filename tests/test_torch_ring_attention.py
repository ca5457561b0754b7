"""Ring attention in the port (``parallel/ring_attention.py``) against
its own dense attention and against the JAX package's ring.

The port's counterparts of ``tests/test_ring_attention.py``: q/k/v (B=2,
S=32, H=4, D=8), drawn from a numpy seed, go round rings of gloo ranks
(``test_torch_world.World``) over the meshes {sp: 2}, {sp: 4} and
{dp: 2, sp: 2}, through both bodies (dense and flash), causal and not.
Each rank returns its block of o and, for the loss sum(o^2), of dq, dk
and dv; the blocks are put back together here.

Tolerances, as the JAX tests state them for the same comparisons: the
ring within 2e-5 of the port's ``dense_attention`` forward; gradients
within 5e-4 (dense body) and 2e-4 (flash body) of the dense gradients.
Against the JAX package's ``ring_attention`` on the same inputs (under
``shard_map`` on as many of conftest's virtual CPU devices): 2e-5
forward and 5e-5 gradients in fp32 (fp32 sums in another order), 3e-2
in bf16 (one bf16 rounding of o, whose entries are below 4).

``ppermute``'s gradient is the cotangent sent back the other way round
the ring: rank r's dx is rank r+1's weight.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world import World, one_torch_thread  # noqa: F401

SHAPE = (2, 32, 4, 8)
MESHES = {2: [{"sp": 2}], 4: [{"sp": 4}, {"dp": 2, "sp": 2}]}
FWD_ATOL = 2e-5
GRAD_ATOL = {"dense": 5e-4, "flash": 2e-4}
JAX_FWD_ATOL, JAX_GRAD_ATOL, BF16_ATOL = 2e-5, 5e-5, 3e-2


def _qkv(seed: int = 0) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))


def _key(axes: dict) -> str:
    return "_".join(f"{k}{v}" for k, v in axes.items())


def _local(mesh, x: np.ndarray) -> np.ndarray:
    """This rank's (batch rows over the data axes, sequence block) of a
    global (B, S, ...) array."""
    bi, bn = mesh.data_index()
    si, sn = mesh.coords.get("sp", 0), mesh.axis_size("sp")
    b, s = x.shape[0] // bn, x.shape[1] // sn
    return x[bi * b:(bi + 1) * b, si * s:(si + 1) * s]


def rank_rings(inputs: dict, directory: Path) -> dict:
    """Every mesh of this world's size, both bodies, causal and not: o and
    the gradients of sum(o^2) (fp32), o in bf16 (causal); and ppermute's
    gradient."""
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v = inputs["q"], inputs["k"], inputs["v"]
    out = {}
    for axes in MESHES[distributed.world_size()]:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(axes))
        for body in ("dense", "flash"):
            for causal in (True, False):
                ts = [torch.from_numpy(np.ascontiguousarray(_local(mesh, a)))
                      .requires_grad_() for a in (q, k, v)]
                o = ring_attention(*ts, mesh=mesh, causal=causal,
                                   use_flash=body == "flash")
                (o ** 2).sum().backward()
                tag = f"{_key(axes)}/{body}/{int(causal)}"
                out[f"{tag}/o"] = o.detach().numpy()
                for name, t in zip("qkv", ts):
                    out[f"{tag}/d{name}"] = t.grad.numpy()
            ts = [torch.from_numpy(np.ascontiguousarray(_local(mesh, a)))
                  .to(torch.bfloat16) for a in (q, k, v)]
            o = ring_attention(*ts, mesh=mesh, use_flash=body == "flash")
            out[f"{_key(axes)}/{body}/bf16/o"] = o.float().numpy()
            out[f"{_key(axes)}/{body}/bf16/dtype"] = np.array(str(o.dtype))
    r = distributed.rank()
    x = torch.full((3,), float(r), requires_grad=True)
    w = torch.arange(3, dtype=torch.float32) + 10 * r
    y = distributed.ppermute(x)
    (y * w).sum().backward()
    out["ppermute/y"] = y.detach().numpy()
    out["ppermute/dx"] = x.grad.numpy()
    out["rank"] = np.array(r)
    return out


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """Worlds of 2 and 4 ranks, started together."""
    q, k, v = _qkv()
    worlds = {n: World("test_torch_ring_attention:rank_rings", n,
                       tmp_path_factory.mktemp(f"ring{n}"),
                       {"q": q, "k": k, "v": v}) for n in (2, 4)}
    return {n: w.results() for n, w in worlds.items()}


def _assemble(results: list[dict], axes: dict, key: str) -> np.ndarray:
    """The global (B, S, ...) array from the ranks' local blocks."""
    from edl_tpu_torch.parallel import mesh as mesh_lib

    grid = np.arange(len(results)).reshape(tuple(axes.values()))
    full = None
    for r, res in enumerate(results):
        mesh = mesh_lib.Mesh(grid, tuple(axes), rank=r)
        part = res[key]
        if full is None:
            bn, sn = mesh.data_index()[1], mesh.axis_size("sp")
            full = np.zeros((part.shape[0] * bn, part.shape[1] * sn)
                            + part.shape[2:], part.dtype)
        bi = mesh.data_index()[0]
        si = mesh.coords.get("sp", 0)
        b, s = part.shape[:2]
        full[bi * b:(bi + 1) * b, si * s:(si + 1) * s] = part
    return full


def _all_meshes():
    return [(n, axes) for n in (2, 4) for axes in MESHES[n]]


def _dense_ref(causal: bool, dtype=torch.float32):
    """The port's dense attention of the whole arrays and its gradients of
    sum(o^2)."""
    from edl_tpu_torch.parallel.ring_attention import dense_attention

    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in _qkv()]
    o = dense_attention(*ts, causal=causal)
    (o.float() ** 2).sum().backward()
    return o.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("body", ["dense", "flash"])
@pytest.mark.parametrize("n,axes", _all_meshes())
def test_ring_matches_dense(rings, n, axes, body, causal):
    o_ref, g_ref = _dense_ref(causal)
    tag = f"{_key(axes)}/{body}/{int(causal)}"
    np.testing.assert_allclose(_assemble(rings[n], axes, f"{tag}/o"), o_ref,
                               rtol=FWD_ATOL, atol=FWD_ATOL)
    for name, g in zip("qkv", g_ref):
        np.testing.assert_allclose(
            _assemble(rings[n], axes, f"{tag}/d{name}"), g,
            rtol=GRAD_ATOL[body], atol=GRAD_ATOL[body])


@pytest.mark.parametrize("body", ["dense", "flash"])
@pytest.mark.parametrize("n,axes", _all_meshes())
def test_ring_bf16_runs_close_to_dense(rings, n, axes, body):
    o_ref, _ = _dense_ref(True, torch.bfloat16)
    got = _assemble(rings[n], axes, f"{_key(axes)}/{body}/bf16/o")
    assert all(str(r[f"{_key(axes)}/{body}/bf16/dtype"]) == "torch.bfloat16"
               for r in rings[n])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, o_ref, atol=BF16_ATOL)


def test_ppermute_sends_forward_and_its_gradient_back(rings):
    for n in (2, 4):
        for r, res in enumerate(rings[n]):
            np.testing.assert_array_equal(res["ppermute/y"],
                                          np.full(3, (r - 1) % n, np.float32))
            want = np.arange(3, dtype=np.float32) + 10 * ((r + 1) % n)
            np.testing.assert_array_equal(res["ppermute/dx"], want)


@pytest.fixture(scope="module")
def jax_rings():
    """The JAX package's ring_attention on the same inputs: o and the
    gradients of sum(o^2) in fp32, and o in bf16, for each mesh and body
    (causal)."""
    import jax
    import jax.numpy as jnp

    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.parallel import ring_attention as jra

    q, k, v = (jnp.asarray(a) for a in _qkv())
    out = {}
    for n, axes in _all_meshes():
        mesh = jmesh.make_mesh(jmesh.MeshSpec(axes), n_devices=n)
        for body in ("dense", "flash"):
            def loss(q, k, v, mesh=mesh, body=body):
                o = jra.ring_attention(q, k, v, mesh=mesh,
                                       use_flash=body == "flash")
                return jnp.sum(o ** 2), o

            (_, o), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
            tag = f"{_key(axes)}/{body}"
            out[f"{tag}/o"] = np.asarray(o)
            for name, g in zip("qkv", grads):
                out[f"{tag}/d{name}"] = np.asarray(g)
            o16 = jax.jit(lambda q, k, v, mesh=mesh, body=body:
                          jra.ring_attention(q, k, v, mesh=mesh,
                                             use_flash=body == "flash"))(
                *(x.astype(jnp.bfloat16) for x in (q, k, v)))
            out[f"{tag}/bf16"] = np.asarray(o16.astype(jnp.float32))
    return out


@pytest.mark.parametrize("body", ["dense", "flash"])
@pytest.mark.parametrize("n,axes", _all_meshes())
def test_ring_matches_the_jax_ring(rings, jax_rings, n, axes, body):
    tag = f"{_key(axes)}/{body}"
    np.testing.assert_allclose(_assemble(rings[n], axes, f"{tag}/1/o"),
                               jax_rings[f"{tag}/o"], rtol=JAX_FWD_ATOL,
                               atol=JAX_FWD_ATOL)
    for name in "qkv":
        np.testing.assert_allclose(
            _assemble(rings[n], axes, f"{tag}/1/d{name}"),
            jax_rings[f"{tag}/d{name}"], rtol=JAX_GRAD_ATOL,
            atol=JAX_GRAD_ATOL)
    np.testing.assert_allclose(_assemble(rings[n], axes, f"{tag}/bf16/o"),
                               jax_rings[f"{tag}/bf16"], atol=BF16_ATOL)


def test_a_ring_of_one_is_dense_attention():
    from edl_tpu_torch.parallel.ring_attention import (dense_attention,
                                                       ring_attention)

    q, k, v = (torch.from_numpy(a) for a in _qkv())
    want = dense_attention(q, k, v)
    for flash in (False, True):
        got = ring_attention(q, k, v, use_flash=flash)
        torch.testing.assert_close(got, want, rtol=FWD_ATOL, atol=FWD_ATOL)
