"""K8's plain version and the int8 wires against the JAX package's
(``edl_tpu/ops/pack.py``).

On a CPU tensor ``pack_int8`` runs its plain version, the same
expressions as the JAX package's ``_pack_xla``: its q and scale bits
equal JAX's, and those of JAX's Pallas kernel run in interpret mode, on
fp32 shards of length 1, 127, 128, 200 and 4099, an all-zero shard, a
shard with a pinned abs-max element, exact half-steps of the scale
(round half to even) and subnormals beside a normal abs-max. A shard
whose every element is subnormal is where the two differ by design: XLA
flushes subnormals to zero (the port keeps them, as its kernel is built
-ftz=false), pinned here so the divergence stays a known one. bf16 input
follows JAX's kernel path (a cast to fp32 first), not its XLA path.
The wires (``all_gather_int8``, ``all_to_all_int8``) in worlds of ranks:
tests/test_torch_comm.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import pack as jpack
from edl_tpu_torch.ops import pack
from test_torch_world import one_torch_thread  # noqa: F401


def _shards() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    out = {f"len{n}": rng.normal(size=n).astype(np.float32)
           for n in (1, 127, 128, 200, 4099)}
    out["zero"] = np.zeros(300, np.float32)
    pinned = rng.normal(0, 0.1, size=1000).astype(np.float32)
    pinned[333] = -4.0          # x / scale lands on the clip edge
    out["pinned_amax"] = pinned
    # amax 127 -> scale exactly 1; amax 254 -> scale 2: exact half-steps
    out["half_steps_1"] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                    126.5, -125.5, 3.5], np.float32)
    out["half_steps_2"] = np.array([-254.0, 1.0, 3.0, 5.0, -1.0, -3.0, 7.0,
                                    251.0], np.float32)
    sub = np.array([1e-40, -3e-39, 1e-45, 5e-39], np.float32)
    out["subnormals"] = np.concatenate([sub, [0.75, -1.0, 0.0]]).astype(
        np.float32)
    return out


SHARDS = _shards()


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", sorted(SHARDS))
def test_pack_plain_bitwise_with_jax_xla(name):
    x = SHARDS[name]
    q, scale = pack.pack_int8(torch.from_numpy(x))
    jq, js = jpack._pack_xla(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == x.shape and scale.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(js))


@pytest.mark.parametrize("name", sorted(SHARDS))
def test_pack_plain_bitwise_with_jax_pallas_interpret(name, monkeypatch):
    """q bit for bit; the scale too, except where JAX's interpret mode
    itself leaves its XLA path: it multiplies amax by the rounded 1/127
    where ``_pack_xla`` (and the port) divide, one ulp apart on some
    shards (len127 here). There the port's scale is the true quotient."""
    x = SHARDS[name]
    q, scale = pack.pack_int8(torch.from_numpy(x))
    monkeypatch.setattr(jpack, "_FORCE_INTERPRET", True)
    jq, js = jpack.pack_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    if _bits(scale.numpy()) != _bits(js):
        amax = np.float32(np.abs(x).max())
        assert _bits(scale.numpy()) == _bits(amax / np.float32(127))
        assert _bits(js) == _bits(amax * np.float32(1 / 127))
        assert abs(int(_bits(js)) - int(_bits(scale.numpy()))) == 1


def test_half_steps_round_to_even():
    q, scale = pack.pack_int8(torch.from_numpy(SHARDS["half_steps_1"]))
    assert float(scale) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4]


def test_all_subnormal_shard_is_the_known_divergence():
    """XLA flushes subnormals (scale 1.0, q 0); the port keeps them and
    still round-trips within half a scale step."""
    x = np.array([1e-40, -3e-39, 2e-45, 5e-39], np.float32)
    jq, js = jpack._pack_xla(jnp.asarray(x))
    assert float(js) == 1.0 and not np.asarray(jq).any()
    q, scale = pack.pack_int8(torch.from_numpy(x))
    assert 0.0 < float(scale) < np.finfo(np.float32).tiny
    assert q.abs().max() == 127
    err = (pack.unpack_int8(q, scale) - torch.from_numpy(x)).abs().max()
    assert float(err) <= float(scale) / 2


def test_bf16_input_follows_the_jax_kernel_path(monkeypatch):
    rng = np.random.default_rng(3)
    x32 = rng.normal(size=517).astype(np.float32)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    q, scale = pack.pack_int8(x)
    monkeypatch.setattr(jpack, "_FORCE_INTERPRET", True)
    jq, js = jpack.pack_int8(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(js))


@pytest.mark.parametrize("name", ["len4099", "pinned_amax", "zero"])
def test_unpack_round_trip(name):
    x = torch.from_numpy(SHARDS[name])
    q, scale = pack.pack_int8(x)
    back = pack.unpack_int8(q, scale)
    jback = jpack.unpack_int8(*jpack._pack_xla(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(jback))
    assert float((back - x).abs().max()) <= float(scale) / 2
    if name == "zero":
        assert float(scale) == 1.0 and not back.any()


def test_pack_on_cpu_launches_no_kernel():
    before = pack.pack_int8.launches
    pack.pack_int8(torch.ones(10))
    assert pack.pack_int8.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        pack.pack_int8(torch.ones(10, device="meta"))
