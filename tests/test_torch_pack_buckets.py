"""K8's entry over every shard of a step
(``edl_tpu_torch.ops.pack.pack_int8_buckets``) against the JAX package's
pack (``edl_tpu/ops/pack.py``), and the comm step's phased reduction
(``train/comm._reduce_buckets``, one pack call over every int8 leg)
against the bucket-by-bucket one, on the CPU.

On CPU tensors the entry runs its plain version, ``_pack_plain``, shard
by shard; on a card it is K8's memset and two passes over a table of the
shards, held bit for bit against the same plain version by
chip_smoke.py. One table here holds tests/test_torch_pack.py's grid
(lengths 1 to 4099, all-zero, a pinned abs-max, exact half-steps,
subnormals beside a normal abs-max), a 3-element shard and a shard whose
every element is subnormal. Each shard's q and scale equal JAX's XLA
path bit for bit, and its Pallas kernel's in interpret mode (q bit for
bit; the scale too, except where interpret mode multiplies amax by the
rounded 1/127 instead of dividing, one ulp away: tests/test_torch_pack.py).
The all-subnormal shard is the known divergence: XLA flushes subnormals
(scale 1.0, q 0), the port keeps them.

In a world of 2 gloo ranks (tests/test_torch_world.py's harness), the
comm step's ``_reduce`` over a plan with a bucket under
``min_compress_elems`` gives bit for bit the reduced gradients and
residuals of ``_reduce_bucket`` applied bucket by bucket, for compress
int8, top-k and off (flat, and as two slices of one rank), with one pack
call a step over every int8 leg.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import pack as jpack
from edl_tpu_torch.ops import pack
from test_torch_pack import SHARDS
from test_torch_world import as_json, one_torch_thread, run_world  # noqa: F401

GRID = {**SHARDS, "len3": np.array([0.25, -3.0, 1.5], np.float32)}
ALL_SUBNORMAL = np.array([1e-40, -3e-39, 2e-45, 5e-39], np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def table():
    """One pack_int8_buckets call over the grid and the all-subnormal
    shard: {name: (q, scale)}."""
    names = sorted(GRID) + ["all_subnormal"]
    xs = [torch.from_numpy(GRID[n]) for n in sorted(GRID)]
    xs.append(torch.from_numpy(ALL_SUBNORMAL))
    before = pack.pack_int8.launches
    out = pack.pack_int8_buckets(xs)
    assert pack.pack_int8.launches == before   # the plain version
    return dict(zip(names, out))


@pytest.mark.parametrize("name", sorted(GRID))
def test_table_matches_jax_xla_shard_by_shard(table, name):
    q, scale = table[name]
    jq, js = jpack._pack_xla(jnp.asarray(GRID[name]))
    assert q.dtype == torch.int8 and q.shape == GRID[name].shape
    assert scale.dim() == 0 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(js))


@pytest.mark.parametrize("name", sorted(GRID))
def test_table_matches_jax_pallas_interpret_shard_by_shard(table, name,
                                                           monkeypatch):
    x = GRID[name]
    q, scale = table[name]
    monkeypatch.setattr(jpack, "_FORCE_INTERPRET", True)
    jq, js = jpack.pack_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    if _bits(scale.numpy()) != _bits(js):
        amax = np.float32(np.abs(x).max())
        assert _bits(scale.numpy()) == _bits(amax / np.float32(127))
        assert _bits(js) == _bits(amax * np.float32(1 / 127))


def test_all_subnormal_shard_in_a_table_is_the_known_divergence(table):
    q, scale = table["all_subnormal"]
    pq, ps = pack._pack_plain(torch.from_numpy(ALL_SUBNORMAL))
    assert torch.equal(q, pq) and _bits(scale.numpy()) == _bits(ps.numpy())
    jq, js = jpack._pack_xla(jnp.asarray(ALL_SUBNORMAL))
    assert float(js) == 1.0 and not np.asarray(jq).any()
    assert 0.0 < float(scale) < np.finfo(np.float32).tiny


@pytest.mark.parametrize("name", ["len1", "len3", "pinned_amax", "zero"])
def test_pack_int8_is_the_one_shard_case(name):
    x = torch.from_numpy(GRID[name])
    q, scale = pack.pack_int8(x)
    (bq, bs), = pack.pack_int8_buckets([x])
    assert torch.equal(q, bq) and _bits(scale.numpy()) == _bits(bs.numpy())


def test_outputs_are_views_of_one_buffer():
    """On the card every payload and scale is a view of one flat int8
    buffer and one fp32 vector, in the shards' order, each payload shaped
    as its shard."""
    xs = [torch.zeros(5), torch.zeros(2, 3), torch.zeros(1)]
    qs, scales = pack._outputs(xs)
    assert [q.shape for q in qs] == [x.shape for x in xs]
    base = qs[0].data_ptr()
    assert [q.data_ptr() - base for q in qs] == [0, 5, 11]
    assert all(q.is_contiguous() and q.dtype == torch.int8 for q in qs)
    assert [s.data_ptr() - scales[0].data_ptr() for s in scales] == [0, 4, 8]
    assert all(s.dim() == 0 and s.dtype == torch.float32 for s in scales)


def test_table_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="one or more"):
        pack.pack_int8_buckets([])
    with pytest.raises(ValueError, match="non-empty"):
        pack.pack_int8_buckets([torch.ones(3), torch.ones(0)])
    meta = torch.ones(4, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        pack.pack_int8_buckets([torch.ones(4), meta])
    with pytest.raises(ValueError, match="cpu or cuda"):
        pack.pack_int8_buckets([meta])
    # what the kernel refuses, as a CUDA shard would be
    for bad, err in ((torch.ones(8, dtype=torch.bfloat16), TypeError),
                     (torch.ones(16)[::2], ValueError),
                     (torch.ones(0), ValueError)):
        with pytest.raises(err):
            pack._check_shards([torch.ones(4), bad], kernel=True)
        with pytest.raises(err):
            pack.pack_int8_pass([bad], [bad], [bad], which=0)
    with pytest.raises(ValueError, match="CUDA shards"):
        pack.pack_int8_pass([torch.ones(4)], [torch.ones(4)],
                            [torch.ones(())], which=1)


def test_a_table_longer_than_the_maximum_is_split(monkeypatch):
    """Above PACK_TABLE_MAX shards a call takes one entry call per
    table's worth, each handed its shards' x, q and scale pointers in
    order, their lengths and the words, and each counted once."""
    limit = pack.PACK_TABLE_MAX
    calls = []

    def call(kind, device, ptrs, sizes, count, *args):
        calls.append({"kind": kind, "count": count, "args": args,
                      "ptrs": [ptrs[i] for i in range(3 * count)],
                      "sizes": [sizes[i] for i in range(count)]})

    card = torch.device("cuda", 0)
    words = torch.zeros(limit, dtype=torch.int32)
    monkeypatch.setattr(pack, "_call", call)
    monkeypatch.setattr(pack, "_check_shards", lambda xs, kernel=False: card)
    monkeypatch.setattr(pack._build, "scratch_words",
                        lambda device, n: words[:n])
    xs = [torch.ones(1 + i % 5) for i in range(2 * limit + 3)]
    before = pack.pack_int8.launches
    out = pack.pack_int8_buckets(xs)
    assert pack.pack_int8.launches - before == 3
    assert [c["count"] for c in calls] == [limit, limit, 3]
    assert [c["kind"] for c in calls] == ["buckets"] * 3
    assert all(c["args"] == (words.data_ptr(),) for c in calls)
    assert [x for c in calls for x in c["sizes"]] == [x.numel() for x in xs]
    assert [x for c in calls for x in c["ptrs"]] == [
        t.data_ptr() for x, (q, s) in zip(xs, out) for t in (x, q, s)]


# -- the phased reduction in a world of two ----------------------------------

# leaf lengths: 0.0005 MiB buckets (131 fp32) at align 2 put the 40-element
# leaves together and the 24-element one alone, under min_compress_elems
LEAVES = (300, 40, 40, 130, 24, 517)
MODES = ("int8", "topk", "off", "off_sliced")


@pytest.fixture(scope="module")
def phased_world(tmp_path_factory):
    rng = np.random.default_rng(8)
    inputs = {"leaves": np.array(list(LEAVES)),
              "modes": np.array(json.dumps(MODES))}
    for r in range(2):
        for i, n in enumerate(LEAVES):
            inputs[f"g{r}_{i}"] = rng.normal(0, 1e-2, n).astype(np.float32)
    return run_world("phased_reduce", 2,
                     tmp_path_factory.mktemp("phased_reduce"), inputs)


@pytest.mark.parametrize("mode", MODES)
def test_phased_reduce_bitwise_with_bucket_by_bucket(phased_world, mode):
    for r, out in enumerate(phased_world):
        info = as_json(out[f"{mode}/info"])
        assert info["buckets"] >= 4 and info["dense_small"], info
        n = len(LEAVES)
        for i in range(n):
            np.testing.assert_array_equal(
                _bits(out[f"{mode}/phased/g{i}"]),
                _bits(out[f"{mode}/one_by_one/g{i}"]),
                err_msg=f"{mode} rank {r} leaf {i}")
        for i in range(info["buckets"]):
            np.testing.assert_array_equal(
                _bits(out[f"{mode}/phased/resid{i}"]),
                _bits(out[f"{mode}/one_by_one/resid{i}"]),
                err_msg=f"{mode} rank {r} residual {i}")
        # one pack call a step over every int8 leg, none otherwise
        want = [info["int8_legs"]] * 2 if mode == "int8" else []
        assert info["pack_calls"] == want, info
        if mode == "int8":
            assert 0 < info["int8_legs"] < info["buckets"]
    # the ranks hold the same reduced gradients
    for i in range(len(LEAVES)):
        np.testing.assert_array_equal(phased_world[0][f"{mode}/phased/g{i}"],
                                      phased_world[1][f"{mode}/phased/g{i}"])
