"""Sharding by logical names (``edl_tpu_torch/parallel/sharding.py``)
against the JAX package's: ``logical_to_spec`` over the rule table and
meshes of every data/model axis mix; the transformer's logical names
(the port's table against the flax boxes of the JAX model); each leaf's
slice for each rank of fsdp meshes of 2 and 4 (and dp x fsdp) against
what ``jax.device_put`` with ``param_shardings`` places on that rank's
device; ``shard_tree``/``gather_tree`` and the bridge's
``flax_to_torch_sharded``/``torch_to_flax_sharded`` round trips; and
``shard_module``'s slices in the torch layout (the rule's dim mapped
through the bridge's transposes and the attention reshapes) against the
bridge's conversion of JAX's addressable shards. ``constrain`` is the
identity."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu.parallel import mesh as jmesh
from edl_tpu.parallel import sharding as jshd
from edl_tpu_torch import bridge
from edl_tpu_torch.models.transformer import Transformer, TransformerConfig
from edl_tpu_torch.parallel import mesh as tmesh
from edl_tpu_torch.parallel import sharding as tshd

SMALL = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_len=128)
NAMES = ["batch", "seq", "vocab", "embed", "heads", "kv", "mlp",
         "vocab_table", "embed_table", "expert", "expert_router", None,
         "unknown"]
MESHES = [{"dp": 8}, {"fsdp": 8}, {"dp": 2, "fsdp": 4}, {"fsdp": 4, "tp": 2},
          {"dp": 2, "sp": 2, "tp": 2}, {"ep": 4, "dp": 2}, {"dp": 1, "fsdp": 1}]


def _meshes(axes: dict):
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(jmesh.MeshSpec(axes), devices=jax.devices()[:n])
    grid = np.arange(n).reshape(tuple(axes.values()))
    return jm, grid, tuple(axes)


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_logical_to_spec_is_the_jax_package_s(axes):
    jm, grid, names = _meshes(axes)
    tm = tmesh.Mesh(grid, names)
    for logical in itertools.product(NAMES, repeat=2):
        want = tuple(jshd.logical_to_spec(logical, mesh=jm))
        assert tshd.logical_to_spec(logical, mesh=tm) == want, logical
        assert tshd.logical_to_spec(logical) == tuple(
            jshd.logical_to_spec(logical)), logical


@pytest.fixture(scope="module")
def boxed():
    model = JTransformer(JConfig(**SMALL, dtype=jnp.float32))
    return jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(2), jnp.zeros((1, 128), jnp.int32),
        train=False)["params"]


@pytest.fixture(scope="module")
def host(boxed):
    return jax.tree.map(np.asarray, nn.unbox(boxed))


def test_transformer_logical_names_are_the_flax_boxes(boxed):
    leaves = jax.tree_util.tree_flatten_with_path(
        boxed, is_leaf=lambda x: hasattr(x, "names"))[0]
    assert len(leaves) == 5 + 10 * SMALL["n_layers"]
    for path, leaf in leaves:
        keys = tuple(k.key for k in path)
        assert tshd.logical_names(keys) == getattr(leaf, "names", None), \
            keys


@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"fsdp": 4},
                                  {"dp": 2, "fsdp": 2}], ids=str)
def test_each_rank_holds_what_device_put_places_on_it(boxed, host, axes):
    jm, grid, names = _meshes(axes)
    shardings = jshd.param_shardings(jm, boxed)
    placed = jax.tree.map(jax.device_put, host, nn.unbox(shardings))
    flat = dict(jax.tree_util.tree_flatten_with_path(placed)[0])
    per_rank = []
    for rank in range(grid.size):
        tm = tmesh.Mesh(grid, names, rank=rank)
        mine = tshd.shard_tree(host, tm)
        per_rank.append(mine)
        for path, arr in flat.items():
            want = next(np.asarray(s.data) for s in arr.addressable_shards
                        if s.device.id == rank)
            got = mine
            for k in path:
                got = got[k.key]
            np.testing.assert_array_equal(got, want,
                                          err_msg=jax.tree_util.keystr(path))
    back = tshd.gather_tree(per_rank, tmesh.Mesh(grid, names))
    for path, arr in jax.tree_util.tree_flatten_with_path(host)[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_module_slices_are_the_bridged_jax_shards(host, boxed, n):
    """shard_module on a model holding the JAX weights leaves, on each
    rank, the bridge's conversion of the JAX shards on that rank's
    device; the bridge's sharded pair round-trips."""
    jm, grid, names = _meshes({"fsdp": n})
    placed = jax.tree.map(jax.device_put, host, nn.unbox(
        jshd.param_shardings(jm, boxed)))
    state_dicts = []
    for rank in range(n):
        tm = tmesh.Mesh(grid, names, rank=rank)
        model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32),
                            device="cpu")
        model.load_state_dict(bridge.flax_to_torch(host))
        specs = tshd.shard_module(model, tm)
        assert len(specs) == 6 * SMALL["n_layers"] + 2
        on_device = jax.tree.map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device.id == rank), placed)
        want = bridge.flax_to_torch(on_device)
        sd = {k: v.detach() for k, v in model.named_parameters()}
        assert sd.keys() == want.keys()
        for k in sd:
            assert torch.equal(sd[k], want[k]), k
            spec = tshd.fsdp_spec(model.get_parameter(k))
            assert (spec is None) == (tuple(sd[k].shape) == tuple(
                bridge.flax_to_torch(host)[k].shape)), k
        assert bridge.flax_to_torch_sharded(host, tm).keys() == sd.keys()
        for k, v in bridge.flax_to_torch_sharded(host, tm).items():
            assert torch.equal(v, sd[k]), k
        state_dicts.append(sd)
    back = bridge.torch_to_flax_sharded(state_dicts, tmesh.Mesh(grid, names),
                                        SMALL["n_heads"])
    for path, arr in jax.tree_util.tree_flatten_with_path(host)[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, arr)


def test_torch_dim_maps_the_flax_layouts():
    assert bridge.torch_dim("block0.attn.query.weight", 0, 3) == 1
    assert bridge.torch_dim("block0.attn.out.weight", 2, 3) == 0
    assert bridge.torch_dim("block0.mlp_out.weight", 1) == 0
    assert bridge.torch_dim("lm_head.weight", 0) == 1
    assert bridge.torch_dim("pos_embed", 1) == 1
    assert bridge.torch_dim("Conv_0.weight", 3, 4) == 0


def test_constrain_is_the_identity():
    x = torch.ones(2, 3)
    assert tshd.constrain(x, ("batch", "embed"), None) is x
    with pytest.raises(ValueError, match="does not split"):
        tshd.leaf_shard(tmesh.Mesh(np.arange(4), ("fsdp",)), ("fsdp",), (6,))


def test_shard_module_keeps_sp_out_of_the_parameters():
    """Under fsdp x sp the JAX "seq" rule places pos_embed over sp too;
    the port's sp ranks keep every parameter whole along sp, so a rank
    holds what the fsdp-only mesh gives it: pos_embed split on its embed
    dim over fsdp alone."""
    grid = np.arange(4).reshape(2, 2)
    specs = {}
    for rank in range(4):
        model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32),
                            device="cpu")
        specs[rank] = tshd.shard_module(
            model, tmesh.Mesh(grid, ("fsdp", "sp"), rank=rank))
        assert tuple(model.pos_embed.shape) == (SMALL["max_len"],
                                                SMALL["d_model"] // 2)
    assert specs[0]["pos_embed"].dim == 1
    assert [specs[r]["pos_embed"].index for r in range(4)] == [0, 0, 1, 1]
    assert len(specs[0]) == 6 * SMALL["n_layers"] + 2


@pytest.mark.parametrize("axes", [{"tp": 2, "dp": 2}, {"fsdp": 2, "ep": 2}])
def test_expert_tables_over_tp_and_ep_name_item_14d(axes):
    """MoE expert tables split over ep, or over tp, are the ep half of
    item 14(d): shard_module refuses them and leaves the module whole."""
    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32,
                                          moe=True, n_experts=4),
                        device="cpu")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    grid = np.arange(4).reshape(2, 2)
    with pytest.raises(NotImplementedError, match=r"item 14\(d\)"):
        tshd.shard_module(model, tmesh.Mesh(grid, tuple(axes)))
    assert {n: p.shape for n, p in model.named_parameters()} == shapes


@pytest.mark.parametrize("axes", [{"tp": 2}, {"fsdp": 2, "tp": 2},
                                  {"dp": 2, "tp": 2},
                                  {"dp": 2, "fsdp": 2, "tp": 2}], ids=str)
def test_tp_slices_are_the_bridged_jax_shards(boxed, host, axes):
    """shard_module over meshes with tp (the tp slice, then the fsdp
    slice of it) leaves on each rank the bridge's conversion of the JAX
    shards on that rank's device; a tp rank's specs, the chunk writers
    (replica 0) and the bridge's sharded round trip."""
    jm, grid, names = _meshes(axes)
    placed = jax.tree.map(jax.device_put, host, nn.unbox(
        jshd.param_shardings(jm, boxed)))
    full = bridge.flax_to_torch(host)
    state_dicts = []
    for rank in range(grid.size):
        tm = tmesh.Mesh(grid, names, rank=rank)
        model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32),
                            device="cpu")
        model.load_state_dict(full)
        specs = tshd.shard_module(model, tm)
        on_device = jax.tree.map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device.id == rank), placed)
        want = bridge.flax_to_torch(on_device)
        sd = {k: v.detach() for k, v in model.named_parameters()}
        assert sd.keys() == want.keys()
        for k in sd:
            assert torch.equal(sd[k], want[k]), k
            p = model.get_parameter(k)
            assert tshd.whole_shape(p) == tuple(full[k].shape), k
            assert (tshd.tp_spec(p) is None) == (k.startswith(
                ("pos_embed", "ln_final")) or ".ln_" in k), k
            split = {a for a in axes if axes[a] > 1} & {
                s for s, on in (("tp", tshd.tp_spec(p)),
                                ("fsdp", tshd.fsdp_spec(p))) if on}
            if split:
                coords = tm.coords
                assert tshd.owns_chunk(p) == all(
                    coords[a] == 0 for a in axes if a not in split), k
        # the tp-sharded leaves: the token table, qkv/out, the MLP, lm_head
        assert len(specs) == 6 * SMALL["n_layers"] + 2 + (
            1 if axes.get("fsdp", 1) > 1 else 0)
        if axes.get("fsdp", 1) > 1:
            mlp_in = model.get_parameter("block0.mlp_in.weight")
            assert mlp_in.numel() * 4 == full["block0.mlp_in.weight"].numel()
            assert tshd.fsdp_spec(mlp_in).full_shape == (
                SMALL["d_ff"] // 2, SMALL["d_model"])
        for k, v in bridge.flax_to_torch_sharded(host, tm).items():
            assert torch.equal(v, sd[k]), k
        state_dicts.append(sd)
    back = bridge.torch_to_flax_sharded(state_dicts, tmesh.Mesh(grid, names),
                                        SMALL["n_heads"])
    for path, arr in jax.tree_util.tree_flatten_with_path(host)[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, arr)


def test_the_world_step_takes_sp_and_tp_and_refuses_ep():
    from edl_tpu_torch.models.transformer import lm_loss_fn
    from edl_tpu_torch.train.step import WorldTrainStep

    grid = np.arange(4).reshape(2, 2)
    step = WorldTrainStep(lm_loss_fn, mesh=tmesh.Mesh(grid, ("dp", "sp")))
    assert (step.world, step.replicas) == (4, 2)
    step = WorldTrainStep(lm_loss_fn, mesh=tmesh.Mesh(grid, ("dp", "tp")))
    assert (step.world, step.replicas, step.cross) == (4, 2, 2)
    step = WorldTrainStep(lm_loss_fn, mesh=tmesh.Mesh(grid, ("tp", "sp")))
    assert (step.world, step.replicas, step.cross) == (4, 1, 2)
    with pytest.raises(NotImplementedError, match=r"item 14\(d\)"):
        WorldTrainStep(lm_loss_fn, mesh=tmesh.Mesh(grid, ("dp", "ep")))
    with pytest.raises(ValueError, match="--fsdp with --mesh sp"):
        WorldTrainStep(lm_loss_fn, mesh=tmesh.Mesh(grid, ("fsdp", "sp")))
