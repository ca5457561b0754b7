"""FSDP in the port against the JAX package's fsdp mesh.

A 2-layer, d=64, vocab-256, S=128 fp32 transformer starts from the JAX
init on both sides. The JAX package places it on an fsdp mesh of 2 CPU
devices (``init_sharded``), and its jitted step (XLA's partitioned
program) takes 3 steps of fused fp32 Adam on a seeded global batch of 8
rows sharded over the mesh. A port world of 2 gloo ranks
(``test_torch_world.World``) shards the same weights with
``parallel/sharding.shard_module`` and takes the same 3 steps through
the world step (gathers in the forward, reduce-scatters in the backward,
K5's plain version over each rank's slices), and, from the same weights,
3 steps of the dp world step. Tolerances: losses and parameters within
1e-5 of the JAX package's (fp32 sums in another order); fsdp's losses
and parameters bit for bit those of dp at world 2 (every sum is one
addition of two terms). Each rank holds the replicated leaves whole and
half of every sharded leaf, with the optimizer's moments over the same
elements.

Checkpoints: the ranks' per-rank chunks (``--ckpt-sharded``) restore in
the JAX package (``restore_sharded`` onto the fsdp mesh of 2) and in a
port world of one, bit for bit; the JAX package's saves from fsdp meshes
of 2 and of 4 restore into fresh port worlds of 2 bit for bit, and so
does a peer restore of the port's save through ``restore_from_index``
with a loader over donor memory.

K5's and K7's plain versions over a rank's slices: K5 (elementwise) is
the whole-tensor update bit for bit; K7 holds one scale a bucket, and the
slices' buckets are not the whole leaves', so its update is the whole
one within the int8 moments' rounding (the moments' scales differ).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world import World, one_torch_thread  # noqa: F401

SMALL = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_len=128)
SCHEDULE = (3e-3, 4, 1)
STEPS = 3
ATOL = 1e-5


def _port_state(params: dict, kind: str, quant: str = "off", mesh=None,
                lr_value=None):
    """A rank's state from flax ``params``: the model whole, then (for
    fsdp) this rank's slices of ``mesh`` (default: over the joined
    world); fused Adam over its leaves."""
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.parallel import sharding
    from edl_tpu_torch.train import fused_opt, lr
    from edl_tpu_torch.train.state import TrainState

    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32,
                                          attention="flash"), device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    model.train()
    if mesh is None:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec({kind: -1}))
    if kind == "fsdp":
        sharding.shard_module(model, mesh)
    schedule = (lr.cosine_with_warmup(*SCHEDULE) if lr_value is None
                else lr_value)
    tx = fused_opt.make_fused_tx("adam", schedule,
                                 "fp32" if quant == "off" else quant,
                                 weight_decay=0.01)
    return TrainState.create(model=model, tx=tx,
                             params=bridge.flax_named_parameters(model)), mesh


def _flat_tree(prefix: str, tree) -> dict:
    from edl_tpu_torch.train import sharded_checkpoint as sc
    return {f"{prefix}{k}": np.asarray(v) for k, v in sc.keyed_leaves(tree)}


def _unflat(inputs: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in inputs.items():
        if not k.startswith(prefix):
            continue
        node = out
        *path, leaf = k[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def rank_fsdp(inputs: dict, directory: Path) -> dict:
    """fsdp and dp, 3 steps each from the same weights; the fsdp state
    saved (per-rank chunks); the JAX saves and a peer restore of the
    port's into fresh fsdp states. Every tree gathered whole."""
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models.transformer import lm_loss_fn
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.parallel.sharding import fsdp_spec
    from edl_tpu_torch.train import ckpt_io
    from edl_tpu_torch.train import sharded_checkpoint as sc
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainStatus
    from edl_tpu_torch.train.step import make_train_step

    params = _unflat(inputs, "p/")
    out = {}

    def gathered(state):
        return bridge.gather_shards(bridge.sharded_state_tree(state))

    for kind in ("fsdp", "dp"):
        state, mesh = _port_state(params, kind)
        step = make_train_step(lm_loss_fn, mesh=mesh)
        losses = []
        for toks in inputs["tokens"]:
            state, m = step(state, mesh_lib.shard_batch(
                mesh, {"tokens": toks}))
            losses.append(float(m["loss"]))
        out[f"{kind}/losses"] = np.array(losses)
        out.update(_flat_tree(f"{kind}/tree", gathered(state)))
        if kind == "fsdp":
            out["fsdp/param_elems"] = np.array(
                sum(p.numel() for p in state.model.parameters()))
            out["fsdp/moment_elems"] = np.array(
                sum(b.numel() for b in state.opt_state.m))
            out["fsdp/sharded"] = np.array(
                sum(fsdp_spec(p) is not None
                    for p in state.model.parameters()))
            for name, p in state.model.named_parameters():
                out[f"fsdp/slice/{name}"] = p.detach().numpy().copy()
            mgr = CheckpointManager(str(directory / "ckpt"), sharded=True)
            mgr.save(state, TrainStatus(epoch=0, step=STEPS,
                                        world_size=2))
            mgr.close()
    for label in ("jax2", "jax4"):
        state, _ = _port_state(params, "fsdp")
        CheckpointManager(str(inputs[label])).restore(state)
        out.update(_flat_tree(f"{label}/tree", gathered(state)))
    state, _ = _port_state(params, "fsdp")
    saved = directory / "ckpt" / "ckpt-0"
    merged = ckpt_io.read_merged_index(str(saved))
    donor = {f: np.load(saved / f) for f in os.listdir(saved)
             if f.endswith(".npy")}
    sc.restore_from_index(merged, donor.__getitem__, state)
    out.update(_flat_tree("peer/tree", gathered(state)))
    out["rank"] = np.array(distributed.rank())
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's 3 steps on its fsdp mesh of 2, and its sharded
    saves of the final state from fsdp meshes of 2 and of 4."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.sharding import NamedSharding, PartitionSpec as P

    from edl_tpu.models.transformer import Transformer as JTransformer
    from edl_tpu.models.transformer import TransformerConfig as JConfig
    from edl_tpu.models.transformer import lm_loss_fn as j_lm_loss_fn
    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.parallel import sharding as jshd
    from edl_tpu.train import checkpoint as jckpt
    from edl_tpu.train import fused_opt as jfo
    from edl_tpu.train import lr as jlr
    from edl_tpu.train.state import TrainState as JTrainState
    from edl_tpu.train.state import TrainStatus as JTrainStatus
    from edl_tpu.train.step import make_train_step as j_make_train_step

    d = tmp_path_factory.mktemp("fsdp_jax")
    model = JTransformer(JConfig(**SMALL, dtype=jnp.float32,
                                 attention="flash"))
    toks0 = jnp.zeros((1, 128), jnp.int32)
    host_params = jax.tree.map(np.asarray, nn.unbox(jax.jit(
        model.init, static_argnames="train")(jax.random.PRNGKey(1), toks0,
                                             train=False)["params"]))
    mesh2 = jmesh.make_mesh(jmesh.MeshSpec({"fsdp": -1}), n_devices=2)
    params = jshd.init_sharded(
        lambda: model.init(jax.random.PRNGKey(1), toks0, train=False),
        mesh2)["params"]
    tx = jfo.make_fused_tx("adam", jlr.cosine_with_warmup(*SCHEDULE),
                           "fp32", weight_decay=0.01)
    state = JTrainState.create(apply_fn=model.apply, params=params, tx=tx)
    step = j_make_train_step(j_lm_loss_fn, donate=False)
    tokens = np.random.default_rng(5).integers(
        0, SMALL["vocab_size"], (STEPS, 8, 128)).astype(np.int32)
    losses = []
    for t in tokens:
        state, m = step(state, jmesh.shard_batch(mesh2, {"tokens": t}))
        losses.append(float(m["loss"]))
    status = JTrainStatus(epoch=0, step=STEPS, world_size=2)
    jckpt.CheckpointManager(str(d / "jax2"), sharded=True,
                            process_index=0).save(state, status)
    mesh4 = jmesh.make_mesh(jmesh.MeshSpec({"fsdp": -1}), n_devices=4)

    # the parameters by the rules on the mesh of 4, every other leaf
    # split along its first axis where that divides
    rules4 = jshd.param_shardings(mesh4, jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(1), toks0,
                           train=False))["params"])

    def on4(x):
        spec = P("fsdp") if x.ndim and x.shape[0] % 4 == 0 else P()
        return jax.device_put(x, NamedSharding(mesh4, spec))

    placed = jax.tree.map(on4, state).replace(params=jax.tree.map(
        jax.device_put, state.params, rules4))
    jckpt.CheckpointManager(str(d / "jax4"), sharded=True,
                            process_index=0).save(placed, status)
    return {"params": host_params, "tokens": tokens,
            "losses": np.array(losses), "state": state, "dir": d,
            "host": jax.device_get(state),
            "target": lambda: JTrainState.create(
                apply_fn=model.apply, params=params, tx=tx)}


def _flat_params(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def fsdp_world(jax_ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_world")
    inputs = {f"p/{k}": v for k, v in _flat_params(jax_ref["params"]).items()}
    inputs.update(tokens=jax_ref["tokens"],
                  jax2=np.array(str(jax_ref["dir"] / "jax2")),
                  jax4=np.array(str(jax_ref["dir"] / "jax4")))
    ranks = World("test_torch_fsdp:rank_fsdp", 2, d, inputs).results()
    return d, ranks


def _tree_of(rank: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rank.items()
            if k.startswith(prefix)}


def _jax_keyed(host) -> dict:
    import jax
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(host)[0]}


def test_fsdp_losses_match_the_jax_fsdp_mesh(jax_ref, fsdp_world):
    _, ranks = fsdp_world
    for r in ranks:
        np.testing.assert_allclose(r["fsdp/losses"], jax_ref["losses"],
                                   atol=ATOL)


def test_fsdp_params_match_the_jax_fsdp_mesh(jax_ref, fsdp_world):
    _, (r0, _) = fsdp_world
    want = _jax_keyed(jax_ref["host"])
    got = _tree_of(r0, "fsdp/tree")
    keys = [k for k in got if k.startswith(".params")]
    assert len(keys) == len(_flat_params(jax_ref["params"]))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


def test_fsdp_is_dp_bit_for_bit_and_ranks_agree(fsdp_world):
    _, (r0, r1) = fsdp_world
    np.testing.assert_array_equal(r0["fsdp/losses"], r0["dp/losses"])
    fsdp, dp = _tree_of(r0, "fsdp/tree"), _tree_of(r0, "dp/tree")
    assert fsdp.keys() == dp.keys()
    for k in fsdp:
        np.testing.assert_array_equal(fsdp[k], dp[k], err_msg=k)
    for k, v in _tree_of(r1, "fsdp/tree").items():
        np.testing.assert_array_equal(v, fsdp[k], err_msg=k)


def test_a_rank_holds_the_replicated_leaves_and_half_the_sharded(
        jax_ref, fsdp_world):
    from edl_tpu_torch import bridge
    from edl_tpu_torch.parallel import sharding
    from edl_tpu_torch.parallel.mesh import Mesh

    _, ranks = fsdp_world
    full = _flat_params(jax_ref["params"])
    mesh = Mesh(np.arange(2), ("fsdp",), rank=0)

    def spec(k):
        names = sharding.logical_names(tuple(k.split("/")))
        return names and sharding.logical_to_spec(names, mesh=mesh)

    # the token table and the LayerNorms stay whole
    assert not spec("tok_embed/embedding") and not spec("ln_final/scale")
    sharded = sum(v.size for k, v in full.items() if spec(k))
    whole = sum(v.size for v in full.values())
    for r in ranks:
        assert int(r["fsdp/sharded"]) == 6 * SMALL["n_layers"] + 2
        assert int(r["fsdp/param_elems"]) == whole - sharded // 2
        # the moments cover the same elements, within the 128-padding
        assert 0 <= int(r["fsdp/moment_elems"]) - int(
            r["fsdp/param_elems"]) < 128 * len(
                [k for k in r if k.startswith("fsdp/slice/")])
        # each slice is the bridge's shard of the JAX weights' layout
        want = bridge.flax_to_torch_sharded(
            jax_ref["params"], Mesh(np.arange(2), ("fsdp",),
                                    rank=int(r["rank"])))
        assert sharding.logical_names(("lm_head", "kernel")) == (
            "embed", "vocab")
        for name in want:
            assert r[f"fsdp/slice/{name}"].shape == tuple(want[name].shape)


def test_port_chunks_restore_in_the_jax_package(jax_ref, fsdp_world):
    """The ranks' per-rank chunks, restored by the JAX package onto its
    fsdp mesh of 2, are the port's state bit for bit."""
    from edl_tpu.train import checkpoint as jckpt

    d, (r0, _) = fsdp_world
    saved = d / "ckpt" / "ckpt-0"
    assert {"index.0.json", "index.1.json"} <= set(os.listdir(saved))
    got, status = jckpt.CheckpointManager(
        str(d / "ckpt"), process_index=0).restore(jax_ref["target"]())
    assert status.step == STEPS
    got = _jax_keyed(got)
    want = _tree_of(r0, "fsdp/tree")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_chunks_restore_into_a_world_of_one(jax_ref, fsdp_world):
    from edl_tpu_torch import bridge
    from edl_tpu_torch.train.checkpoint import CheckpointManager

    d, (r0, _) = fsdp_world
    state, _ = _port_state(jax_ref["params"], "dp")
    _, status = CheckpointManager(str(d / "ckpt")).restore(state)
    assert status.step == STEPS
    got = _flat_tree("", bridge.state_to_flax(state))
    want = _tree_of(r0, "fsdp/tree")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("label", ["jax2", "jax4", "peer"])
def test_saves_restore_into_a_port_world_of_two(jax_ref, fsdp_world, label):
    """A JAX save from fsdp meshes of 2 and 4, and the port's own save
    through restore_from_index over donor memory, restored into fresh
    fsdp ranks: each rank's regions, gathered, are the saved state bit
    for bit."""
    _, ranks = fsdp_world
    want = (_tree_of(ranks[0], "fsdp/tree") if label == "peer"
            else _jax_keyed(jax_ref["host"]))
    for r in ranks:
        got = _tree_of(r, f"{label}/tree")
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_adam_plain_versions_over_slices(jax_ref, quant):
    """Two fused Adam steps over each rank's slices (K5 or K7's plain
    version, CPU tensors) against the steps over whole leaves."""
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.parallel import sharding

    gen = torch.Generator().manual_seed(3)
    whole, _ = _port_state(jax_ref["params"], "dp", quant, lr_value=1e-3)
    grads = [{n: torch.randn(p.shape, generator=gen) * 1e-2
              for n, p in whole.params} for _ in range(2)]
    for g in grads:
        for n, p in whole.params:
            p.grad = g[n].clone()
        whole.apply_gradients()
    parts = []
    for rank in range(2):
        mesh = mesh_lib.Mesh(np.arange(2), ("fsdp",), rank=rank)
        state, _ = _port_state(jax_ref["params"], "fsdp", quant, mesh=mesh,
                               lr_value=1e-3)
        for g in grads:
            for n, p in state.params:
                spec = sharding.fsdp_spec(p)
                p.grad = (g[n] if spec is None else g[n].chunk(
                    spec.world, dim=spec.dim)[spec.index]).clone()
            state.apply_gradients()
        parts.append(dict(state.params))
    for n, want in whole.params:
        spec = sharding.fsdp_spec(parts[0][n])
        got = (parts[0][n].detach() if spec is None else torch.cat(
            [parts[r][n].detach() for r in range(2)], dim=spec.dim))
        if quant == "off":
            assert torch.equal(got, want.detach()), n
        else:
            torch.testing.assert_close(got, want.detach(), atol=5e-5,
                                       rtol=0, msg=n)
