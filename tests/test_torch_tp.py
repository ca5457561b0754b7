"""Tensor parallelism in the port against the JAX package's tp meshes.

A 2-layer, d=32, 4-head, d_ff=64, vocab-64, S=16 fp32 transformer starts
from the JAX init on both sides. The JAX package places it on a mesh
(``init_sharded``) and its jitted step (XLA's partitioned program) takes
3 steps of fused fp32 Adam on a seeded global batch of 8 rows; a port
world of gloo ranks (``test_torch_world.World``) shards the same weights
with ``parallel/sharding.shard_module`` and takes the same 3 steps
through the world step (K5's plain version over each rank's slices):

- (a) a world of 2 over ``{tp: 2}``: each rank its 2 heads, its half of
  the MLP's hidden units, of the vocab and of the token table's columns;
- (b) a world of 4 over ``{fsdp: 2, tp: 2}``: a rank holds a quarter of
  ``mlp_in`` (its tp rows, then its fsdp columns of those);
- (c) a world of 4 over ``{tp: 2, sp: 2}`` (the dry run's tp x sp):
  ring attention over sp on each rank's own heads.

Tolerances are ``test_torch_fsdp.py``'s: losses and parameters within
1e-5 of the JAX package's (fp32 sums in another order). The ranks of a
world end bitwise equal on what they share: the tp-replicated leaves
(LayerNorms, ``pos_embed``) on the tp ranks, the gathered states on all.

(d) The vocab-parallel log-softmax (``models/transformer.
vocab_parallel_ll``) and its gradient against ``log_softmax`` of the
whole logits, and ``lm_loss_fused`` under tp (the head gathered from tp,
then the streamed loss) against the JAX package's ``lm_loss_fused``, on
two in-process tp shards (``parallel/distributed.LocalComm``).

(e) Checkpoints both ways, bit for bit: the per-rank chunks of the tp and
fsdp x tp worlds restore in the JAX package onto ``{fsdp: 2, tp: 2}`` and
onto one device; the JAX save from ``{fsdp: 2, tp: 2}`` restores into a
port world of tp = 2 and of one, and through ``restore_from_index`` with
a loader over donor memory (the migration plane's peer restore).
"""

import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world import World, as_json, one_torch_thread  # noqa: F401

TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=16)
SCHEDULE = (3e-3, 4, 1)
STEPS = 3
ROWS = 8
ATOL = 1e-5
MESHES = {"tp": {"tp": 2}, "fsdp_tp": {"fsdp": 2, "tp": 2},
          "tp_sp": {"tp": 2, "sp": 2}}
# each tp rank's bf16 partial sum (exact in bf16) for the 16-bit reduce
BF16_PARTS = np.array([[1.0, 256.0, 3.0, -2.5], [0.00390625, 1.0, 1.0, 2.5]],
                      np.float32)


def _port_state(params: dict, axes: dict | None, mesh=None):
    """A rank's state from flax ``params``: the model whole, then this
    rank's slices over ``axes`` (a mesh over the joined world); fused
    fp32 Adam over its leaves."""
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.parallel import sharding
    from edl_tpu_torch.parallel.ring_attention import SeqParallel
    from edl_tpu_torch.train import fused_opt, lr
    from edl_tpu_torch.train.state import TrainState

    if mesh is None and axes:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(axes))
    sp = SeqParallel.of(mesh) if mesh is not None else None
    model = Transformer(TransformerConfig(
        **TINY, dtype=torch.float32, attention="dense" if sp else "flash",
        sp=sp), device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    model.train()
    if mesh is not None:
        sharding.shard_module(model, mesh)
    tx = fused_opt.make_fused_tx("adam", lr.cosine_with_warmup(*SCHEDULE),
                                 "fp32", weight_decay=0.01)
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


def rank_tp(inputs: dict, directory: Path) -> dict:
    """For each mesh of ``inputs["meshes"]`` in turn: 3 world steps from
    the JAX weights, the state gathered whole, the tp-replicated leaves
    and a rank's slice shapes as they are; the first mesh's state saved
    as per-rank chunks; then into fresh states of the first mesh the JAX
    save from {fsdp: 2, tp: 2}, and peer restores of it and of the port's
    chunks."""
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models.transformer import lm_loss_fn
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.parallel import sharding
    from edl_tpu_torch.train import ckpt_io
    from edl_tpu_torch.train import sharded_checkpoint as sc
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainStatus
    from edl_tpu_torch.train.step import make_train_step

    params = _unflat(inputs, "p/")
    out = {"rank": np.array(distributed.rank())}

    def gathered(state):
        return bridge.gather_shards(bridge.sharded_state_tree(state))

    names = as_json(inputs["meshes"])
    for i, name in enumerate(names):
        state, mesh = _port_state(params, MESHES[name])
        step = make_train_step(lm_loss_fn, mesh=mesh)
        losses = []
        for toks in inputs["tokens"]:
            state, m = step(state, mesh_lib.shard_batch(
                mesh, {"tokens": toks}))
            losses.append(float(m["loss"]))
        out[f"{name}/losses"] = np.array(losses)
        out.update(_flat_tree(f"{name}/tree", gathered(state)))
        for pname, p in state.model.named_parameters():
            out[f"{name}/shape/{pname}"] = np.array(p.shape)
            if not sharding.cuts(p):
                out[f"{name}/whole/{pname}"] = p.detach().numpy().copy()
        out[f"{name}/param_elems"] = np.array(
            sum(p.numel() for p in state.model.parameters()))
        if i == 0:
            # a 16-bit sum over the tp group: the partials gathered and
            # added in rank order in fp32, rounded once
            part = torch.from_numpy(inputs["bf16_parts"][mesh.coords["tp"]])
            out["bf16_sum"] = distributed.tp_comm(mesh).all_reduce(
                part.to(torch.bfloat16)).float().numpy()
            mgr = CheckpointManager(str(directory / "ckpt"), sharded=True)
            mgr.save(state, TrainStatus(epoch=0, step=STEPS,
                                        world_size=distributed.world_size()))
            mgr.close()
            first = name
    for label in ("jax22",):
        state, _ = _port_state(params, MESHES[first])
        CheckpointManager(str(inputs[label])).restore(state)
        out.update(_flat_tree(f"{label}/tree", gathered(state)))
    # the migration plane's peer restore: chunks from donor memory, of
    # the port's own save and of the JAX package's
    for label, saved in (("peer", directory / "ckpt" / "ckpt-0"),
                         ("jaxpeer", Path(str(inputs["jax22"])) / "ckpt-0")):
        state, _ = _port_state(params, MESHES[first])
        merged = ckpt_io.read_merged_index(str(saved))
        donor = {f: np.load(saved / f) for f in os.listdir(saved)
                 if f.endswith(".npy")}
        sc.restore_from_index(merged, donor.__getitem__, state)
        out.update(_flat_tree(f"{label}/tree", gathered(state)))
    return out


def _flat_params(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_keyed(host) -> dict:
    import jax
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(host)[0]}


def _tree_of(rank: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rank.items()
            if k.startswith(prefix)}


def _inputs(params: dict, tokens: np.ndarray, jax22: Path,
            meshes: list[str]) -> dict:
    inputs = {f"p/{k}": v for k, v in _flat_params(params).items()}
    inputs.update(tokens=tokens, meshes=np.array(json.dumps(meshes)),
                  jax22=np.array(str(jax22)), bf16_parts=BF16_PARTS)
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's 3 steps on each mesh of MESHES (the model's
    config carries the mesh, so ``sp`` runs its ring) and its sharded
    save of the {fsdp: 2, tp: 2} run's final state; the port's world of 2
    over {tp: 2} and world of 4 over {fsdp: 2, tp: 2} then {tp: 2,
    sp: 2}, started once that save is sealed and running beside the JAX
    package's other two meshes."""
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

    d = tmp_path_factory.mktemp("tp_jax")
    toks0 = jnp.zeros((1, TINY["max_len"]), jnp.int32)
    tokens = np.random.default_rng(7).integers(
        0, TINY["vocab_size"], (STEPS, ROWS, TINY["max_len"])
    ).astype(np.int32)
    tx = jfo.make_fused_tx("adam", jlr.cosine_with_warmup(*SCHEDULE),
                           "fp32", weight_decay=0.01)
    out = {"tokens": tokens, "dir": d, "losses": {}, "host": {}}
    worlds = {}

    def run(name):
        axes = MESHES[name]
        mesh = jmesh.make_mesh(jmesh.MeshSpec(axes),
                               n_devices=int(np.prod(list(axes.values()))))
        model = JTransformer(JConfig(**TINY, dtype=jnp.float32, mesh=mesh))
        params = jshd.init_sharded(
            lambda: model.init(jax.random.PRNGKey(1), toks0, train=False),
            mesh)["params"]
        if "params" not in out:
            out["params"] = jax.tree.map(np.asarray, nn.unbox(params))
        state = JTrainState.create(apply_fn=model.apply, params=params,
                                   tx=tx)
        step = j_make_train_step(j_lm_loss_fn, donate=False)
        data = tuple(a for a in ("dp", "fsdp") if axes.get(a, 1) > 1)
        spec = P(data or None, "sp" if "sp" in axes else None)
        losses = []
        for t in tokens:
            state, m = step(state, {"tokens": jax.device_put(
                t, NamedSharding(mesh, spec))})
            losses.append(float(m["loss"]))
        out["losses"][name] = np.array(losses)
        out["host"][name] = jax.device_get(state)
        if name == "fsdp_tp":
            jckpt.CheckpointManager(str(d / "jax22"), sharded=True,
                                    process_index=0).save(
                state, JTrainStatus(epoch=0, step=STEPS, world_size=4))

            def target(model=model, params=params):
                return JTrainState.create(apply_fn=model.apply,
                                          params=params, tx=tx)
            out["target22"] = target
            for key, size, meshes in (("tp", 2, ["tp"]),
                                      ("fsdp_tp", 4, ["fsdp_tp", "tp_sp"])):
                wd = tmp_path_factory.mktemp(f"tp_world{size}")
                worlds[key] = (wd, World(
                    "test_torch_tp:rank_tp", size, wd,
                    _inputs(out["params"], tokens, d / "jax22", meshes)))

    run("fsdp_tp")
    # the other two meshes compile side by side (XLA releases the GIL)
    threads = [threading.Thread(target=run, args=(n,))
               for n in ("tp", "tp_sp")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    one = JTransformer(JConfig(**TINY, dtype=jnp.float32))
    out["target1"] = lambda: JTrainState.create(
        apply_fn=one.apply, params=jax.tree.map(jnp.asarray, out["params"]),
        tx=tx)
    out["worlds"] = {k: (wd, w.results()) for k, (wd, w) in worlds.items()}
    return out


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


def _ranks(worlds, name):
    return worlds["tp" if name == "tp" else "fsdp_tp"][1]


@pytest.mark.parametrize("name", list(MESHES))
def test_losses_and_params_match_the_jax_mesh(jax_ref, worlds, name):
    ranks = _ranks(worlds, name)
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}/losses"],
                                   jax_ref["losses"][name], atol=ATOL)
    want = _jax_keyed(jax_ref["host"][name])
    got = _tree_of(ranks[0], f"{name}/tree")
    keys = [k for k in got if k.startswith(".params")]
    assert len(keys) == len(_flat_params(jax_ref["params"]))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(MESHES))
def test_ranks_agree_and_tp_replicated_leaves_are_bitwise(worlds, name):
    ranks = _ranks(worlds, name)
    tree0 = _tree_of(ranks[0], f"{name}/tree")
    whole0 = _tree_of(ranks[0], f"{name}/whole/")
    # the LayerNorms (2 a block and ln_final) and pos_embed, which fsdp
    # splits on its embed dim
    assert len(whole0) == 4 * TINY["n_layers"] + 2 + (
        "fsdp" not in MESHES[name])
    for r in ranks[1:]:
        assert np.array_equal(r[f"{name}/losses"], ranks[0][f"{name}/losses"])
        for k, v in _tree_of(r, f"{name}/tree").items():
            np.testing.assert_array_equal(v, tree0[k], err_msg=k)
        for k, v in _tree_of(r, f"{name}/whole/").items():
            np.testing.assert_array_equal(v, whole0[k], err_msg=k)


@pytest.mark.parametrize("world", ["tp", "fsdp_tp"])
def test_a_16_bit_tp_sum_is_the_fp32_sum_rounded_once(worlds, world):
    """The ranks' bf16 partials summed over the tp group (through
    GroupComm's all-gather and ordered fp32 sum): every rank holds the
    fp32 sum rounded to bf16 once."""
    want = torch.from_numpy(BF16_PARTS.sum(0)).to(torch.bfloat16).float()
    for r in worlds[world][1]:
        np.testing.assert_array_equal(r["bf16_sum"], want.numpy())


@pytest.mark.parametrize("name", list(MESHES))
def test_a_rank_holds_its_tp_and_fsdp_slices(jax_ref, worlds, name):
    from edl_tpu_torch import bridge

    full = bridge.flax_to_torch(jax_ref["params"])
    axes = MESHES[name]
    tp, fsdp = axes.get("tp", 1), axes.get("fsdp", 1)
    for r in _ranks(worlds, name):
        shape = {k: tuple(v) for k, v in _tree_of(r, f"{name}/shape/").items()}
        assert shape["block0.mlp_in.weight"] == (
            TINY["d_ff"] // tp, TINY["d_model"] // fsdp)
        assert shape["block0.attn.query.weight"] == (
            TINY["d_model"] // tp, TINY["d_model"] // fsdp)
        assert shape["block0.attn.out.weight"] == (
            TINY["d_model"] // fsdp, TINY["d_model"] // tp)
        assert shape["lm_head.weight"] == (TINY["vocab_size"] // tp,
                                           TINY["d_model"] // fsdp)
        assert shape["tok_embed.weight"] == (TINY["vocab_size"],
                                             TINY["d_model"] // tp)
        if fsdp > 1:
            assert (np.prod(shape["block0.mlp_in.weight"]) * 4
                    == full["block0.mlp_in.weight"].numel())
        assert int(r[f"{name}/param_elems"]) == sum(
            int(np.prod(s)) for s in shape.values())


def test_vocab_parallel_loss_and_gradient_are_the_whole_softmax():
    """Two in-process tp shards of fp32 logits (64 classes): the
    vocab-parallel log-likelihood and its gradient on each shard's slice
    against log_softmax of the whole logits, with targets in both
    halves."""
    from edl_tpu_torch.models.transformer import (_next_token_ll,
                                                  vocab_parallel_ll)
    from edl_tpu_torch.parallel import distributed

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 5, 64, generator=gen) * 4
    targets = torch.randint(0, 64, (3, 5), generator=gen)
    whole = logits.clone().requires_grad_(True)
    want = _next_token_ll(whole, targets)
    want.sum().backward()
    ex = distributed.LocalExchange(2)
    got: dict = {}

    def shard(t):
        part = logits[..., t * 32:(t + 1) * 32].clone().requires_grad_(True)
        ll = vocab_parallel_ll(part, targets, distributed.LocalComm(ex, t))
        ll.sum().backward()
        got[t] = (ll.detach(), part.grad)

    threads = [threading.Thread(target=shard, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for t in range(2):
        torch.testing.assert_close(got[t][0], want.detach(), atol=1e-5,
                                   rtol=0)
    torch.testing.assert_close(torch.cat([got[0][1], got[1][1]], dim=-1),
                               whole.grad, atol=1e-6, rtol=0)


def test_fused_loss_under_tp_is_the_jax_package_s(jax_ref):
    """lm_loss_fused on two in-process tp shards of the JAX weights (the
    vocab-sharded head gathered from tp before the streamed loss): its
    loss, and the lm_head and token-table gradients each shard keeps,
    against the JAX package's lm_loss_fused on one device."""
    import jax
    import jax.numpy as jnp

    from edl_tpu.models.transformer import Transformer as JTransformer
    from edl_tpu.models.transformer import TransformerConfig as JConfig
    from edl_tpu.models.transformer import lm_loss_fused as j_fused
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lm_loss_fused)
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel.mesh import Mesh
    from edl_tpu_torch.parallel.sharding import shard_module

    toks = jax_ref["tokens"][0]
    model = JTransformer(JConfig(**TINY, dtype=jnp.float32))

    class _State:
        apply_fn = model.apply

    params = jax.tree.map(jnp.asarray, jax_ref["params"])
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: j_fused(_State, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    want_head = bridge.flax_to_torch(jax.tree.map(np.asarray, grads))
    ex = distributed.LocalExchange(2)
    got: dict = {}

    def shard(t):
        m = Transformer(TransformerConfig(**TINY, dtype=torch.float32),
                        device="cpu")
        m.load_state_dict(bridge.flax_to_torch(jax_ref["params"]))
        m.train()
        shard_module(m, Mesh(np.arange(2), ("tp",), rank=t,
                             groups={"tp": distributed.LocalComm(ex, t)}))
        lo, _ = lm_loss_fused(m, {"tokens": torch.as_tensor(toks)})
        lo.backward()
        got[t] = (float(lo.detach()), m.lm_head.weight.grad,
                  m.tok_embed.weight.grad)

    threads = [threading.Thread(target=shard, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for t in range(2):
        assert abs(got[t][0] - float(loss)) <= ATOL
    torch.testing.assert_close(torch.cat([got[0][1], got[1][1]], dim=0),
                               want_head["lm_head.weight"], atol=ATOL, rtol=0)
    torch.testing.assert_close(torch.cat([got[0][2], got[1][2]], dim=1),
                               want_head["tok_embed.weight"], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["tp", "fsdp_tp"])
def test_port_chunks_restore_in_the_jax_package(jax_ref, worlds, name):
    """The tp and fsdp x tp worlds' per-rank chunks, restored by the JAX
    package onto {fsdp: 2, tp: 2} and onto one device, are the port's
    state bit for bit; each slice was written once."""
    from edl_tpu.train import checkpoint as jckpt
    from edl_tpu.train import ckpt_io as jio

    d, ranks = worlds[name]
    saved = d / "ckpt" / "ckpt-0"
    assert {f"index.{r}.json" for r in range(len(ranks))} <= set(
        os.listdir(saved))
    merged = jio.read_merged_index(str(saved))
    for entry in merged.values():
        regions = [tuple(c["offset"]) for c in entry["chunks"]]
        assert len(regions) == len(set(regions)), entry["key"]
    want = _tree_of(ranks[0], f"{name}/tree")
    for target in ("target22", "target1"):
        got, status = jckpt.CheckpointManager(
            str(d / "ckpt"), process_index=0).restore(jax_ref[target]())
        assert status.step == STEPS
        got = _jax_keyed(got)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_and_port_saves_restore_into_a_world_of_one(jax_ref, worlds):
    """The JAX save from {fsdp: 2, tp: 2} and the tp world's chunks,
    restored into a port world of one, are the saved states bit for
    bit."""
    from edl_tpu_torch import bridge
    from edl_tpu_torch.train.checkpoint import CheckpointManager

    for directory, want in (
            (jax_ref["dir"] / "jax22", _jax_keyed(jax_ref["host"]["fsdp_tp"])),
            (worlds["tp"][0] / "ckpt", _tree_of(worlds["tp"][1][0],
                                                "tp/tree"))):
        state, _ = _port_state(jax_ref["params"], None)
        _, status = CheckpointManager(str(directory)).restore(state)
        assert status.step == STEPS
        got = _flat_tree("", bridge.state_to_flax(state))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


@pytest.mark.parametrize("label", ["jax22", "jaxpeer", "peer"])
@pytest.mark.parametrize("world", ["tp", "fsdp_tp"])
def test_saves_restore_into_port_tp_worlds(jax_ref, worlds, world, label):
    """The JAX save from {fsdp: 2, tp: 2}, from disk and through
    restore_from_index over donor memory, and the world's own save
    through restore_from_index, restored into fresh ranks of the tp and
    fsdp x tp worlds: each rank's regions, gathered, are the saved state
    bit for bit."""
    ranks = worlds[world][1]
    want = (_tree_of(ranks[0], f"{world}/tree") if label == "peer"
            else _jax_keyed(jax_ref["host"]["fsdp_tp"]))
    for r in ranks:
        got = _tree_of(r, f"{label}/tree")
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
