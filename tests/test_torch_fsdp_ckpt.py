"""The two FSDP checkpoint paths the reference runs: a sharded state with
quantized moments (``lm_train --mesh fsdp --fused-opt int8
--ckpt-sharded``) and a sharded save of a world mirrored to a remote
(``EDL_TPU_CKPT_REMOTE`` with ``--ckpt-sharded``).

A port world of 2 gloo ranks (``test_torch_world.World``) holds the fsdp
transformer of tests/test_torch_fsdp.py from the JAX init, takes 2 steps
of the int8 fused Adam (K7's plain version over each rank's slices: m on
the int8 codec, v on fp8's) and saves per-rank chunks with a ``file://``
mirror; then the same with fp32 moments. The optimizer's buckets are
small (BUCKET_MB), so the slices' plan has fewer buckets than the whole
leaves' plan the checkpoint holds. The quantized moments go through
fp32: each rank dequantizes its slices' planes, the leaves are gathered
whole and quantized once a whole-leaf bucket
(``bridge.sharded_state_tree``); a restore dequantizes the whole-leaf
buckets, cuts the rank's slices and requantizes them at their own
buckets' scales (``bridge.flax_to_state_sharded``).

The bound, stated before the run: after a save and a restore, every
moment is within one quantization step (the larger bucket scale of the
saved and the restored plane) of the saved state's fp32 moment. Held for
the JAX package's restore of the chunks onto its fsdp mesh of 2 (its
codec dequantizes its planes) and for a fresh port world's restore.
The fp32 moments restore bit for bit.

The mirror: the remote holds ckpt-N with both ranks' indexes, meta.json
and LATEST; a world whose local dir is empty restores from the mirror
alone, bit for bit the local restore.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_fsdp import SCHEDULE, SMALL, STEPS
from test_torch_world import World, one_torch_thread  # noqa: F401

# small buckets, so the slices' plan and the whole leaves' plan differ
# (32 buckets over the whole leaves, 19 over a rank's slices)
BUCKET_MB = 0.05


def _port_state(params: dict, quant: str, mesh=None):
    """A rank's fsdp state from flax ``params`` with the fused Adam over
    BUCKET_MB buckets (``quant``: fp32, int8 or fp8 moments)."""
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
    mesh = mesh or mesh_lib.make_mesh(mesh_lib.MeshSpec({"fsdp": -1}))
    sharding.shard_module(model, mesh)
    tx = fused_opt.make_fused_tx("adam", lr.cosine_with_warmup(*SCHEDULE),
                                 quant, weight_decay=0.01,
                                 bucket_mb=BUCKET_MB)
    return TrainState.create(model=model, tx=tx,
                             params=bridge.flax_named_parameters(model)), mesh


def _moments(state) -> dict:
    """The fsdp state's fp32 moments as whole-leaf buckets in the flax
    layout (the JAX plan's), and each slice bucket's largest scale of
    each plane (collective: the sharded leaves are gathered)."""
    from edl_tpu_torch import bridge
    from edl_tpu_torch.ops import opt_kernels as ok
    from edl_tpu_torch.parallel.sharding import fsdp_spec, gather_like
    from edl_tpu_torch.train import comm as comm_lib

    st, tx = state.opt_state, state.tx
    quant = bool(st.m) and isinstance(st.m[0], tuple)
    names = [n for n, _ in state.params]
    specs = [fsdp_spec(p) for _, p in state.params]
    shard_plan, full = tx.plan(state.params), bridge._full_plan(tx, state)
    out = {"n_buckets": np.array([len(shard_plan.buckets),
                                  len(full.buckets)])}
    for key, seq, codec in (("m", st.m, tx.quant), ("v", st.v, ok.V_QUANT)):
        fp = ([ok.dequant_plane(pl, codec) for pl in seq] if quant
              else list(seq))
        leaves = [gather_like(t, s) if s is not None else t for t, s in
                  zip(comm_lib.unpack_buckets(fp, shard_plan), specs)]
        for i, (b, pb) in enumerate(zip(
                comm_lib.pack_buckets(leaves, full), full.buckets)):
            out[f"{key}/{i}"] = bridge.bucket_layout(
                b.numpy(), pb, names, SMALL["n_heads"])
        out[f"{key}/scale"] = np.array(max(float(pl.scale) for pl in seq)
                                       if quant else 0.0)
    return out


def rank_quant_ckpt(inputs: dict, directory: Path) -> dict:
    """2 int8 fsdp steps, a sharded save mirrored to ``remote``, then
    restores into fresh states: from the local dir, and from the mirror
    into an empty dir."""
    from edl_tpu_torch.models.transformer import lm_loss_fn
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainStatus
    from edl_tpu_torch.train.step import make_train_step

    params = {}
    for k, v in inputs.items():
        if k.startswith("p/"):
            node = params
            *path, leaf = k[2:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    out = {}
    for quant in ("int8", "fp32"):
        remote = "file://" + str(inputs["remote"]) + f"_{quant}"
        state, mesh = _port_state(params, quant)
        step = make_train_step(lm_loss_fn, mesh=mesh)
        for toks in inputs["tokens"]:
            state, _ = step(state, mesh_lib.shard_batch(mesh,
                                                        {"tokens": toks}))
        out.update({f"{quant}/saved/{k}": v
                    for k, v in _moments(state).items()})
        ckpt = directory / f"ckpt_{quant}"
        mgr = CheckpointManager(str(ckpt), sharded=True, remote=remote)
        mgr.save(state, TrainStatus(epoch=0, step=STEPS, world_size=2))
        mgr.close()
        fresh, _ = _port_state(params, quant, mesh=mesh)
        CheckpointManager(str(ckpt)).restore(fresh)
        out.update({f"{quant}/restored/{k}": v
                    for k, v in _moments(fresh).items()})
        out[f"{quant}/restored/count"] = np.array(
            int(fresh.opt_state.count))
        cold, _ = _port_state(params, quant, mesh=mesh)
        CheckpointManager(str(directory / f"cold_{quant}"
                              f"{distributed.rank()}"),
                          remote=remote).restore(cold)
        out.update({f"{quant}/mirror/{k}": v
                    for k, v in _moments(cold).items()})
    return out


@pytest.fixture(scope="module")
def jax_init():
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from edl_tpu.models.transformer import Transformer as JTransformer
    from edl_tpu.models.transformer import TransformerConfig as JConfig

    model = JTransformer(JConfig(**SMALL, dtype=jnp.float32,
                                 attention="flash"))
    toks0 = jnp.zeros((1, 128), jnp.int32)
    host = jax.tree.map(np.asarray, nn.unbox(jax.jit(
        model.init, static_argnames="train")(jax.random.PRNGKey(1), toks0,
                                             train=False)["params"]))
    return model, host


@pytest.fixture(scope="module")
def quant_world(jax_init, tmp_path_factory):
    from test_torch_fsdp import _flat_params

    _, host = jax_init
    d = tmp_path_factory.mktemp("fsdp_quant_ckpt")
    tokens = np.random.default_rng(8).integers(
        0, SMALL["vocab_size"], (STEPS, 8, 128)).astype(np.int32)
    inputs = {f"p/{k}": v for k, v in _flat_params(host).items()}
    inputs.update(tokens=tokens, remote=np.array(str(d / "remote")))
    ranks = World("test_torch_fsdp_ckpt:rank_quant_ckpt", 2, d / "world",
                  inputs).results()
    return d, ranks


def _buckets(r: dict, prefix: str, key: str) -> list[np.ndarray]:
    n = sum(1 for k in r if k.startswith(f"{prefix}/{key}/")
            and k.split("/")[-1].isdigit())
    return [r[f"{prefix}/{key}/{i}"] for i in range(n)]


def test_the_slices_plan_differs_from_the_whole_leaves(quant_world):
    _, ranks = quant_world
    for r in ranks:
        shards, whole = (int(n) for n in r["int8/saved/n_buckets"])
        assert shards < whole


@pytest.mark.parametrize("key", ["m", "v"])
def test_port_restore_is_within_one_quantization_step(quant_world, key):
    _, ranks = quant_world
    for r in ranks:
        step = max(float(r[f"int8/saved/{key}/scale"]),
                   float(r[f"int8/restored/{key}/scale"]))
        saved, restored = (_buckets(r, f"int8/{p}", key)
                           for p in ("saved", "restored"))
        assert saved and len(saved) == len(restored)
        for a, b in zip(saved, restored):
            assert np.abs(a - b).max() <= step
        assert int(r["int8/restored/count"]) == STEPS
    assert any(np.abs(b).max() > 0
               for b in _buckets(ranks[0], "int8/saved", key))


@pytest.mark.parametrize("key", ["m", "v"])
def test_fp32_moments_restore_bit_for_bit(quant_world, key):
    """The fp32 path over plans that differ: every whole-leaf bucket's
    moments come back into the slices' buckets exactly."""
    _, ranks = quant_world
    for r in ranks:
        saved = _buckets(r, "fp32/saved", key)
        assert saved and int(r["fp32/restored/count"]) == STEPS
        for a, b in zip(saved, _buckets(r, "fp32/restored", key)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", ["int8", "fp32"])
def test_the_mirror_holds_both_ranks_and_restores_alone(quant_world, quant):
    d, ranks = quant_world
    remote = d / f"remote_{quant}"
    versions = sorted(n for n in os.listdir(remote) if n.startswith("ckpt-"))
    assert versions == ["ckpt-0"]
    files = set(os.listdir(remote / "ckpt-0"))
    assert {"index.0.json", "index.1.json", "meta.json"} <= files
    assert (remote / "LATEST").read_text().strip() in ("0", "ckpt-0")
    for r in ranks:
        for key in ("m", "v"):
            for a, b in zip(_buckets(r, f"{quant}/restored", key),
                            _buckets(r, f"{quant}/mirror", key)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", ["m", "v"])
def test_jax_restore_is_within_one_quantization_step(jax_init, quant_world,
                                                     key):
    """The JAX package restores the port's chunks onto its fsdp mesh of 2
    with the int8 fused Adam over the same buckets; its codec's
    dequantized planes are within one step (the plane's scale) of the
    port's saved fp32 moments."""
    import jax

    from edl_tpu.ops import opt_kernels as jok
    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.parallel import sharding as jshd
    from edl_tpu.train import checkpoint as jckpt
    from edl_tpu.train import fused_opt as jfo
    from edl_tpu.train import lr as jlr
    from edl_tpu.train.state import TrainState as JTrainState

    model, _ = jax_init
    d, (r0, _) = quant_world
    mesh = jmesh.make_mesh(jmesh.MeshSpec({"fsdp": -1}), n_devices=2)
    toks0 = np.zeros((1, 128), np.int32)
    params = jshd.init_sharded(
        lambda: model.init(jax.random.PRNGKey(1), toks0, train=False),
        mesh)["params"]
    tx = jfo.make_fused_tx("adam", jlr.cosine_with_warmup(*SCHEDULE),
                           "int8", weight_decay=0.01, bucket_mb=BUCKET_MB)
    target = JTrainState.create(apply_fn=model.apply, params=params, tx=tx)
    got, status = jckpt.CheckpointManager(
        str(d / "world" / "ckpt_int8"), process_index=0).restore(target)
    assert status.step == STEPS and int(got.opt_state.count) == STEPS
    codec = "int8" if key == "m" else jok.V_QUANT
    planes = getattr(got.opt_state, key)
    saved = _buckets(r0, "int8/saved", key)
    assert len(planes) == len(saved)
    for plane, want in zip(planes, saved):
        deq = np.asarray(jok.dequant_plane(plane, codec))
        assert deq.shape == want.shape
        assert np.abs(deq - want).max() <= float(plane.scale)


def test_every_rank_reads_the_temp_dir_before_rank_0_renames_it(
        tmp_path, monkeypatch):
    """A world's sharded save: every rank looks for poison markers in the
    version's temp dir, then a barrier, and only then does rank 0 rename
    the dir (without that barrier a slower rank's listing found the dir
    gone: FileNotFoundError, seen on the card)."""
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.train import checkpoint as ck
    from edl_tpu_torch.train.state import TrainStatus

    events = []
    monkeypatch.setattr(distributed, "barrier",
                        lambda: events.append("barrier"))
    monkeypatch.setattr(distributed, "broadcast_int", lambda v, src=0: v)

    def write(directory, snap):
        os.makedirs(directory, exist_ok=True)
        return []

    monkeypatch.setattr(ck.ckpt_io, "write_snapshot", write)
    listdir, rename = os.listdir, os.rename

    def spy_listdir(path):
        if ".tmp-ckpt-" in str(path):
            events.append("list")
        return listdir(path)

    def spy_rename(a, b):
        events.append("rename")
        return rename(a, b)

    monkeypatch.setattr(ck.os, "listdir", spy_listdir)
    monkeypatch.setattr(ck.os, "rename", spy_rename)
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"), sharded=True)
    assert mgr._save_sharded_world({"chunks": []},
                                   TrainStatus(epoch=0, step=1)) == 0
    tail = events[events.index("list"):]
    assert tail[:3] == ["list", "barrier", "rename"], events
