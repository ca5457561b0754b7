"""``lm_train``'s two long-context and expert-parallel steps in the port
against the JAX package's: ``--mesh sp`` (ring attention over the
sequence) and ``--moe`` (the mixture of experts over an ep mesh).

sp: a 2-layer, d=32, vocab-64 fp32 transformer starts from the JAX init
on both sides. The JAX package places it on an sp mesh of 2 CPU devices
(``cfg.mesh``: the dense ring body) and its jitted step takes 2 steps of
fused fp32 Adam on seeded global batches of 4 rows. A port world of 2
gloo ranks (``test_torch_world.World``) takes the same 2 steps through
the world step over an sp mesh: each rank holds the whole batch and its
block of the sequence, ring attention over the two blocks, the loss the
whole sequence's (``models/transformer._sp_loss``), the gradients summed
over sp. Two cases: S=16 (blocks of 8) and S=4 (blocks of 2, where half
the positions of rank 0's block predict a token of rank 1's). Tolerance:
losses and parameters within 1e-5 of the JAX package's (fp32 sums in
another order, Adam's normalization: as tests/test_torch_fsdp.py holds
its fsdp steps).

MoE: a 1-layer MoE transformer (E=4, top 2) from the JAX init; the JAX
package's ``make_moe_comm_step`` on an ep mesh of 2 CPU devices and the
port's ``MoECommStep`` on 2 ranks, each routing its own 4 rows, take 2
steps of fused fp32 Adam; losses and parameters within 1e-5.

The CLI in a world of 2 (``test_torch_lm_world.rank_lm``): ``lm_train
--mesh sp`` and ``--moe --moe-dispatch hier --moe-compress int8`` run,
exit 0, leave the world, end with the ranks' parameters bit for bit
equal and finite losses; the MoE run's benchmark log holds the JAX
step's ``stats()`` keys.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world import World, free_port, one_torch_thread  # noqa: F401

SP_MODEL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)
SP_CASES = {"s16": 16, "s4": 4}
MOE_MODEL = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                 max_len=8, moe=True, n_experts=4, moe_top_k=2)
SCHEDULE = (3e-3, 4, 1)
STEPS = 2
ATOL = 1e-5


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


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


def _port_state(params: dict, cfg):
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models.transformer import Transformer
    from edl_tpu_torch.train import fused_opt, lr
    from edl_tpu_torch.train.state import TrainState

    model = Transformer(cfg, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    model.train()
    tx = fused_opt.make_fused_tx("adam", lr.cosine_with_warmup(*SCHEDULE),
                                 "fp32", weight_decay=0.01)
    return TrainState.create(model=model, tx=tx,
                             params=bridge.flax_named_parameters(model))


def rank_steps(inputs: dict, directory: Path) -> dict:
    """The sp cases, then the MoE steps: losses and final parameters
    (flax layout)."""
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models.transformer import (TransformerConfig,
                                                  lm_loss_fn, lm_loss_moe)
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.parallel.ring_attention import SeqParallel
    from edl_tpu_torch.train.comm import make_moe_comm_step
    from edl_tpu_torch.train.step import make_train_step

    out = {}
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec({"sp": -1}))
    for case, s in SP_CASES.items():
        cfg = TransformerConfig(**SP_MODEL, max_len=s, dtype=torch.float32,
                                sp=SeqParallel.of(mesh))
        state = _port_state(_unflat(inputs, f"{case}/p/"), cfg)
        step = make_train_step(lm_loss_fn, mesh=mesh)
        losses = []
        for toks in inputs[f"{case}/tokens"]:
            state, m = step(state, {"tokens": torch.from_numpy(toks)})
            losses.append(float(m["loss"]))
        out[f"{case}/losses"] = np.array(losses)
        out.update(_flat(bridge.torch_to_flax(state.model.state_dict(),
                                              SP_MODEL["n_heads"]),
                         f"{case}/params/"))

    r, w = distributed.rank(), distributed.world_size()
    cfg = TransformerConfig(**MOE_MODEL, dtype=torch.float32)
    state = _port_state(_unflat(inputs, "moe/p/"), cfg)
    emesh = mesh_lib.make_mesh(mesh_lib.MeshSpec({"ep": -1}))
    step = make_moe_comm_step(
        lambda wire: functools.partial(lm_loss_moe, wire=wire,
                                       aux_weight=cfg.moe_aux_weight),
        mesh=emesh)
    losses = []
    for toks in inputs["moe/tokens"]:
        n = len(toks) // w
        state, m = step(state, {"tokens": torch.from_numpy(
            toks[r * n:(r + 1) * n])})
        losses.append(float(m["loss"]))
    out["moe/losses"] = np.array(losses)
    out.update(_flat(bridge.torch_to_flax(state.model.state_dict(),
                                          MOE_MODEL["n_heads"]),
                     "moe/params/"))
    return out


def _jax_state(model, params, tx_fn):
    from edl_tpu.train.state import TrainState as JTrainState
    return JTrainState.create(apply_fn=model.apply, params=params,
                              tx=tx_fn())


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX package's sp steps (each case) and MoE comm steps, and the
    port's in a world of 2 started from the same inits and batches (the
    world runs while the JAX steps compile). Returns (JAX's, the ranks')."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from flax.core import meta
    from jax.sharding import NamedSharding, PartitionSpec as P

    from edl_tpu.models import transformer as jtfm
    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.parallel import sharding as jshd
    from edl_tpu.train import comm as jcomm
    from edl_tpu.train import fused_opt as jfo
    from edl_tpu.train import lr as jlr
    from edl_tpu.train.step import make_train_step as j_make_train_step

    def tx():
        return jfo.make_fused_tx("adam", jlr.cosine_with_warmup(*SCHEDULE),
                                 "fp32", weight_decay=0.01)

    rng = np.random.default_rng(17)
    mesh = jmesh.make_mesh(jmesh.MeshSpec({"sp": -1}), n_devices=2)
    runs, ref = {}, {}
    for case, s in SP_CASES.items():
        model = jtfm.Transformer(jtfm.TransformerConfig(
            **SP_MODEL, max_len=s, dtype=jnp.float32, mesh=mesh))
        toks0 = jnp.zeros((1, s), jnp.int32)
        params = jshd.init_sharded(
            lambda: model.init(jax.random.PRNGKey(4), toks0, train=False),
            mesh)["params"]
        tokens = rng.integers(0, SP_MODEL["vocab_size"],
                              (STEPS, 4, s)).astype(np.int32)
        runs[case] = (model, params, tokens)
        ref[case] = {"init": jax.tree.map(np.asarray, params),
                     "tokens": tokens}
    cfg = jtfm.TransformerConfig(**MOE_MODEL, dtype=jnp.float32)
    moe_model = jtfm.Transformer(cfg)
    tokens = rng.integers(0, MOE_MODEL["vocab_size"],
                          (STEPS, 8, MOE_MODEL["max_len"])).astype(np.int32)
    moe_params = meta.unbox(moe_model.init(jax.random.PRNGKey(6),
                                           jnp.asarray(tokens[0]),
                                           train=False))["params"]
    ref["moe"] = {"init": jax.tree.map(np.asarray, moe_params),
                  "tokens": tokens}

    inputs = {}
    for case, r in ref.items():
        inputs.update({f"{case}/p/{k}": v
                       for k, v in _flat(r["init"]).items()})
        inputs[f"{case}/tokens"] = r["tokens"]
    world = World("test_torch_lm_sp_moe:rank_steps", 2,
                  tmp_path_factory.mktemp("sp_moe"), inputs)

    for case, (model, params, tokens) in runs.items():
        state = _jax_state(model, params, tx)
        step = j_make_train_step(jtfm.lm_loss_fn, donate=False)
        losses = []
        for t in tokens:
            state, m = step(state, {"tokens": jnp.asarray(t)})
            losses.append(float(m["loss"]))
        ref[case].update(losses=np.array(losses),
                         params=jax.tree.map(np.asarray, state.params))

    def factory(wire):
        wired = jtfm.Transformer(dataclasses.replace(cfg, moe_wire=wire))
        return functools.partial(jtfm.lm_loss_moe,
                                 aux_weight=cfg.moe_aux_weight,
                                 apply_fn=wired.apply)

    emesh = jmesh.make_mesh(jmesh.MeshSpec({"ep": -1}), n_devices=2)
    step = jcomm.make_moe_comm_step(factory, mesh=emesh, donate=False)
    state = jax.tree.map(
        lambda t: jax.device_put(t, NamedSharding(emesh, P())),
        _jax_state(moe_model, moe_params, tx))
    losses = []
    for t in ref["moe"]["tokens"]:
        state, m = step(state, jmesh.shard_batch(emesh, {"tokens": t},
                                                 batch_axes=("ep",)))
        losses.append(float(m["loss"]))
    ref["moe"].update(losses=np.array(losses),
                      params=jax.tree.map(np.asarray, state.params))
    return ref, world.results()


@pytest.fixture(scope="module")
def jax_ref(steps):
    return steps[0]


@pytest.fixture(scope="module")
def port_steps(steps):
    return steps[1]


@pytest.mark.parametrize("case", [*SP_CASES, "moe"])
def test_losses_match_the_jax_steps(jax_ref, port_steps, case):
    for r in port_steps:
        np.testing.assert_allclose(r[f"{case}/losses"],
                                   jax_ref[case]["losses"], atol=ATOL)


@pytest.mark.parametrize("case", [*SP_CASES, "moe"])
def test_parameters_match_the_jax_steps(jax_ref, port_steps, case):
    want = _flat(jax_ref[case]["params"])
    for r in port_steps:
        got = {k[len(f"{case}/params/"):]: v for k, v in r.items()
               if k.startswith(f"{case}/params/")}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL,
                                       err_msg=f"{case} {k}")


def test_sp_ranks_hold_the_same_parameters(port_steps):
    r0, r1 = port_steps
    for k in r0:
        if "/params/" in k:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_the_block_boundary_target_is_counted():
    """The S/n = 2 case's loss is the whole sequence's: on one rank (no
    ring) lm_loss_fn of the same weights and batch is the same number,
    and dropping the boundary target (block r's last position predicting
    block r+1's first token) would change it."""
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lm_loss_fn)

    cfg = TransformerConfig(**SP_MODEL, max_len=4, dtype=torch.float32)
    model = Transformer(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (4, 4)).astype(np.int32))
    with torch.no_grad():
        whole = float(lm_loss_fn(model, {"tokens": toks})[0])
        logits = model(toks)
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    ll = torch.gather(logp, -1, toks[:, 1:].long()[..., None])[..., 0]
    assert float(-ll.mean()) == pytest.approx(whole, abs=1e-6)
    without = float(-torch.cat([ll[:, :1], ll[:, 2:]], 1).mean())
    assert abs(without - whole) > 1e-4


CLI_ARGV = ["--rows-per-file", "16", "--vocab", "64", "--seq-len", "16",
            "--d-model", "32", "--n-heads", "2", "--n-layers", "2",
            "--d-ff", "64", "--batch-size", "4", "--epochs", "1",
            "--device", "cpu", "--fused-opt", "fp32", "--lr", "3e-3",
            "--warmup-steps", "1"]
CLI_RUNS = {"sp": ["--mesh", "sp"],
            "moe": ["--moe", "--moe-dispatch", "hier", "--moe-compress",
                    "int8"]}


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp_moe_cli")
    data = ["--data-dir", str(d / "data")]
    runs = []
    for i, (name, flags) in enumerate(CLI_RUNS.items()):
        extra = ["--make-synthetic", "1"] if i == 0 else []
        runs.append({"name": name, "argv": [
            *data, *CLI_ARGV, *extra, *flags, "--benchmark-log",
            str(d / f"{name}.json")],
            "coordinator": f"127.0.0.1:{free_port()}"})
    ranks = World("test_torch_lm_world:rank_lm", 2, d / "world",
                  {"runs": np.array(json.dumps(runs))}, tcp=True).results()
    return d, ranks


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_lm_train_sp_and_moe_run_in_a_world(cli_world, name):
    _, (r0, r1) = cli_world
    for r in (r0, r1):
        assert int(r[f"{name}/rc"]) == 0
        assert bool(r[f"{name}/left"])
        assert len(r[f"{name}/losses"]) == 4    # 16 rows / batch 4
        assert np.isfinite(r[f"{name}/losses"]).all()
    keys = [k for k in r0 if k.startswith(f"{name}/params")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    if name == "moe":
        assert any(".moe_mlp." in k for k in keys)


def test_the_moe_run_logs_the_jax_step_s_stats(cli_world):
    import ast
    from pathlib import Path as _Path

    d, _ = cli_world
    log = json.loads((d / "moe.json" / "log_0.json").read_text())
    stats = log.get("extra", log)
    src = (_Path(__file__).resolve().parent.parent / "edl_tpu" / "train"
           / "comm.py").read_text()
    tree = ast.parse(src)
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "stats" and "moe_dispatch" in ast.unparse(n))
    want = {k.value for k in ast.walk(fn) if isinstance(k, ast.Constant)
            and isinstance(k.value, str) and k.value.startswith("moe_")}
    flat = json.dumps(stats)
    for k in want:
        assert f'"{k}"' in flat, k
    assert '"moe_compress": "int8"' in flat
