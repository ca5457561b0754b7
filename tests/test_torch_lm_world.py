"""The world entry points on the CPU: ``lm_train`` over two ranks with
``--mesh dp``, ``--mesh fsdp --ckpt-sharded`` and ``--dcn-compress
int8``, ``multipod_demo`` under a world of two, and
``python -m edl_tpu_torch.train.comm smoke``.

One world of two gloo ranks (``test_torch_world.World``, each run at its
own coordinator) runs the lm_train runs in turn (and ``--fsdp --remat
on``, which must be the fsdp run bit for bit, and dp and fsdp under
``--fp16``) on one set of
shards (2-layer, d=64 transformer, global batch 8, one epoch of 6 steps,
fused fp32 Adam), then multipod_demo. The gates: every run exits 0 and
leaves the world; the ranks' final parameters are bitwise equal (fsdp's
gathered); fsdp's losses are dp's bit for bit (at world 2 every sum is
one addition of two terms, tests/test_torch_fsdp.py holds both against
the JAX package's fsdp mesh step by step); int8 ends within 0.25 x dp's
improvement of dp; the fsdp run's checkpoint holds an index per rank and
restores into a world of one. multipod_demo fits w = 3, b = -1.5 within
0.1. The JAX package's CLIs are not run here: in one process its data
stream is the whole global batch, while each rank of a world reads its
own stride of the epoch's order, so the two runs train on other batches.

The CLI conflicts that this slice ports keep the JAX CLI's words (in
tests/test_torch_train_slice.py; ``--mesh sp`` and ``--moe`` in a world:
tests/test_torch_lm_sp_moe.py). The comm smoke's JSON line has the
JAX CLI's keys: those of ``convergence_smoke``'s report in the JAX
package's source.
"""

import ast
import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world import World, free_port, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
LM_ARGV = ["--rows-per-file", "48", "--vocab", "256", "--seq-len", "128",
           "--d-model", "64", "--n-heads", "2", "--n-layers", "2",
           "--d-ff", "128", "--batch-size", "8", "--epochs", "1",
           "--device", "cpu", "--fused-opt", "fp32", "--lr", "3e-3",
           "--warmup-steps", "1"]
LM_RUNS = {"dp": ["--mesh", "dp"],
           "fsdp": ["--mesh", "fsdp", "--ckpt-sharded"],
           "int8": ["--dcn-compress", "int8", "--comm-bucket-mb", "0.05"],
           "fsdp_remat": ["--fsdp", "--remat", "on"],
           "dp_fp16": ["--mesh", "dp", "--fp16"],
           "fsdp_fp16": ["--mesh", "fsdp", "--fp16"]}


def rank_lm(inputs: dict, directory: Path) -> dict:
    """Each run of ``inputs["runs"]`` in turn (its own coordinator),
    probed: the step's losses and this rank's final parameters."""
    from edl_tpu_torch.examples import lm_train, multipod_demo
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel.sharding import fsdp_spec
    from edl_tpu_torch.train import comm
    from edl_tpu_torch.train import step as step_lib

    seen: dict = {}
    calls = {cls: cls.__call__ for cls in (step_lib.WorldTrainStep,
                                           comm.CommTrainStep)}

    def probe(cls):
        def call(self, state, batch, *rest):
            out = calls[cls](self, state, batch, *rest)
            state, m = out[:2]   # a loss-scaled step also returns ls
            seen["losses"].append(float(m["loss"]))
            seen["state"] = state
            return out
        return call

    for cls in calls:
        cls.__call__ = probe(cls)
    out = {}
    for run in json.loads(str(inputs["runs"])):
        os.environ["EDL_TPU_COORDINATOR"] = run["coordinator"]
        seen["losses"] = []
        main = (multipod_demo.main if run["name"] == "multipod"
                else lm_train.main)
        rc = main(run["argv"])
        name = run["name"]
        out.update({f"{name}/rc": np.array(rc),
                    f"{name}/left": np.array(
                        not distributed.is_initialized()),
                    f"{name}/losses": np.array(seen["losses"])})
        if name != "multipod":
            # this rank's parameters (a sharded leaf's slice), torch layout
            for k, p in seen["state"].params:
                out[f"{name}/params/{k}"] = p.detach().numpy().copy()
                spec = fsdp_spec(p)
                out[f"{name}/dim/{k}"] = np.array(-1 if spec is None
                                                  else spec.dim)
    return out


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_world")
    data = ["--data-dir", str(d / "data")]
    runs = []
    for i, (name, flags) in enumerate(LM_RUNS.items()):
        extra = ["--make-synthetic", "1"] if i == 0 else []
        if name == "fsdp":
            extra += ["--ckpt-dir", str(d / "ckpt")]
        runs.append({"name": name, "argv": [*data, *LM_ARGV, *extra,
                                            *flags]})
    runs.append({"name": "multipod", "argv": [
        "--device", "cpu", "--epochs", "4", "--out", str(d / "mp.json")]})
    for run in runs:
        run["coordinator"] = f"127.0.0.1:{free_port()}"
    ranks = World("test_torch_lm_world:rank_lm", 2, d / "world",
                  {"runs": np.array(json.dumps(runs))}, tcp=True).results()
    return d, ranks


def test_lm_train_world_runs_exit_cleanly(lm_world):
    _, ranks = lm_world
    for name in (*LM_RUNS, "multipod"):
        for r in ranks:
            assert int(r[f"{name}/rc"]) == 0, name
            assert bool(r[f"{name}/left"]), f"{name} left the world up"


@pytest.mark.parametrize("name", ["dp", "int8"])
def test_lm_train_world_ranks_end_bitwise_equal(lm_world, name):
    _, (r0, r1) = lm_world
    keys = [k for k in r0 if k.startswith(f"{name}/params")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_array_equal(r0[f"{name}/losses"],
                                  r1[f"{name}/losses"])


def test_lm_train_fsdp_is_dp_bit_for_bit(lm_world):
    """The ranks' slices put together are dp's parameters, bit for bit,
    and so are the losses."""
    _, (r0, r1) = lm_world
    np.testing.assert_array_equal(r0["fsdp/losses"], r0["dp/losses"])
    names = [k[len("dp/params/"):] for k in r0 if k.startswith("dp/params/")]
    assert sum(int(r0[f"fsdp/dim/{n}"]) >= 0 for n in names) == 14
    for n in names:
        dim = int(r0[f"fsdp/dim/{n}"])
        a, b = r0[f"fsdp/params/{n}"], r1[f"fsdp/params/{n}"]
        got = a if dim < 0 else np.concatenate([a, b], axis=dim)
        np.testing.assert_array_equal(got, r0[f"dp/params/{n}"], err_msg=n)


def test_lm_train_fsdp_under_remat_regathers_in_the_backward(lm_world):
    """--fsdp (the legacy alias) with --remat on: each block's forward,
    its gathers included, runs again in the backward; the run is the
    fsdp run's bit for bit."""
    _, (r0, r1) = lm_world
    np.testing.assert_array_equal(r0["fsdp_remat/losses"],
                                  r0["fsdp/losses"])
    for k in (k for k in r0 if k.startswith("fsdp/params/")):
        name = k[len("fsdp/params/"):]
        np.testing.assert_array_equal(r0[f"fsdp_remat/params/{name}"],
                                      r0[k], err_msg=name)
        np.testing.assert_array_equal(r1[f"fsdp_remat/params/{name}"],
                                      r1[k], err_msg=name)


def test_lm_train_fsdp_under_loss_scaling_is_dp_bit_for_bit(lm_world):
    """--fp16 in a world: the loss-scaled world step (every rank reads
    one all-reduced finite flag); fsdp's losses and slices are dp's bit
    for bit, finite and falling."""
    _, (r0, r1) = lm_world
    losses = r0["fsdp_fp16/losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_array_equal(losses, r0["dp_fp16/losses"])
    np.testing.assert_array_equal(losses, r1["fsdp_fp16/losses"])
    for k in (k for k in r0 if k.startswith("dp_fp16/params/")):
        name = k[len("dp_fp16/params/"):]
        dim = int(r0[f"fsdp_fp16/dim/{name}"])
        a, b = r0[f"fsdp_fp16/params/{name}"], r1[f"fsdp_fp16/params/{name}"]
        got = a if dim < 0 else np.concatenate([a, b], axis=dim)
        np.testing.assert_array_equal(got, r0[k], err_msg=name)


def test_lm_train_world_losses_fall_and_int8_tracks_dp(lm_world):
    _, (r0, _) = lm_world
    dp, int8 = r0["dp/losses"], r0["int8/losses"]
    assert len(dp) == len(int8) == 6
    assert np.isfinite(dp).all() and np.isfinite(int8).all()
    improvement = dp[0] - dp[-1]
    assert improvement > 0, dp
    assert abs(int8[-1] - dp[-1]) <= 0.25 * improvement, (int8, dp)


def test_lm_train_fsdp_checkpoint_is_per_rank_and_restores_whole(lm_world):
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
    from edl_tpu_torch.train import fused_opt
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainState

    d, (r0, _) = lm_world
    saved = d / "ckpt" / "ckpt-0"
    assert {"index.0.json", "index.1.json"} <= set(os.listdir(saved))
    meta = json.loads((saved / "meta.json").read_text())
    assert meta["world"]["process_count"] == 2
    model = Transformer(TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
        max_len=128, dtype=torch.float32), device="cpu", seed=7)
    state = TrainState.create(
        model=model, tx=fused_opt.make_fused_tx("adam", 1e-3, "fp32"),
        params=bridge.flax_named_parameters(model))
    _, status = CheckpointManager(str(d / "ckpt")).restore(state)
    assert status.step == 6
    for n, p in state.params:
        np.testing.assert_array_equal(p.detach().numpy(),
                                      r0[f"dp/params/{n}"], err_msg=n)


def test_multipod_demo_fits_the_line_in_a_world_of_two(lm_world):
    d, ranks = lm_world
    res = json.loads((d / "mp.json").read_text())
    assert res["world"] == 2 and res["step"] == 80
    assert abs(res["w"] - 3.0) < 0.1 and abs(res["b"] + 1.5) < 0.1, res
    np.testing.assert_array_equal(ranks[0]["multipod/losses"],
                                  ranks[1]["multipod/losses"])


def _jax_report_keys() -> tuple[set, set]:
    """The keys of the JAX package's convergence_smoke report (top level,
    and each model's entry), read from its source."""
    tree = ast.parse((ROOT / "edl_tpu" / "train" / "comm.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "convergence_smoke")
    top, per_model = set(), set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.AnnAssign)
                and isinstance(node.value, ast.Dict)
                and getattr(node.target, "id", None) == "report"):
            top.update(k.value for k in node.value.keys)
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if "learned" in keys:
                per_model.update(keys)
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name)
              and node.value.id == "report"
              and isinstance(node.slice, ast.Constant)
              and isinstance(node.ctx, ast.Store)):
            top.add(node.slice.value)
    return top | {"cnn", "transformer"}, per_model


def test_comm_smoke_cli_prints_the_jax_cli_keys():
    from edl_tpu_torch.train import comm

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = comm._main(["smoke", "--device", "cpu", "--slices", "1",
                         "--steps", "20", "--compress", "int8"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    report = line["comm_smoke"]
    top, per_model = _jax_report_keys()
    assert set(report) == top
    for model in ("cnn", "transformer"):
        assert set(report[model]) == per_model
    assert rc == (0 if report["ok"] else 1) and report["world"] == 1


def test_comm_smoke_cli_refuses_moe_naming_its_item():
    """``smoke --moe`` refuses the top-k wire, in the JAX CLI's words
    (token blocks have no sparse wire); it names no ROADMAP item now."""
    from edl_tpu_torch.train import comm
    with pytest.raises(SystemExit, match="--compress int8 only"):
        comm._main(["smoke", "--moe", "--compress", "topk", "--device",
                    "cpu"])


def _jax_moe_report_keys() -> tuple[set, set]:
    """The keys of ``moe_convergence_smoke``'s report and of its parity
    gate, from the JAX package's source."""
    tree = ast.parse((ROOT / "edl_tpu" / "train" / "comm.py").read_text())
    keys = {}
    for name in ("moe_convergence_smoke", "moe_parity_gate"):
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == name)
        out = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value in (
                        "compress", "bitwise_hier") for k in node.keys):
                out.update(k.value for k in node.keys)
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.value, ast.Name)
                  and node.value.id in ("report", "gate")
                  and isinstance(node.slice, ast.Constant)
                  and isinstance(node.ctx, ast.Store)):
                out.add(node.slice.value)
        keys[name] = out
    return keys["moe_convergence_smoke"], keys["moe_parity_gate"]


def test_comm_smoke_cli_moe_prints_the_jax_cli_keys():
    """``smoke --moe`` in a world of one: the JAX CLI's
    ``{"moe_smoke": ...}`` line, its keys and its gate's; the flat world
    sends no cross-slice bytes."""
    from edl_tpu_torch.train import comm

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = comm._main(["smoke", "--moe", "--device", "cpu", "--slices",
                         "1", "--steps", "8"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])["moe_smoke"]
    top, gate = _jax_moe_report_keys()
    assert set(report) == top
    assert set(report["parity_gate"]) == gate
    assert report["parity_gate"]["bitwise_hier"]
    assert report["world"] == 1 and report["moe_dcn_bytes_per_step"] == 0
    assert rc == (0 if report["ok"] else 1)
