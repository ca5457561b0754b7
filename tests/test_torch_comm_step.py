"""``CommTrainStep`` and the gates of the manual gradient path
(``edl_tpu_torch/train/comm.py``) against the JAX package's, at world 2.

The ranks (gloo subprocesses, ``test_torch_world.World``) and this
process (JAX under ``shard_map`` on 2 of conftest's virtual CPU devices)
train JAX's ``_smoke_transformer`` and ``_smoke_cnn`` problems
(ResNetTiny, fp32) from the same weights (JAX's init, bridged), 3 steps
of ``CommTrainStep`` per compress mode, buckets of 0.05 MiB (several a
model), top-k at 1/8, shards of 64 elements and more compressed:

- compress off: within the single-device parity bounds (loss 1e-5;
  parameters 1e-5 for the transformer, parameters and batch statistics
  1e-4 for the CNN: fp32 sums in another order, and flax's E[x^2] -
  E[x]^2 batch variance);
- int8 and topk: each step's loss within 5e-3 of JAX's same-mode step
  (``loss_parity_gate``'s envelope), the residual widths JAX's rows;
- the two ranks end bitwise equal;
- the port's gates, from the same weights: ``loss_parity_gate`` (int8)
  bitwise dense and inside its envelope on both problems;
  ``convergence_smoke`` int8 and topk ``ok`` (40 steps, the relative
  envelope 0.25).
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from edl_tpu.parallel import mesh as jmesh
from edl_tpu.train import comm as jcomm
from edl_tpu_torch import bridge
from edl_tpu_torch.train import comm
from test_torch_world import World, as_json, one_torch_thread  # noqa: F401

# several buckets a model; the convergence smoke's wire settings
STEP_CONFIG = dict(bucket_mb=0.05, topk_frac=0.125, min_compress_elems=64)


def _mesh():
    return jmesh.make_mesh(jmesh.MeshSpec({"dp": -1}),
                           devices=jax.devices()[:2])


def _jax_problems() -> dict:
    """JAX's smoke problems at world 2: {model: (loss_fn, state,
    global batch)}."""
    return {"tr": jcomm._smoke_transformer(2, _mesh()),
            "cnn": jcomm._smoke_cnn(2)}


def _bridged(model: str, state) -> dict:
    """A JAX smoke state's variables as the port's state_dict."""
    host = jax.tree.map(np.asarray, jax.device_get(state))
    if model == "tr":
        return bridge.flax_to_torch(host.params)
    return bridge.flax_variables_to_torch(
        {"params": host.params, "batch_stats": host.batch_stats})


def _jax_runs(problems: dict) -> dict:
    """JAX's CommTrainStep on its smoke problems at world 2, 3 steps per
    compress mode: {model: {mode: (losses, final variables, residual
    widths)}}."""
    mesh = _mesh()
    runs = {}
    for model, (loss_fn, state, batch) in problems.items():
        placed = jmesh.shard_batch(mesh, batch)
        runs[model] = {}
        for mode in comm.COMPRESS_MODES:
            step = jcomm.make_comm_train_step(
                loss_fn, mesh=mesh, donate=False,
                config=jcomm.CommConfig(compress=mode, **STEP_CONFIG))
            s = jax.tree.map(
                lambda a: jax.device_put(a, NamedSharding(mesh, P())), state)
            losses = []
            for _ in range(3):
                s, m = step(s, placed)
                losses.append(float(m["loss"]))
            final = {"params": jax.device_get(s.params)}
            if model == "cnn":
                final["batch_stats"] = jax.device_get(s.batch_stats)
            runs[model][mode] = (np.array(losses), final,
                                 [int(c.shape[1]) for c in step._comm])
    return runs


@pytest.fixture(scope="module")
def comm_world(tmp_path_factory):
    problems = _jax_problems()
    inputs = {"config": np.array(json.dumps(STEP_CONFIG))}
    for model, (_, state, _) in problems.items():
        inputs.update({f"{model}/{k}": v.numpy()
                       for k, v in _bridged(model, state).items()})
    # the ranks train while this process runs JAX's steps
    world = World("comm_steps", 2, tmp_path_factory.mktemp("comm"), inputs)
    runs = _jax_runs(problems)
    return world.results(), runs, {m: p[2] for m, p in problems.items()}


def _port_tree(out: dict, prefix: str, model: str) -> dict:
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in out.items()
          if k.startswith(prefix)}
    return (bridge.torch_to_flax(sd, n_heads=2) if model == "tr"
            else bridge.torch_to_flax_variables(sd))


def _close_tree(got: dict, want: dict, atol: float, what: str) -> None:
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        ours = got
        for k in path:
            ours = ours[k.key]
        np.testing.assert_allclose(np.asarray(ours), np.asarray(leaf),
                                   atol=atol, rtol=0,
                                   err_msg=f"{what} "
                                   f"{jax.tree_util.keystr(path)}")


def test_smoke_problems_are_the_jax_package_s(comm_world):
    _, _, batches = comm_world
    for model, smoke in (("tr", comm._smoke_transformer),
                         ("cnn", comm._smoke_cnn)):
        _, _, batch = smoke(2, device="cpu")
        assert batch.keys() == batches[model].keys()
        for k in batch:
            np.testing.assert_array_equal(batch[k], batches[model][k])


@pytest.mark.parametrize("model,param_atol", [("tr", 1e-5), ("cnn", 1e-4)])
def test_comm_step_dense_matches_jax(comm_world, model, param_atol):
    ranks, runs, _ = comm_world
    losses, final, widths = runs[model]["off"]
    got = ranks[0]
    np.testing.assert_allclose(got[f"{model}/off/losses"], losses,
                               atol=1e-5, rtol=0)
    tree = _port_tree(got, f"{model}/off/sd/", model)
    if model == "tr":
        _close_tree(tree, final["params"], param_atol, model)
    else:
        _close_tree(tree, final, param_atol, model)
    assert got[f"{model}/off/resid_widths"].tolist() == widths


@pytest.mark.parametrize("model", ["tr", "cnn"])
@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_comm_step_compressed_tracks_jax(comm_world, model, mode):
    ranks, runs, _ = comm_world
    losses, _, widths = runs[model][mode]
    got = ranks[0]
    np.testing.assert_allclose(got[f"{model}/{mode}/losses"], losses,
                               atol=5e-3, rtol=0)
    assert got[f"{model}/{mode}/resid_widths"].tolist() == widths
    assert any(widths), "no bucket took the compressed wire"
    stats = as_json(got[f"{model}/{mode}/stats"])
    assert stats["dcn_compress"] == mode and stats["comm_steps"] == 3


def test_comm_step_ranks_stay_in_lockstep(comm_world):
    ranks, _, _ = comm_world
    keys = [k for k in ranks[0] if "/sd/" in k or k.endswith("/losses")]
    assert len(keys) > 20
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("model", ["transformer", "cnn"])
def test_loss_parity_gate_at_world_two(comm_world, model):
    ranks, _, _ = comm_world
    gate = as_json(ranks[0][f"gate/{model}"])
    assert gate["bitwise_dense"] is True and gate["dense_loss_delta"] == 0.0
    assert gate["loss_envelope_ok"] is True and gate["ok"] is True, gate
    assert gate["max_loss_delta"] <= 5e-3 and gate["steps"] == 3


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_convergence_smoke_at_world_two(comm_world, mode):
    ranks, _, _ = comm_world
    report = as_json(ranks[0][f"smoke/{mode}"])
    assert report["world"] == 2 and report["compress"] == mode
    for model in ("cnn", "transformer"):
        assert report[model]["learned"], report
        assert report[model]["within_envelope"], report
    assert report["ok"] is True
