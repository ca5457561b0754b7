"""The SPMD world step (``train/step.WorldTrainStep``) with global-batch
BatchNorm, against the JAX package's step on a dp mesh.

JAX's ``_smoke_cnn`` problem (ResNetTiny, fp32, momentum-SGD 0.05/0.9, a
seeded global batch of 16 images) trains 3 steps of the JAX package's
``make_train_step`` with the batch placed over a dp mesh of 2 CPU devices
(``shard_batch``): XLA's partitioned program, BatchNorm statistics over
the global batch. A port world of 2 gloo ranks
(``test_torch_world.World``) takes the same 3 steps from the same weights
(JAX's init, bridged), each rank on its 8 rows. Tolerances are those of
``tests/test_torch_comm_step.py``: losses within 1e-5, parameters and
BatchNorm statistics within 1e-4 (fp32 sums in another order, and flax's
E[x^2] - E[x]^2 variance). The ranks end bitwise equal.

The quantized momentum (``make_fused_tx("sgdm", ..., "int8")``, K6's
plain version here) trains 3 steps of the same world: finite losses
within 0.05 of the fp32 run's, the ranks bitwise equal.

Under dynamic loss scaling (``make_train_step(loss_scale=True,
mesh=...)``, the ``--fp16`` path's step) an overflow planted in rank 1's
batch of step 2 makes both ranks skip that step: the same finite flag,
the scale halved, the parameters and step count as they were.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world import World, one_torch_thread  # noqa: F401

STEPS = 3


def rank_world_step(inputs: dict, directory: Path) -> dict:
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.train import comm
    from edl_tpu_torch.train.amp import DynamicLossScale
    from edl_tpu_torch.train.step import make_train_step

    weights = {k[3:]: torch.from_numpy(v) for k, v in inputs.items()
               if k.startswith("sd/")}
    loss_fn, state_fn, batch = comm._smoke_cnn(2, device="cpu")
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec({"dp": -1}))
    local = mesh_lib.shard_batch(mesh, batch)
    out = {"rows": np.array(local["image"].shape[0])}

    state = comm._loaded(state_fn, weights)()
    step = make_train_step(loss_fn, mesh=mesh)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, local)
        losses.append(float(m["loss"]))
    out["losses"] = np.array(losses)
    out.update({f"sd/{k}": v.numpy() for k, v in
                state.model.state_dict().items()})

    state = comm._loaded(state_fn, weights)()
    step = make_train_step(loss_fn, loss_scale=True, mesh=mesh)
    ls = DynamicLossScale.create()
    finite, scales, counts, digests = [], [], [], []
    for i in range(STEPS):
        b = dict(local)
        if i == 1 and mesh.rank == 1:
            b["image"] = b["image"].clone()
            b["image"][0, 0, 0, 0] = float("inf")
        state, m, ls = step(state, b, ls)
        finite.append(bool(m["finite"]))
        scales.append(float(ls.scale))
        counts.append(state.step)
        digests.append(np.concatenate(
            [p.detach().numpy().ravel() for _, p in state.params]))
    out.update(amp_finite=np.array(finite), amp_scales=np.array(scales),
               amp_counts=np.array(counts), amp_params=np.stack(digests))

    # the quantized momentum (K6's plain version) under the world step
    from edl_tpu_torch.train import classification as cls
    from edl_tpu_torch.train.fused_opt import make_fused_tx
    model = comm._loaded(state_fn, weights)().model
    state = cls.create_state(model, make_fused_tx("sgdm", 0.05, "int8",
                                                  momentum=0.9))
    step = make_train_step(loss_fn, mesh=mesh)
    q_losses = []
    for _ in range(STEPS):
        state, m = step(state, local)
        q_losses.append(float(m["loss"]))
    out["q_losses"] = np.array(q_losses)
    out.update({f"q_sd/{k}": v.numpy() for k, v in
                state.model.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def world_step(tmp_path_factory):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.train import comm as jcomm
    from edl_tpu.train.step import make_train_step as j_make_train_step
    from edl_tpu_torch import bridge

    loss_fn, state, batch = jcomm._smoke_cnn(2)
    host = jax.tree.map(np.asarray, jax.device_get(state))
    sd = bridge.flax_variables_to_torch(
        {"params": host.params, "batch_stats": host.batch_stats})
    world = World("test_torch_world_step:rank_world_step", 2,
                  tmp_path_factory.mktemp("world_step"),
                  {f"sd/{k}": v.numpy() for k, v in sd.items()})
    mesh = jmesh.make_mesh(jmesh.MeshSpec({"dp": -1}),
                           devices=jax.devices()[:2])
    placed = jmesh.shard_batch(mesh, batch)
    s = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, P())),
                     state)
    step = j_make_train_step(loss_fn, donate=False)
    losses = []
    for _ in range(STEPS):
        s, m = step(s, placed)
        losses.append(float(m["loss"]))
    final = jax.device_get(s)
    return world.results(), np.array(losses), {
        "params": final.params, "batch_stats": final.batch_stats}


def test_each_rank_trains_its_slice_of_the_global_batch(world_step):
    ranks, _, _ = world_step
    assert [int(r["rows"]) for r in ranks] == [8, 8]


def test_world_step_losses_match_the_jax_dp_mesh(world_step):
    ranks, want, _ = world_step
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, atol=1e-5, rtol=0)


def test_world_step_params_and_statistics_match_the_jax_dp_mesh(
        world_step):
    import jax

    from edl_tpu_torch import bridge

    ranks, _, want = world_step
    got = bridge.torch_to_flax_variables(
        {k[3:]: torch.from_numpy(v) for k, v in ranks[0].items()
         if k.startswith("sd/")})
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert any("mean" in jax.tree_util.keystr(p) for p, _ in leaves)
    for path, leaf in leaves:
        ours = got
        for k in path:
            ours = ours[k.key]
        np.testing.assert_allclose(np.asarray(ours), np.asarray(leaf),
                                   atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_world_step_ranks_end_bitwise_equal(world_step):
    (r0, r1), _, _ = world_step
    keys = [k for k in r0 if k.startswith("sd/")]
    assert any(k.endswith("running_var") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_array_equal(r0["losses"], r1["losses"])


def test_an_overflow_on_one_rank_skips_the_step_on_every_rank(world_step):
    ranks, _, _ = world_step
    for r in ranks:
        assert r["amp_finite"].tolist() == [True, False, True]
        assert r["amp_counts"].tolist() == [1, 1, 2]
        assert r["amp_scales"][1] == r["amp_scales"][0] / 2
        np.testing.assert_array_equal(r["amp_params"][1],
                                      r["amp_params"][0])
        assert not np.array_equal(r["amp_params"][2], r["amp_params"][1])
    np.testing.assert_array_equal(ranks[0]["amp_params"],
                                  ranks[1]["amp_params"])


def test_quantized_momentum_under_the_world_step(world_step):
    (r0, r1), _, _ = world_step
    assert np.isfinite(r0["q_losses"]).all()
    np.testing.assert_allclose(r0["q_losses"], r0["losses"], atol=0.05)
    for k in (k for k in r0 if k.startswith("q_sd/")):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
