"""The manual gradient path (``edl_tpu_torch/train/comm.py``) and the int8
wires (``edl_tpu_torch/ops/pack.py``) against the JAX package's.

- ``all_gather_int8`` and ``all_to_all_int8`` in worlds of 2 and 4 ranks
  give the same int8 payloads, scales and dequantized values as JAX's
  under ``shard_map`` on as many virtual CPU devices, bit for bit; the
  world that runs them runs the ``_reduce_bucket`` cases next.

- ``_reduce_bucket`` with injected per-rank buckets and residuals, compress
  off/topk/int8, on flat worlds of 2 and 4 ranks and on a hybrid 2 slices
  x 2 ranks (gloo subprocesses), against JAX's under ``shard_map`` on
  conftest's virtual CPU devices: the int8 leg's input, payload, scale
  and the new residuals bit for bit; the reduced bucket bit for bit at
  world 2 and on the hybrid world (sums of two), and within 1e-6 of the
  bucket's largest magnitude on the flat world of 4, where a sum of four
  rows may be taken in another order; the topk leg on inputs without
  ties.
- ``CommTrainStep`` against JAX's and the gates: tests/test_torch_comm_step.py.
- Accounting: ``dcn_bytes_per_step``, ``_leg_bytes``, ``dcn_overlap_pct``
  and ``stats()`` keys equal JAX's on ResNet50_vd's plan from shapes
  alone at worlds 2 and 4.
- A world of one with int8: a plain all-reduce of one rank (no wire, no
  K8), bit for bit the plain step.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from edl_tpu.models.resnet import ResNet50_vd as JResNet50_vd
from edl_tpu.ops import pack as jpack
from edl_tpu.parallel import mesh as jmesh
from edl_tpu.parallel.compat import shard_map
from edl_tpu.train import comm as jcomm
from edl_tpu_torch.train import comm
from edl_tpu_torch.train.step import make_train_step
from test_torch_world import World, one_torch_thread  # noqa: F401


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# -- _reduce_bucket ----------------------------------------------------------


def _cases(world: int) -> list[dict]:
    topo = [("flat", world, 1)]
    if world == 4:
        topo.append(("hybrid", 2, 2))
    cases = []
    for label, n_slices, chips in topo:
        for mode in ("off", "topk", "int8"):
            cases.append({"name": f"{label}_{mode}", "mode": mode,
                          "n_slices": 1 if (label, mode) == ("flat", "off")
                          else n_slices, "chips": chips,
                          "config": {"compress": mode, "topk_frac": 0.25,
                                     "min_compress_elems": 16}})
    # a shard under min_compress_elems stays dense even with int8
    cases.append({"name": "small_int8", "mode": "int8", "n_slices": world,
                  "chips": 1, "config": {"compress": "int8",
                                         "min_compress_elems": 4096}})
    return cases


def _reduce_inputs(world: int, n: int = 96) -> dict:
    rng = np.random.default_rng(100 + world)
    inputs = {"cases": np.array(json.dumps(_cases(world)))}
    for case in _cases(world):
        # a dense leg hands its residual back untouched (any width)
        dense = case["mode"] == "off" or case["name"] == "small_int8"
        m = 4 if dense else n // case["chips"]
        inputs[f"{case['name']}/buf"] = rng.normal(
            size=(world, n)).astype(np.float32)
        inputs[f"{case['name']}/resid"] = rng.normal(
            0, 0.05, size=(world, m)).astype(np.float32)
    return inputs


def _jax_reduce(case: dict, buf: np.ndarray, resid: np.ndarray,
                packed: bool):
    world = buf.shape[0]
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    config = jcomm.CommConfig(**case["config"])
    n_slices, chips = case["n_slices"], case["chips"]

    def fn(b, e):
        out, e2 = jcomm._reduce_bucket(b.reshape(-1), e.reshape(-1),
                                       axis="dp", n_slices=n_slices,
                                       chips=chips, config=config)
        return out[None], e2[None]

    def shard_fn(b, e):
        # what the int8 leg packs: u = (reduce-scattered shard) + residual
        s = b.reshape(-1)
        if chips > 1:
            intra, _ = jmesh.dp_comm_groups(n_slices, chips)
            s = jax.lax.psum_scatter(s, "dp", scatter_dimension=0,
                                     axis_index_groups=intra, tiled=True)
        return (s + e.reshape(-1))[None]

    spec = dict(mesh=mesh, in_specs=(P("dp"), P("dp")))
    out, e2 = shard_map(fn, out_specs=(P("dp"), P("dp")), **spec)(
        jnp.asarray(buf), jnp.asarray(resid))
    if not packed:
        return np.asarray(out), np.asarray(e2), None
    u = shard_map(shard_fn, out_specs=P("dp"), **spec)(
        jnp.asarray(buf), jnp.asarray(resid))
    return np.asarray(out), np.asarray(e2), np.asarray(u)


def _wire_inputs(world: int) -> dict:
    rng = np.random.default_rng(world)
    gather = rng.normal(size=(world, 300)).astype(np.float32)
    gather[1] *= 50.0          # unrelated magnitudes across ranks
    a2a = rng.normal(size=(world, world, 37)).astype(np.float32)
    a2a[:, 0] *= 1e-3          # ... and across destination blocks
    return {"gather": gather, "a2a": a2a}


def _jax_wires(inputs: dict, world: int):
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))

    def gather_fn(x):
        g, local = jpack.all_gather_int8(x.reshape(-1), "dp")
        return g[None], local[None]

    def a2a_fn(x):
        return jpack.all_to_all_int8(x[0], "dp")[None]

    g, local = shard_map(gather_fn, mesh=mesh, in_specs=P("dp"),
                         out_specs=(P("dp"), P("dp")))(
        jnp.asarray(inputs["gather"]))
    a2a = shard_map(a2a_fn, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"))(
        jnp.asarray(inputs["a2a"]))
    return np.asarray(g), np.asarray(local), np.asarray(a2a)


@pytest.fixture(scope="module", params=[2, 4])
def wire_world(request, tmp_path_factory):
    """One world of 2 or 4 ranks runs the wires and every _reduce_bucket
    case; this process computes JAX's side while the ranks run. Returns
    (world, inputs, the ranks' results, JAX's wires, JAX's reductions by
    case)."""
    world = request.param
    inputs = {**_wire_inputs(world), **_reduce_inputs(world)}
    ranks = World("wires_reduce", world,
                  tmp_path_factory.mktemp(f"wires{world}"), inputs)
    try:
        wires = _jax_wires(inputs, world)
        reduced = {}
        for case in _cases(world):
            name = case["name"]
            reduced[name] = _jax_reduce(
                case, inputs[f"{name}/buf"], inputs[f"{name}/resid"],
                case["mode"] == "int8" and name != "small_int8")
    finally:
        results = ranks.results()
    return world, inputs, results, wires, reduced


def test_wires_bitwise_with_jax(wire_world):
    """all_gather_int8 and all_to_all_int8 give the same int8 payloads,
    scales and dequantized values as JAX's, bit for bit."""
    world, inputs, ranks, (g, local, a2a), _ = wire_world
    for r, out in enumerate(ranks):
        jq, js = jpack._pack_xla(jnp.asarray(inputs["gather"][r]))
        np.testing.assert_array_equal(out["q"], np.asarray(jq))
        np.testing.assert_array_equal(_bits(out["scale"]), _bits(js))
        np.testing.assert_array_equal(_bits(out["gathered"]), _bits(g[r]))
        np.testing.assert_array_equal(_bits(out["local"]), _bits(local[r]))
        for i in range(world):
            bq, bs = jpack._pack_xla(jnp.asarray(inputs["a2a"][r, i]))
            np.testing.assert_array_equal(out["a2a_q"][i], np.asarray(bq))
            np.testing.assert_array_equal(_bits(out["a2a_scale"][i]),
                                          _bits(bs))
        np.testing.assert_array_equal(_bits(out["a2a"]), _bits(a2a[r]))
    # every rank holds every rank's dequantized contribution
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["gathered"], ranks[0]["gathered"])


def test_reduce_bucket_against_jax(wire_world):
    world, _, ranks, _, reduced = wire_world
    for case in _cases(world):
        name = case["name"]
        packed = case["mode"] == "int8" and name != "small_int8"
        out, resid, u = reduced[name]
        for r, got in enumerate(ranks):
            msg = f"{name} rank {r}"
            np.testing.assert_array_equal(_bits(got[f"{name}/resid"]),
                                          _bits(resid[r]), err_msg=msg)
            if world == 2 or case["chips"] > 1:   # sums of two terms
                np.testing.assert_array_equal(_bits(got[f"{name}/out"]),
                                              _bits(out[r]), err_msg=msg)
            else:   # sums of four, in another order: 1e-6 of the bucket
                np.testing.assert_allclose(
                    got[f"{name}/out"], out[r], rtol=1e-6,
                    atol=1e-6 * np.abs(out[r]).max(), err_msg=msg)
            assert (f"{name}/q" in got) == packed, msg
            if packed:
                np.testing.assert_array_equal(_bits(got[f"{name}/u"]),
                                              _bits(u[r]), err_msg=msg)
                jq, js = jpack._pack_xla(jnp.asarray(u[r]))
                np.testing.assert_array_equal(got[f"{name}/q"],
                                              np.asarray(jq), err_msg=msg)
                np.testing.assert_array_equal(_bits(got[f"{name}/scale"]),
                                              _bits(js), err_msg=msg)
        # every rank holds the same reduced bucket
        for got in ranks[1:]:
            np.testing.assert_array_equal(got[f"{name}/out"],
                                          ranks[0][f"{name}/out"])


# -- accounting --------------------------------------------------------------


@pytest.fixture(scope="module")
def resnet_shapes():
    """ResNet50_vd's parameter shapes in the flax flatten order, from
    shapes alone (jax.eval_shape; no weights are made)."""
    model = JResNet50_vd(num_classes=1000, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 224, 224, 3)), train=False))
    return shapes["params"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", comm.COMPRESS_MODES)
def test_accounting_matches_jax_on_resnet50_vd(resnet_shapes, world, mode):
    jleaves = jax.tree.leaves(resnet_shapes)
    leaves = [torch.empty(leaf.shape, dtype=torch.float32, device="meta")
              for leaf in jleaves]
    assert sum(t.numel() for t in leaves) == 25_576_264
    jplan = jcomm.plan_buckets(resnet_shapes, 4.0, align=world)
    plan = comm.plan_buckets(leaves, 4.0, align=world)
    assert [(b.size, b.padded, [s.leaf for s in b.slots])
            for b in plan.buckets] == [
        (b.size, b.padded, [s.leaf for s in b.slots]) for b in jplan.buckets]
    jcfg = jcomm.CommConfig(compress=mode)
    cfg = comm.CommConfig(compress=mode)
    for n_slices, chips in ((world, 1), (2, world // 2), (1, world)):
        assert comm.dcn_bytes_per_step(plan, cfg, n_slices, chips) == \
            jcomm.dcn_bytes_per_step(jplan, jcfg, n_slices, chips)
    for m in (1, 1000, 1024, 12_345, 2_359_296):
        for itemsize in (2, 4):
            assert comm._leg_bytes(m, itemsize, cfg) == jcomm._leg_bytes(
                m, itemsize, jcfg)
        assert comm._topk_k(m, 0.01) == jcomm._topk_k(m, 0.01)
    mesh = jmesh.make_mesh(jmesh.MeshSpec({"dp": -1}),
                           devices=jax.devices()[:world])
    jstep = jcomm.CommTrainStep(lambda *a: None, mesh=mesh, config=jcfg)
    step = comm.CommTrainStep(lambda *a: None, config=cfg)
    # the port's world is the joined one (1 here): take the JAX step's
    # topology, as a world of `world` ranks would
    step.world, step.n_slices, step.chips = (jstep.world, jstep.n_slices,
                                             jstep.chips)
    assert step.stats().keys() == jstep.stats().keys()
    jstep.plan, step.plan = jplan, plan
    assert step.dcn_bytes_per_step() == jstep.dcn_bytes_per_step()
    assert step.dcn_overlap_pct() == jstep.dcn_overlap_pct()
    assert step.stats() == jstep.stats()
    if mode == "int8":   # the wire the chip run gates: <= 0.26 x fp32's
        fp32 = comm.dcn_bytes_per_step(plan, dataclasses.replace(
            cfg, compress="off"), world, 1)
        assert step.dcn_bytes_per_step() <= 0.26 * fp32


def test_comm_config_validation():
    for bad in ({"compress": "gzip"}, {"bucket_mb": 0},
                {"topk_frac": 0.0}, {"topk_frac": 1.5}):
        with pytest.raises(ValueError):
            comm.CommConfig(**bad)


# -- a world of one ----------------------------------------------------------


def _tiny_problem():
    loss_fn, state_fn, batch = comm._smoke_cnn(1, device="cpu")
    return loss_fn, state_fn, {k: torch.from_numpy(v)
                               for k, v in batch.items()}


def test_world_of_one_with_int8_is_a_plain_step(monkeypatch):
    calls = []
    monkeypatch.setattr(comm, "pack_int8_buckets",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(comm, "all_gather_packed",
                        lambda *a, **k: calls.append(a))
    loss_fn, state_fn, batch = _tiny_problem()
    step = make_train_step(loss_fn, comm=comm.CommConfig(compress="int8"))
    assert isinstance(step, comm.CommTrainStep)
    plain = make_train_step(loss_fn)
    s_comm, s_plain = state_fn(), state_fn()
    for _ in range(3):
        s_comm, m_comm = step(s_comm, batch)
        s_plain, m_plain = plain(s_plain, batch)
        assert float(m_comm["loss"]) == float(m_plain["loss"])
    assert not calls, "the int8 wire ran in a world of one"
    assert (step.n_slices, step.chips) == (1, 1)
    assert step.dcn_bytes_per_step() == 0
    assert all(r.numel() == 0 for r in step.resid)
    assert comm.tree_bitwise_equal(s_comm.model.state_dict(),
                                   s_plain.model.state_dict())


def test_step_counts_dcn_bytes_and_emits_its_span(monkeypatch, tmp_path):
    from edl_tpu_torch.obs import metrics, trace
    monkeypatch.setenv("EDL_TPU_TRACE", str(tmp_path))
    trace.reconfigure()
    try:
        loss_fn, state_fn, batch = _tiny_problem()
        step = comm.make_comm_train_step(
            loss_fn, config=comm.CommConfig(bucket_mb=0.01))
        counter = metrics.registry().counter("step_dcn_bytes")
        before = counter.value
        state = state_fn()
        step(state, batch)
        spans = trace.finished("step.dcn_reduce")
        assert spans and spans[-1]["attrs"]["buckets"] == step.plan.n_buckets
        assert spans[-1]["attrs"]["compress"] == "off"
        assert counter.value == before + step.dcn_bytes_per_step()
        assert step.stats()["comm_steps"] == 1
    finally:
        monkeypatch.delenv("EDL_TPU_TRACE")
        trace.reconfigure()


def test_tree_bitwise_equal():
    a = [torch.tensor([1.0, float("nan")]), torch.tensor([1, 2])]
    assert comm.tree_bitwise_equal(a, [t.clone() for t in a])
    assert not comm.tree_bitwise_equal(a, [a[0] + 1, a[1]])
    assert not comm.tree_bitwise_equal(a, [a[0].double(), a[1]])
    assert not comm.tree_bitwise_equal(a, a[:1])
    assert comm.tree_bitwise_equal({"x": a[0]}, {"x": a[0].clone()})


def test_convergence_smoke_asks_for_cuda_unless_told_the_cpu(monkeypatch):
    """The port's entry points run on CUDA unless the caller passes
    device="cpu": with no card, the default raises instead of moving to
    the CPU; the smoke problems build their models where they are told."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        comm.convergence_smoke("int8", steps=1)
    for smoke in (comm._smoke_cnn, comm._smoke_transformer):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            smoke(1)
        _, state_fn, _ = smoke(1, device="cpu")
        assert all(p.device.type == "cpu"
                   for p in state_fn().model.parameters())
    batch = comm._local_rows({"x": np.arange(6, dtype=np.float32)}, "cpu")
    assert batch["x"].device.type == "cpu" and batch["x"].numel() == 6


def test_convergence_smoke_runs_on_the_device_it_is_given():
    report = comm.convergence_smoke("int8", steps=2, device="cpu")
    assert report["world"] == 1 and report["steps"] == 2
    assert {"cnn", "transformer"} <= report.keys()
    for model in ("cnn", "transformer"):
        assert np.isfinite(report[model]["loss_dense"])
