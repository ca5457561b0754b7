"""The port's mixture of experts (``models/transformer.py``'s router and
``MoEMLP``, ``train/comm.py``'s dispatch wire and step) against the JAX
package's: the port's counterparts of each case of ``tests/test_moe.py``,
and the two packages on the same inputs.

In process: ``moe_capacity``; ``router_topk``'s shapes, choice-major
drops and balance score; the config's validation; the ep mesh plumbing;
the dispatch config's validation; the MoE step's refusal of other
meshes; the wire's byte arithmetic. Against the JAX package on the same
logits, ``router_topk``'s dispatch is equal and its combine and aux terms
within 1e-6 (a three-operand einsum summed in another order); on
bridged parameters, a 2-layer MoE transformer's logits and
``lm_loss_moe`` within 1e-5 and its gradients within 5e-5 (fp32).

In a world of 4 gloo ranks laid out as 2 slices x 2 (the JAX tests use
8 virtual devices as 2 x 4; 4 keeps the world's start cheap): the
hierarchical all-to-all bit for bit the flat one (and the S=W, C=1
decomposition too); the int8 leg per destination block, its error
bounded by the small blocks' scale, and its forward and gradient equal
to the JAX package's under ``shard_map`` on 4 virtual devices (forward
within one rounding of the scale, gradient within 1e-6); the wire's
combine inverting its dispatch bit for bit; ``moe_parity_gate`` through
two training steps
(hier bit for bit with flat, int8 inside a 0.2 loss envelope); and the
step's ``stats()``, ``step_moe_dcn_bytes`` counter and
``step.moe_dispatch`` span.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world import World, one_torch_thread  # noqa: F401

WORLD = 4
TOPO = (2, 2)


# -- router ------------------------------------------------------------------


def test_moe_capacity_arithmetic():
    from edl_tpu_torch.models import transformer as tfm
    assert tfm.moe_capacity(64, 8, 2, 1.25) == 20
    assert tfm.moe_capacity(1, 64, 1, 0.1) == 1
    assert tfm.moe_capacity(16, 4, 1, 1.0) == 4


def test_router_topk_shapes_and_renormalized_gates():
    from edl_tpu_torch.models import transformer as tfm
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(12, 4)).astype(np.float32))
    combine, dispatch, aux = tfm.router_topk(logits, top_k=2, capacity=12)
    assert combine.shape == (12, 4, 12) and dispatch.shape == (12, 4, 12)
    assert dispatch.dtype == torch.bool
    assert float(aux["dropped_frac"]) == 0.0
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(), 1.0,
                               rtol=1e-5)


def test_router_capacity_drop_is_exact_and_choice_major():
    from edl_tpu_torch.models import transformer as tfm
    t, e, cap = 8, 4, 3
    logits = np.full((t, e), -10.0, np.float32)
    logits[:, 0] = 2.0
    logits[:, 1] = 1.0
    combine, dispatch, aux = tfm.router_topk(torch.from_numpy(logits),
                                             top_k=2, capacity=cap)
    d = dispatch.numpy()
    assert d[:, 0].sum() == cap and d[:, 1].sum() == cap
    assert d[:, 2:].sum() == 0
    assert d[:3, 0].sum() == cap and d[3:, 0].sum() == 0
    assert float(aux["dropped_frac"]) == pytest.approx(10 / 16)
    c = combine.numpy()
    assert (c[d] > 0).all() and (c[~d] == 0).all()


def test_router_perfect_balance_scores_one():
    from edl_tpu_torch.models import transformer as tfm
    _, _, aux = tfm.router_topk(torch.zeros(8, 4), top_k=1, capacity=8)
    assert float(aux["load_balance"]) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("top_k,capacity", [(2, 5), (1, 3), (2, 12)])
def test_router_topk_is_the_jax_router(top_k, capacity):
    import jax.numpy as jnp

    from edl_tpu.models import transformer as jtfm
    from edl_tpu_torch.models import transformer as tfm

    logits = np.random.default_rng(9).normal(size=(12, 4)).astype(
        np.float32)
    jc, jd, jaux = jtfm.router_topk(jnp.asarray(logits), top_k, capacity)
    c, d, aux = tfm.router_topk(torch.from_numpy(logits), top_k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    for k in ("load_balance", "dropped_frac"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), abs=1e-6)


def test_transformer_config_moe_validation():
    from edl_tpu_torch.models import transformer as tfm
    common = dict(vocab_size=8, d_model=8, n_heads=1, n_layers=1,
                  d_ff=8, max_len=4)
    with pytest.raises(ValueError, match="n_experts"):
        tfm.TransformerConfig(**common, moe=True, n_experts=1)
    with pytest.raises(ValueError, match="moe_top_k"):
        tfm.TransformerConfig(**common, moe=True, n_experts=4, moe_top_k=5)
    with pytest.raises(ValueError, match="moe_capacity_factor"):
        tfm.TransformerConfig(**common, moe=True, n_experts=4,
                              moe_capacity_factor=0.0)
    tfm.TransformerConfig(**common, n_experts=1)


def test_lm_loss_moe_collects_router_aux():
    from edl_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_heads=2,
                                n_layers=2, d_ff=32, max_len=8,
                                dtype=torch.float32, moe=True, n_experts=4)
    model = tfm.Transformer(cfg, device="cpu")
    toks = torch.arange(32).reshape(4, 8) % 16
    loss, metrics = tfm.lm_loss_moe(model, {"tokens": toks})
    assert float(loss.detach()) > 0
    assert {"ppl", "moe_balance", "moe_dropped"} <= set(metrics)
    assert float(metrics["moe_balance"]) > 0
    assert 0.0 <= float(metrics["moe_dropped"]) <= 1.0


# -- the MoE model against the JAX package's ---------------------------------

MODEL = dict(vocab_size=16, d_model=16, n_heads=2, n_layers=2, d_ff=32,
             max_len=8, moe=True, n_experts=4, moe_top_k=2)


@pytest.fixture(scope="module")
def jax_moe():
    """The JAX MoE transformer's init, logits, lm_loss_moe and its
    gradients on a seeded batch."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax.core import meta

    from edl_tpu.models import transformer as jtfm
    from edl_tpu.train.state import TrainState

    model = jtfm.Transformer(jtfm.TransformerConfig(**MODEL,
                                                    dtype=jnp.float32))
    toks = np.random.default_rng(3).integers(0, 16, (4, 8)).astype(np.int32)
    params = meta.unbox(model.init(jax.random.PRNGKey(2),
                                   jnp.asarray(toks), train=False))["params"]
    state = TrainState.create(apply_fn=model.apply, params=params,
                              tx=optax.sgd(0.1))
    logits = jax.jit(lambda p, t: model.apply({"params": p}, t, train=True))(
        params, jnp.asarray(toks))

    def loss(p):
        return jtfm.lm_loss_moe(state, p, {"tokens": jnp.asarray(toks)})

    (value, metrics), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return {"params": jax.tree.map(np.asarray, params), "tokens": toks,
            "logits": np.asarray(logits), "loss": float(value),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree.map(np.asarray, grads)}


def _port_moe(params):
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models import transformer as tfm

    model = tfm.Transformer(tfm.TransformerConfig(**MODEL,
                                                  dtype=torch.float32),
                            device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    model.train()
    return model


def test_moe_model_logits_are_the_jax_model_s(jax_moe):
    model = _port_moe(jax_moe["params"])
    got = model(torch.from_numpy(jax_moe["tokens"])).detach().numpy()
    np.testing.assert_allclose(got, jax_moe["logits"], atol=1e-5)


def test_lm_loss_moe_and_its_gradients_are_the_jax_package_s(jax_moe):
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models import transformer as tfm

    model = _port_moe(jax_moe["params"])
    loss, metrics = tfm.lm_loss_moe(
        model, {"tokens": torch.from_numpy(jax_moe["tokens"])})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jax_moe["loss"], abs=1e-5)
    for k, v in jax_moe["metrics"].items():
        assert float(metrics[k]) == pytest.approx(v, abs=1e-5), k
    got = bridge.grads_to_flax(model, MODEL["n_heads"])
    import jax
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax_moe["grads"])[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, want, atol=5e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_the_bridge_carries_the_moe_leaves_both_ways(jax_moe):
    from edl_tpu_torch import bridge
    model = _port_moe(jax_moe["params"])
    names = {n for n, _ in model.named_parameters()}
    assert {"block0.moe_mlp.router", "block0.moe_mlp.w_in",
            "block0.moe_mlp.w_out"} <= names
    assert not any("mlp_in" in n for n in names)
    back = bridge.torch_to_flax(model.state_dict(), MODEL["n_heads"])
    import jax
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax_moe["params"])[0]:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, want)


# -- ep mesh plumbing --------------------------------------------------------


def test_dcn_axis_of_prefers_ep():
    from edl_tpu_torch.parallel import mesh as mesh_lib
    assert mesh_lib.dcn_axis_of({"dp": 4}) == "dp"
    assert mesh_lib.dcn_axis_of({"ep": 4}) == "ep"
    assert mesh_lib.dcn_axis_of({"dp": 2, "ep": 4}) == "ep"


def test_resolve_hybrid_ep_carries_dcn():
    from edl_tpu_torch.parallel import mesh as mesh_lib
    spec = mesh_lib.MeshSpec({"ep": -1})
    topo = mesh_lib.SliceTopology(2, 4)
    dcn, ici = spec.resolve_hybrid(topo)
    assert dcn == {"ep": 2} and ici == {"ep": 4}
    with pytest.raises(ValueError, match="not divisible by n_slices"):
        mesh_lib.MeshSpec({"ep": 3}).resolve_hybrid(topo)
    with pytest.raises(ValueError, match="carry the DCN"):
        mesh_lib.MeshSpec({"tp": 8}).resolve_hybrid(topo)


def test_ep_comm_groups_mirror_dp():
    from edl_tpu_torch.parallel import mesh as mesh_lib
    assert mesh_lib.ep_comm_groups(2, 4) == mesh_lib.dp_comm_groups(2, 4)
    intra, cross = mesh_lib.ep_comm_groups(2, 4)
    assert intra == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert cross == [[0, 4], [1, 5], [2, 6], [3, 7]]
    with pytest.raises(ValueError, match="positive factors"):
        mesh_lib.ep_comm_groups(0, 4)


def test_expert_tables_shard_over_ep():
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.parallel.sharding import (logical_names,
                                                 logical_to_spec)
    mesh = mesh_lib.Mesh(np.arange(8), ("ep",))
    assert logical_to_spec(("expert", "embed", "mlp"), mesh=mesh) == ("ep",)
    assert logical_to_spec(("embed", "expert_router"), mesh=mesh) == ()
    assert logical_names(("block0", "moe_mlp", "w_in")) == (
        "expert", "embed", "mlp")
    assert logical_names(("block3", "moe_mlp", "router")) == (
        "embed", "expert_router")


def test_moe_dispatch_config_validation():
    from edl_tpu_torch.train import comm
    with pytest.raises(ValueError, match="mode"):
        comm.MoEDispatchConfig(mode="ring")
    with pytest.raises(ValueError, match="compress"):
        comm.MoEDispatchConfig(compress="topk")
    with pytest.raises(ValueError, match="hier"):
        comm.MoEDispatchConfig(mode="flat", compress="int8")


def test_moe_step_rejects_foreign_meshes():
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.train import comm
    lf = lambda wire: None  # noqa: E731 — never reached
    with pytest.raises(ValueError, match="needs an ep axis"):
        comm.make_moe_comm_step(lf, mesh=mesh_lib.Mesh(np.arange(1),
                                                       ("dp",)))
    mixed = mesh_lib.Mesh(np.arange(4).reshape(2, 2), ("ep", "tp"))
    with pytest.raises(ValueError, match="ep-only"):
        comm.make_moe_comm_step(lf, mesh=mixed)
    # the port's step runs over the joined world (here a world of one)
    with pytest.raises(ValueError, match="not the joined world"):
        comm.make_moe_comm_step(lf, mesh=mesh_lib.Mesh(np.arange(2),
                                                       ("ep",)))


def test_moe_wire_rejects_indivisible_experts():
    from edl_tpu_torch.train import comm
    wire = comm.MoEWire(n_slices=2, chips=4,
                        config=comm.MoEDispatchConfig())
    with pytest.raises(ValueError, match="not divisible by ep"):
        wire.dispatch(torch.zeros(6, 2, 2))


def test_moe_leg_bytes_ratio():
    from edl_tpu.train import comm as jcomm
    from edl_tpu_torch.train import comm
    blk, s, c = 5 * 4, 2, 4
    dense = comm.moe_leg_bytes(blk, 4, s, c, "off")
    int8 = comm.moe_leg_bytes(blk, 4, s, c, "int8")
    assert dense == (s - 1) * c * blk * 4
    assert int8 == (s - 1) * c * blk + (s - 1) * 4
    assert dense / int8 >= 3.0
    assert comm.moe_leg_bytes(blk, 4, 1, 8, "off") == 0
    for args in [(blk, 4, s, c, "off"), (blk, 2, 4, 2, "int8"),
                 (7, 4, 8, 1, "int8")]:
        assert comm.moe_leg_bytes(*args) == jcomm.moe_leg_bytes(*args)


# -- the dispatch wire and the step in a world of 4 ---------------------------


def _tiny_moe(world: int):
    """The JAX test's smallest trainable MoE problem, the port's seeded
    init: one block, E = 2 * world experts."""
    from edl_tpu_torch.bridge import flax_named_parameters
    from edl_tpu_torch.models import transformer as tfm
    from edl_tpu_torch.train import state as state_lib
    from edl_tpu_torch.train.state import TrainState

    vocab, seq = 16, 8
    toks = np.random.default_rng(5).integers(
        0, vocab, size=(2 * world, seq)).astype(np.int32)
    cfg = tfm.TransformerConfig(vocab_size=vocab, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32, max_len=seq,
                                dtype=torch.float32, moe=True,
                                n_experts=2 * world, moe_top_k=2)

    def state_fn():
        model = tfm.Transformer(cfg, device="cpu", seed=0)
        model.train()
        return TrainState.create(model=model,
                                 tx=state_lib.sgd(0.3, momentum=0.9),
                                 params=flax_named_parameters(model))

    def loss_factory(wire):
        return functools.partial(tfm.lm_loss_moe,
                                 aux_weight=cfg.moe_aux_weight, wire=wire)

    return loss_factory, state_fn, {"tokens": toks}


def rank_moe(inputs: dict, directory: Path) -> dict:
    """The wire and the step on 2 slices x 2 ranks."""
    from edl_tpu_torch.obs import trace
    from edl_tpu_torch.obs import metrics as obs_metrics
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.train import comm

    r = distributed.rank()
    topo = mesh_lib.SliceTopology(*TOPO)
    groups = mesh_lib.comm_groups(*TOPO)
    out = {}
    x = torch.from_numpy(inputs["a2a"][r])
    for name, kw in {"flat": dict(n_slices=2, chips=2, mode="flat"),
                     "hier": dict(n_slices=2, chips=2, groups=groups),
                     "int8": dict(n_slices=2, chips=2, groups=groups,
                                  compress="int8")}.items():
        out[f"a2a/{name}"] = comm.moe_all_to_all(x, **kw).numpy()
    out["a2a/hier_w1"] = comm.moe_all_to_all(x, n_slices=WORLD,
                                             chips=1).numpy()
    g = torch.from_numpy(inputs["grad_x"][r]).requires_grad_()
    y = comm.moe_all_to_all(g, n_slices=2, chips=2, groups=groups,
                            compress="int8")
    (y * torch.from_numpy(inputs["grad_w"][r])).sum().backward()
    out["int8/y"] = y.detach().numpy()
    out["int8/dx"] = g.grad.numpy()

    mesh = mesh_lib.make_hybrid_mesh(mesh_lib.MeshSpec({"ep": -1}), topo)
    wire = comm.MoEWire(n_slices=2, chips=2, index=mesh.coords["ep"],
                        config=comm.MoEDispatchConfig(mode="hier"),
                        groups=groups)
    buf = torch.from_numpy(inputs["buf"][r])
    recv = wire.dispatch(buf)
    out["wire/recv_shape"] = np.array(recv.shape)
    out["wire/back"] = wire.combine(recv).numpy()

    loss_factory, state_fn, batch = _tiny_moe(WORLD)
    local = {"tokens": torch.from_numpy(batch["tokens"][2 * r:2 * r + 2])}
    gate = comm.moe_parity_gate(
        loss_factory, state_fn, local, mesh=mesh, topology=topo,
        comm_config=comm.CommConfig(bucket_mb=0.25),
        moe_config=comm.MoEDispatchConfig(mode="hier", compress="int8"),
        steps=2, envelope=0.2)
    for k, v in gate.items():
        out[f"gate/{k}"] = np.array(v)

    spans = []

    class _Span:
        def __init__(self, name, attrs):
            spans.append((name, dict(attrs or {})))

        def end(self):
            pass

    trace.start_span = lambda name, parent=None, attrs=None: _Span(name,
                                                                    attrs)
    counter = obs_metrics.registry().counter("step_moe_dcn_bytes")
    before = counter.value
    step = comm.make_moe_comm_step(
        loss_factory, mesh=mesh, topology=topo,
        config=comm.CommConfig(bucket_mb=0.25),
        moe_config=comm.MoEDispatchConfig(mode="hier", compress="int8"))
    s = state_fn()
    for _ in range(2):
        s, metrics = step(s, local)
    stats = step.stats()
    for k in ("moe_dispatch", "moe_compress", "moe_dispatch_legs",
              "moe_dcn_bytes_per_step", "moe_dispatch_overlap_pct"):
        out[f"stats/{k}"] = np.array(stats[k])
    out["stats/metrics"] = np.array(sorted(metrics))
    out["stats/counter"] = np.array(counter.value - before)
    moe_spans = [a for n, a in spans if n == "step.moe_dispatch"]
    out["stats/n_spans"] = np.array(len(moe_spans))
    out["stats/span_bytes"] = np.array(moe_spans[-1]["moe_dcn_bytes"])
    out["stats/span_mode"] = np.array(moe_spans[-1]["mode"])
    flat = comm.make_moe_comm_step(
        loss_factory, mesh=mesh, topology=topo,
        config=comm.CommConfig(bucket_mb=0.25),
        moe_config=comm.MoEDispatchConfig(mode="flat"))
    flat(state_fn(), local)
    out["stats/flat_bytes"] = np.array(flat.moe_dcn_bytes_per_step())
    return out


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    rng = np.random.default_rng(1)
    a2a = rng.normal(size=(WORLD, WORLD, 3, 5)).astype(np.float32)
    # everything bound for slice 0 (ranks 0, 1) is 100x the rest
    a2a[:, :2] *= 100.0
    inputs = {"a2a": a2a,
              "grad_x": rng.normal(size=(WORLD, WORLD, 3, 5)).astype(
                  np.float32),
              "grad_w": rng.normal(size=(WORLD, WORLD, 3, 5)).astype(
                  np.float32),
              "buf": rng.normal(size=(WORLD, 2 * WORLD, 3, 4)).astype(
                  np.float32)}
    res = World("test_torch_moe:rank_moe", WORLD,
                tmp_path_factory.mktemp("moe"), inputs).results()
    return inputs, res


def test_hier_all_to_all_bitwise_with_flat(moe_world):
    inputs, res = moe_world
    for r in res:
        np.testing.assert_array_equal(r["a2a/flat"], r["a2a/hier"])
        np.testing.assert_array_equal(r["a2a/flat"], r["a2a/hier_w1"])
    # the flat all-to-all: rank d receives block d of every source
    for d, r in enumerate(res):
        np.testing.assert_array_equal(r["a2a/flat"], inputs["a2a"][:, d])


def test_hier_all_to_all_int8_bounded_and_per_dest_scaled(moe_world):
    _, res = moe_world
    # ranks 2 and 3 (slice 1) receive only the small payloads; the int8
    # leg carries blocks between the slices at their own scales
    for d, r in enumerate(res):
        err = np.abs(r["a2a/int8"] - r["a2a/hier"])
        amax = np.abs(r["a2a/hier"]).max()
        assert err.max() <= amax / 254 * 1.05 + 1e-6
    small = max(np.abs(res[d]["a2a/int8"] - res[d]["a2a/hier"]).max()
                for d in (2, 3))
    big = max(np.abs(res[d]["a2a/hier"]).max() for d in (0, 1))
    assert big / 254 > 10 * small


def test_moe_wire_combine_inverts_dispatch(moe_world):
    inputs, res = moe_world
    for r, out in enumerate(res):
        assert tuple(out["wire/recv_shape"]) == (2, WORLD * 3, 4)
        np.testing.assert_array_equal(out["wire/back"], inputs["buf"][r])


def test_int8_leg_forward_and_gradient_are_the_jax_package_s(moe_world):
    """The int8 cross leg's values within one rounding of JAX's scale
    (jitted, XLA on the CPU forms amax/127 one ulp away from the IEEE
    division in a few blocks out of a hundred: every element of such a
    block moves by that ulp, 2.5e-7 relative), and its gradient (the
    derivative of JAX's expression: the scales carry it) within 1e-6."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.parallel.compat import shard_map
    from edl_tpu.train import comm as jcomm

    inputs, res = moe_world
    mesh = jmesh.make_hybrid_mesh(jmesh.MeshSpec({"ep": -1}),
                                  jmesh.SliceTopology(*TOPO), n_devices=4)
    x = jnp.asarray(inputs["grad_x"].reshape(WORLD * WORLD, 3, 5))
    w = jnp.asarray(inputs["grad_w"].reshape(WORLD * WORLD, 3, 5))

    def fn(x):
        return shard_map(functools.partial(
            jcomm.moe_all_to_all, axis="ep", n_slices=2, chips=2,
            mode="hier", compress="int8"), mesh=mesh, in_specs=(P("ep"),),
            out_specs=P("ep"))(x)

    y = np.asarray(jax.jit(fn)(x)).reshape(WORLD, WORLD, 3, 5)
    dx = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(fn(x) * w)))(x)
                    ).reshape(WORLD, WORLD, 3, 5)
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["int8/y"], y[r], rtol=2.5e-7,
                                   atol=0)
        np.testing.assert_allclose(out["int8/dx"], dx[r], atol=1e-6)
    assert np.abs(dx).max() > 0


def test_moe_parity_gate_hier_bitwise_and_int8_enveloped(moe_world):
    _, res = moe_world
    for r in res:
        assert bool(r["gate/bitwise_hier"])
        assert float(r["gate/hier_loss_delta"]) == 0.0
        assert bool(r["gate/loss_envelope_ok"]), float(
            r["gate/max_loss_delta"])
        assert bool(r["gate/ok"])


def test_moe_step_stats_counter_and_span(moe_world):
    _, res = moe_world
    for r in res:
        assert str(r["stats/moe_dispatch"]) == "hier"
        assert str(r["stats/moe_compress"]) == "int8"
        assert int(r["stats/moe_dispatch_legs"]) == 2   # one layer
        per_step = int(r["stats/moe_dcn_bytes_per_step"])
        assert per_step > 0
        assert float(r["stats/moe_dispatch_overlap_pct"]) == 50.0
        assert int(r["stats/counter"]) == 2 * per_step
        assert {"loss", "moe_dropped"} <= set(r["stats/metrics"].tolist())
        assert int(r["stats/n_spans"]) == 2
        assert str(r["stats/span_mode"]) == "hier"
        assert int(r["stats/span_bytes"]) == per_step
        assert int(r["stats/flat_bytes"]) >= 3 * per_step


def test_a_moe_checkpoint_has_the_jax_package_s_bytes(jax_moe):
    """The MoE model's TrainState with the fused fp32 Adam after one JAX
    step: the port's tree, written from those bytes, serializes to
    flax's bytes byte for byte (the MoE leaves in the buckets too)."""
    import functools

    import jax
    import jax.numpy as jnp
    from flax import serialization as fser

    from edl_tpu.models import transformer as jtfm
    from edl_tpu.train import fused_opt as jfo
    from edl_tpu.train.state import TrainState as JTrainState
    from edl_tpu.train.step import make_train_step as j_make_train_step
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models import transformer as tfm
    from edl_tpu_torch.train import fused_opt, serialization
    from edl_tpu_torch.train.state import TrainState

    model = jtfm.Transformer(jtfm.TransformerConfig(**MODEL,
                                                    dtype=jnp.float32))
    jstate = JTrainState.create(apply_fn=model.apply,
                                params=jax_moe["params"],
                                tx=jfo.make_fused_tx("adam", 1e-3, "fp32"))
    jstep = j_make_train_step(functools.partial(jtfm.lm_loss_moe),
                              donate=False)
    jstate, _ = jstep(jstate, {"tokens": jnp.asarray(jax_moe["tokens"])})
    want = fser.to_bytes(jax.device_get(jstate))

    port = tfm.Transformer(tfm.TransformerConfig(**MODEL,
                                                 dtype=torch.float32),
                           device="cpu", seed=1)
    state = TrainState.create(model=port, tx=fused_opt.make_fused_tx(
        "adam", 1e-3, "fp32"), params=bridge.flax_named_parameters(port))
    bridge.flax_to_state(serialization.msgpack_restore(want), state)
    assert serialization.to_bytes(bridge.state_to_flax(state)) == want
