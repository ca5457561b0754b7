"""The distill steps of the port (edl_tpu_torch/train/classification.py:
``distill_kl``, ``sparse_distill_kl``, ``make_distill_step``,
``make_sparse_distill_step``) and the distill examples' models
(``models/mlp.py``, ``models/bow.py``) against the JAX package's, on the
CPU, on the same numpy inputs and bridged weights.

Tolerances: the KL losses within 1e-6 (the same fp32 expressions,
reduced in another order); one step of each distill step on ResNetTiny
(BatchNorm, vd) and on the MLP, with plain SGD at lr 1 so the gradient
is the parameters' change on the JAX side: the loss, gradients, updated
parameters and BatchNorm statistics within 1e-5, acc1 exactly; the
models' forwards within 1e-5; the bridge's round trips bit for bit. A
world of two gloo ranks (``test_torch_world.World``) takes the first
distill step, dense and sparse, on its halves of a global batch with
global-batch BatchNorm: within 1e-5 of a world of one on the whole
batch. JAX is imported inside the tests: the ranks import this module.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from edl_tpu_torch import bridge
from edl_tpu_torch.models.bow import BOWClassifier, CNNClassifier
from edl_tpu_torch.models.mlp import MLP
from edl_tpu_torch.models.resnet import ResNetTiny
from edl_tpu_torch.train import classification as tcls
from edl_tpu_torch.train import state as state_lib
from test_torch_world import World, one_torch_thread  # noqa: F401

RNG = np.random.default_rng(14)
TOPK = 4


def kd_batch(rows: int, shape: tuple, classes: int, seed: int = 0,
             sparse: bool = False) -> dict:
    """Images, labels and a teacher's logits (dense, or its top-k as the
    compressed wire carries it: int32 indices, fp16 values)."""
    rng = np.random.default_rng(seed)
    batch = {"image": rng.normal(size=(rows,) + shape).astype(np.float32),
             "label": rng.integers(0, classes, rows).astype(np.int32)}
    logits = rng.normal(0, 3, (rows, classes)).astype(np.float32)
    if not sparse:
        batch["teacher_logits"] = logits
        return batch
    idx = np.argsort(-logits, axis=1)[:, :TOPK].astype(np.int32)
    batch["teacher_logits.idx"] = idx
    batch["teacher_logits.val"] = np.take_along_axis(
        logits, idx, 1).astype(np.float16)
    return batch


@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.0])
def test_distill_kl_and_sparse_kl_match_jax(temperature):
    import jax.numpy as jnp

    from edl_tpu.train import classification as jcls

    s = RNG.normal(0, 2, (16, 10)).astype(np.float32)
    t = RNG.normal(0, 2, (16, 10)).astype(np.float32)
    want = jcls.distill_kl(jnp.asarray(s), jnp.asarray(t), temperature)
    got = tcls.distill_kl(torch.from_numpy(s), torch.from_numpy(t),
                          temperature)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    idx = np.argsort(-t, 1)[:, :TOPK].astype(np.int32)
    val = np.take_along_axis(t, idx, 1).astype(np.float16)
    want = jcls.sparse_distill_kl(jnp.asarray(s), jnp.asarray(idx),
                                  jnp.asarray(val), temperature)
    got = tcls.sparse_distill_kl(torch.from_numpy(s), torch.from_numpy(idx),
                                 torch.from_numpy(val), temperature)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _close(got: dict, want: dict, atol: float, what: str) -> None:
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        ours = got
        for k in path:
            ours = ours[k.key]
        np.testing.assert_allclose(
            ours, np.asarray(leaf), atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


MODELS = {
    "ResNetTiny": (lambda: ResNetTiny(num_classes=10, vd=True,
                                      dtype=torch.float32, device="cpu"),
                   (16, 16, 3)),
    "MLP": (lambda: MLP(10, (32, 16), in_features=48, device="cpu"),
            (4, 4, 3)),
}


def _jax_model(name: str):
    import jax.numpy as jnp

    from edl_tpu.models.mlp import MLP as JMLP
    from edl_tpu.models.resnet import ResNetTiny as JTiny

    if name == "ResNetTiny":
        return JTiny(num_classes=10, vd=True, dtype=jnp.float32)
    return JMLP(10, (32, 16))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_distill_step_matches_jax(name, sparse):
    import jax
    import optax

    from edl_tpu.train import classification as jcls
    from edl_tpu.train.state import TrainState as JTrainState

    build, shape = MODELS[name]
    model = build()
    # a copy: non-kernel leaves are views of the parameters, which the
    # port's step updates in place
    v = jax.tree.map(np.array,
                     bridge.torch_to_flax_variables(model.state_dict()))
    batch = kd_batch(8, shape, 10, seed=1, sparse=sparse)
    kw = dict(temperature=2.0, hard_weight=0.3, smoothing=0.1)
    jmake = jcls.make_sparse_distill_step if sparse else jcls.make_distill_step
    tmake = tcls.make_sparse_distill_step if sparse else tcls.make_distill_step

    jstate = JTrainState.create(apply_fn=_jax_model(name).apply,
                                params=v["params"], tx=optax.sgd(1.0),
                                batch_stats=v.get("batch_stats"))
    jnew, jm = jmake(10, donate=False, **kw)(jstate, batch)
    state = tcls.create_state(model, state_lib.sgd(1.0, momentum=0.0))
    state, tm = tmake(10, **kw)(state, {k: torch.from_numpy(x)
                                        for k, x in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5)
    assert float(tm["acc1"]) == float(jm["acc1"])
    grads = bridge.torch_to_flax_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"]
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                          jstate.params, jnew.params)
    _close(grads, jgrads, 1e-5, "grad")
    ours = bridge.torch_to_flax_variables(model.state_dict())
    _close(ours["params"], jnew.params, 1e-5, "param")
    if jnew.batch_stats is not None:
        _close(ours["batch_stats"], jnew.batch_stats, 1e-5, "stat")


def test_eval_step_on_token_ids_matches_jax():
    import jax.numpy as jnp
    import optax

    from edl_tpu.models.bow import BOWClassifier as JBOW
    from edl_tpu.train import classification as jcls
    from edl_tpu.train.state import TrainState as JTrainState

    model = BOWClassifier(vocab_size=64, embed_dim=8, num_classes=3,
                          device="cpu")
    v = bridge.torch_to_flax_variables(model.state_dict())
    ids = RNG.integers(0, 64, (32, 12)).astype(np.int32)
    label = RNG.integers(0, 3, 32).astype(np.int32)
    jstate = JTrainState.create(apply_fn=JBOW(64, 8, 3).apply,
                                params=v["params"], tx=optax.sgd(0.1))
    want = jcls.make_eval_step(input_key="ids")(
        jstate, {"ids": jnp.asarray(ids), "label": jnp.asarray(label)})
    got = tcls.make_eval_step(input_key="ids")(
        tcls.create_state(model, state_lib.adam(1e-3)),
        {"ids": torch.from_numpy(ids), "label": torch.from_numpy(label)})
    for k in ("acc1", "acc5"):
        assert float(got[k]) == float(want[k])


TEXT = {
    "BOWClassifier": (lambda: BOWClassifier(vocab_size=50, embed_dim=8,
                                            num_classes=3, device="cpu"),
                      dict(vocab_size=50, embed_dim=8, num_classes=3)),
    "CNNClassifier": (lambda: CNNClassifier(vocab_size=50, embed_dim=8,
                                            num_filters=6, num_classes=3,
                                            device="cpu"),
                      dict(vocab_size=50, embed_dim=8, num_filters=6,
                           num_classes=3)),
}


@pytest.mark.parametrize("name", ["MLP", "BOWClassifier", "CNNClassifier"])
def test_forward_and_bridge_round_trip(name):
    """The forward within 1e-5 of the flax module's on the bridged
    variables; the state dict -> flax tree -> state dict round trip bit
    for bit, names and flax shapes included (the 1-D conv's WIO
    kernel)."""
    import jax
    import jax.numpy as jnp

    from edl_tpu.models import bow as jbow
    from edl_tpu.models.mlp import MLP as JMLP

    if name == "MLP":
        model = MLP(5, (16, 8), in_features=36, device="cpu")
        jmodel = JMLP(5, (16, 8))
        x = RNG.normal(size=(4, 6, 6, 1)).astype(np.float32)
    else:
        build, kw = TEXT[name]
        model, jmodel = build(), getattr(jbow, name)(**kw)
        x = RNG.integers(0, 50, (4, 12)).astype(np.int32)
        x[:, 9:] = 0   # the pad tail the masked sum skips
    v = bridge.torch_to_flax_variables(model.state_dict())
    want = jmodel.apply(v, jnp.asarray(x))
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert jax.tree.map(np.shape, init) == jax.tree.map(np.shape, v)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    sd = bridge.flax_variables_to_torch(v)
    assert sorted(sd) == sorted(model.state_dict())
    for k, t in model.state_dict().items():
        assert torch.equal(sd[k], t), k
        assert bridge.flax_path(k) in {tuple(p.key for p in path) for
                                       path, _ in jax.tree_util
                                       .tree_flatten_with_path(
                                           v["params"])[0]}


def test_conv1d_kernel_layout_helpers_round_trip():
    """``to_flax_layout``/``from_flax_layout``/``torch_dim`` on a 3-D
    kernel: OIW <-> WIO, bit for bit, each dim where the other layout
    holds it."""
    w = RNG.normal(size=(6, 8, 3)).astype(np.float32)       # (out, in, 3)
    flax = bridge.to_flax_layout("conv.weight", w)
    assert flax.shape == (3, 8, 6)
    np.testing.assert_array_equal(flax[2, 5, 1], w[1, 5, 2])
    back = bridge.from_flax_layout("conv.weight", flax, w.shape)
    np.testing.assert_array_equal(back, w)
    for d in range(3):
        assert w.shape[bridge.torch_dim("conv.weight", d, 3)] == \
            flax.shape[d]


def test_adam_matches_optax_adam():
    import jax.numpy as jnp
    import optax

    p0 = RNG.normal(size=(5, 3)).astype(np.float32)
    grads = [RNG.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    tx = optax.adam(1e-2)
    jp, jst = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt_tx = state_lib.adam(1e-2)
    opt = opt_tx.init([("p", p)])
    for i, g in enumerate(grads):
        upd, jst = tx.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt_tx.step(opt, i)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               atol=1e-6)


# -- a world of ranks --------------------------------------------------------

def _world_inputs() -> dict:
    model = ResNetTiny(num_classes=10, vd=True, dtype=torch.float32,
                       device="cpu", seed=3)
    dense = kd_batch(8, (16, 16, 3), 10, seed=5)
    sparse = kd_batch(8, (16, 16, 3), 10, seed=5, sparse=True)
    return {**{f"sd/{k}": v.numpy() for k, v in model.state_dict().items()},
            **{f"dense/{k}": v for k, v in dense.items()},
            **{f"sparse/{k}": v for k, v in sparse.items()}}


def _distill_run(inputs: dict, mesh=None) -> dict:
    """One dense and one sparse distill step (fused momentum-SGD, fp32)
    from the inputs' weights on ``mesh``'s slice of the global batch (the
    whole batch without a mesh): each loss and the parameters and
    BatchNorm statistics after it."""
    from edl_tpu_torch.parallel import mesh as mesh_lib
    from edl_tpu_torch.train.fused_opt import make_fused_tx

    out = {}
    for kind in ("dense", "sparse"):
        model = ResNetTiny(num_classes=10, vd=True, dtype=torch.float32,
                           device="cpu")
        model.load_state_dict({k[3:]: torch.from_numpy(v)
                               for k, v in inputs.items()
                               if k.startswith("sd/")})
        batch = {k.split("/", 1)[1]: v for k, v in inputs.items()
                 if k.startswith(kind + "/")}
        batch = (mesh_lib.shard_batch(mesh, batch) if mesh is not None
                 else {k: torch.from_numpy(v) for k, v in batch.items()})
        make = (tcls.make_sparse_distill_step if kind == "sparse"
                else tcls.make_distill_step)
        state = tcls.create_state(model, make_fused_tx(
            "sgdm", 0.05, "fp32", momentum=0.9, weight_decay=1e-4))
        state, m = make(10, temperature=2.0, hard_weight=0.3,
                        smoothing=0.1, mesh=mesh)(state, batch)
        out[f"{kind}/loss"] = np.array(float(m["loss"]))
        out.update({f"{kind}/sd/{k}": v.numpy()
                    for k, v in model.state_dict().items()})
    return out


def rank_distill_step(inputs: dict, directory: Path) -> dict:
    from edl_tpu_torch.parallel import mesh as mesh_lib

    return _distill_run(inputs, mesh_lib.make_mesh(
        mesh_lib.MeshSpec({"dp": -1})))


def test_world_of_two_first_distill_step_matches_world_of_one(tmp_path):
    inputs = _world_inputs()
    world = World("test_torch_distill_step:rank_distill_step", 2, tmp_path,
                  inputs=inputs)
    one = _distill_run(inputs)
    ranks = world.results()
    for k, want in one.items():
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[k], want, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
