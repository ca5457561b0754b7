"""Deep gradient compression (``edl_tpu_torch/train/dgc.py``) against the
JAX package's ``edl_tpu.train.dgc``.

- ``dgc``: the JAX package's chain ``dgc(sparsity, momentum,
  rampup_steps) -> add_decayed_weights(wd) -> sgd(lr)`` and the port's
  DGC optimizer take 4 steps of seeded gradients on three leaves: one
  above the 16384-entry sampling cap (its threshold from a random
  sample), one below it (the exact top-k) and one under 64 entries
  (never compressed), with one ramp-up step. The sampled positions are
  the JAX package's threefry draws, injected through ``sample=``.
  Parameters within 1e-6 after each step (fp32, the same operations).
- ``sparse_psum`` at world 2 (gloo ranks, ``test_torch_world.World``)
  against the JAX package's under ``shard_map`` on 2 CPU devices, with
  the fp32 and the int8 value wires: within 1e-6 (scatter-adds in
  another order; the int8 codec is the same). The same at world 4 over
  two groups of 2 ranks (``group=``) against ``axis_index_groups=[[0, 1],
  [2, 3]]``: each group's sum, its dense legs included, stays in the
  group.
- ``imagenet_train --dgc-sparsity 0.99 --dgc-rampup-epochs 0`` in a CPU
  world of 2 (the SPMD world step, ResNetTiny): finite losses, the ranks
  bitwise equal, each update's nonzero fraction at most 0.02; and
  ``--fused-opt`` with ``--dgc-sparsity`` exits with the JAX CLI's words.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world import TINY_ARGV, World, one_torch_thread  # noqa: F401

SHAPES = {"big": (160, 128), "mid": (40, 25), "small": (4, 8)}
SPARSITY, MOMENTUM, WD, LR, RAMPUP = 0.9, 0.9, 1e-4, 0.1, 1
DGC_ARGV = ["--dgc-sparsity", "0.99", "--dgc-rampup-epochs", "0"]


def _grads(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {k: rng.normal(size=s).astype(np.float32) * (1 + np.arange(
        s[-1], dtype=np.float32)) for k, s in SHAPES.items()}


def _jax_positions(n: int, step: int) -> np.ndarray:
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(n % (2**31 - 1)), step)
    return np.array(jax.random.randint(key, (16384,), 0, n))


def test_dgc_updates_match_the_jax_chain():
    import jax
    import jax.numpy as jnp
    import optax

    from edl_tpu.train import dgc as jdgc
    from edl_tpu_torch.train import dgc

    init = {k: np.random.default_rng(1).normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    tx = optax.chain(jdgc.dgc(SPARSITY, MOMENTUM, RAMPUP),
                     optax.add_decayed_weights(WD), optax.sgd(LR))
    jparams = jax.tree.map(jnp.asarray, init)
    jstate = tx.init(jparams)
    names = sorted(SHAPES)
    params = [(k, torch.nn.Parameter(torch.from_numpy(init[k].copy())))
              for k in names]
    opt = dgc.dgc(LR, SPARSITY, MOMENTUM, RAMPUP, weight_decay=WD,
                  sample=lambda n, s: torch.from_numpy(
                      _jax_positions(n, s)).long())
    state = opt.init(params)
    for step in range(4):
        g = _grads(step)
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate,
                                jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = opt.apply([torch.from_numpy(g[k]) for k in names], state,
                          params, step)
        for k, p in params:
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"{k} step {step}")
        if step >= RAMPUP:
            # big and mid compressed to about 1 - sparsity
            for k, sent in zip(names, opt.last_sent):
                if k != "small":
                    assert dgc.compression_ratio([sent]) < 0.2, k
    assert state.step == 4


def test_dgc_rejects_a_sparsity_of_one():
    from edl_tpu_torch.train import dgc
    with pytest.raises(ValueError, match="sparsity"):
        dgc.dgc(0.1, sparsity=1.0)


def _psum_inputs() -> dict:
    rng = np.random.default_rng(9)
    return {"a": rng.normal(size=(2, 5000)).astype(np.float32),
            "b": rng.normal(size=(2, 40)).astype(np.float32),
            "c": rng.normal(size=(2, 30, 70)).astype(np.float32)}


def rank_dgc(inputs: dict, directory: Path) -> dict:
    """sparse_psum of this rank's row of each input, both wires; then
    imagenet_train with DGC in this world, probed."""
    from edl_tpu_torch.examples import imagenet_train
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.train import dgc
    from edl_tpu_torch.train import step as step_lib

    r = distributed.rank()
    names = ("a", "b", "c")
    xs = [torch.from_numpy(inputs[k][r].copy()) for k in names]
    out = {}
    for wire in ("fp32", "int8"):
        for k, v in zip(names, dgc.sparse_psum(xs, keep_frac=0.05,
                                               wire=wire)):
            out[f"psum/{wire}/{k}"] = v.numpy()
    seen = {"losses": [], "ratios": []}
    call, apply = step_lib.WorldTrainStep.__call__, dgc.DGCOptimizer.apply

    def probe(self, state, batch, ls=None):
        state, m = call(self, state, batch)
        seen["losses"].append(float(m["loss"]))
        seen["state"] = state
        return state, m

    def probe_apply(self, grads, state, params, count):
        state = apply(self, grads, state, params, count)
        seen["ratios"].append(dgc.compression_ratio(self.last_sent))
        return state

    step_lib.WorldTrainStep.__call__ = probe
    dgc.DGCOptimizer.apply = probe_apply
    rc = imagenet_train.main([*json.loads(str(inputs["argv"]))])
    out.update(rc=np.array(rc), losses=np.array(seen["losses"]),
               ratios=np.array(seen["ratios"]))
    out.update({f"sd/{k}": v.numpy() for k, v in
                seen["state"].model.state_dict().items()})
    return out


GROUPS = [[0, 1], [2, 3]]
GROUP_KEEP = (0.05, 1.0)


def _grouped_inputs() -> dict:
    rng = np.random.default_rng(10)
    return {"a": rng.normal(size=(4, 5000)).astype(np.float32),
            "b": rng.normal(size=(4, 40)).astype(np.float32),
            "c": rng.normal(size=(4, 30, 70)).astype(np.float32)}


def rank_psum_groups(inputs: dict, directory: Path) -> dict:
    """sparse_psum of this rank's row of each input within its group of
    GROUPS, both wires, at each keep fraction of GROUP_KEEP."""
    import torch.distributed as dist

    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.train import dgc

    r = distributed.rank()
    # new_group is collective over the world: every rank makes each group
    groups = [dist.new_group(g) for g in GROUPS]
    group = next(pg for g, pg in zip(GROUPS, groups) if r in g)
    names = ("a", "b", "c")
    xs = [torch.from_numpy(inputs[k][r].copy()) for k in names]
    out = {}
    for keep in GROUP_KEEP:
        for wire in ("fp32", "int8"):
            for k, v in zip(names, dgc.sparse_psum(
                    xs, group, keep_frac=keep, wire=wire)):
                out[f"{keep}/{wire}/{k}"] = v.numpy()
    return out


@pytest.fixture(scope="module")
def grouped_world(tmp_path_factory):
    return World("test_torch_dgc:rank_psum_groups", 4,
                 tmp_path_factory.mktemp("dgc_groups"),
                 _grouped_inputs()).results()


@pytest.mark.parametrize("keep", GROUP_KEEP)
@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_sparse_psum_in_groups_matches_the_jax_package(grouped_world, wire,
                                                       keep):
    import jax
    from jax.sharding import PartitionSpec as P

    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.parallel.compat import shard_map
    from edl_tpu.train import dgc as jdgc

    inputs = _grouped_inputs()
    mesh = jmesh.make_mesh(jmesh.MeshSpec({"dp": -1}),
                           devices=jax.devices()[:4])

    def body(tree):
        tree = jax.tree.map(lambda x: x[0], tree)
        out = jdgc.sparse_psum(tree, "dp", keep_frac=keep, wire=wire,
                               axis_index_groups=GROUPS)
        return jax.tree.map(lambda x: x[None], out)

    got = shard_map(body, mesh=mesh, in_specs=(P("dp"),),
                    out_specs=P("dp"), check_vma=False)(inputs)
    for r, res in enumerate(grouped_world):
        for k in inputs:
            np.testing.assert_allclose(res[f"{keep}/{wire}/{k}"],
                                       np.asarray(got[k])[r], atol=1e-6,
                                       rtol=0, err_msg=f"rank {r} {k}")


@pytest.fixture(scope="module")
def dgc_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dgc")
    argv = ["--data-dir", str(d / "data"), "--make-synthetic", "2",
            *TINY_ARGV, "--epochs", "1", *DGC_ARGV]
    inputs = {**_psum_inputs(), "argv": np.array(json.dumps(argv))}
    return World("test_torch_dgc:rank_dgc", 2, d / "world",
                 inputs).results()


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_sparse_psum_matches_the_jax_package(dgc_world, wire):
    import jax
    from jax.sharding import PartitionSpec as P

    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.parallel.compat import shard_map
    from edl_tpu.train import dgc as jdgc

    inputs = _psum_inputs()
    mesh = jmesh.make_mesh(jmesh.MeshSpec({"dp": -1}),
                           devices=jax.devices()[:2])

    def body(tree):
        tree = jax.tree.map(lambda x: x[0], tree)
        out = jdgc.sparse_psum(tree, "dp", keep_frac=0.05, wire=wire)
        return jax.tree.map(lambda x: x[None], out)

    got = shard_map(body, mesh=mesh, in_specs=(P("dp"),),
                    out_specs=P("dp"), check_vma=False)(inputs)
    for r in dgc_world:
        for k in inputs:
            np.testing.assert_allclose(r[f"psum/{wire}/{k}"],
                                       np.asarray(got[k])[0], atol=1e-6,
                                       rtol=0, err_msg=k)


def test_imagenet_train_dgc_world_keeps_ranks_in_lockstep(dgc_world):
    r0, r1 = dgc_world
    assert int(r0["rc"]) == int(r1["rc"]) == 0
    assert len(r0["losses"]) == 4 and np.isfinite(r0["losses"]).all()
    keys = [k for k in r0 if k.startswith("sd/")]
    assert any(k.endswith("running_mean") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    # every step after the (empty) ramp-up sends about 1% of the entries
    assert len(r0["ratios"]) == 4 and max(r0["ratios"]) <= 0.02, \
        r0["ratios"]


def test_fused_opt_and_dgc_are_exclusive(tmp_path):
    from edl_tpu_torch.examples import imagenet_train
    with pytest.raises(SystemExit, match="mutually exclusive"):
        imagenet_train.main(["--data-dir", str(tmp_path), *TINY_ARGV,
                             *DGC_ARGV, "--fused-opt", "fp32"])
