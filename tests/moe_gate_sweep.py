"""Phase 17's MoE gate read over inits and row seeds, in both packages.

chip_smoke.tiny_moe_gate (the JAX package's test problem: one MoE block,
E = 2 x world, momentum-SGD 0.3, MOE_GATE_STEPS steps) runs in a world
of two CPU ranks for each (init seed, row seed), beside the JAX
package's MoECommStep on the same init (the port's, bridged) and rows
on a two-device ep mesh. Prints one JSON line a case (each arm's
per-step losses in both packages) and a summary: the gate's reading
after the first update (max |int8 - flat| over the steps) in each
package, step 1's int8-flat delta (the forward alone), and the largest
port-JAX difference of either arm.

    JAX_PLATFORMS=cpu python tests/moe_gate_sweep.py [--seeds 8] \\
        [--rows 5,0,1,2]

This module imports no JAX at its top: its ranks run only the port.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
WORLD = 2


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", TESTS.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rank_cases(inputs: dict, directory: Path) -> dict:
    """A rank of the port's side: tiny_moe_gate on the CPU for each of
    ``inputs["cases"]``; each arm's per-step losses (the world's mean)."""
    cs = chip_smoke()
    gates = [cs.tiny_moe_gate("cpu", int(seed), int(rows))
             for seed, rows in inputs["cases"]]
    return {arm: np.array([g[f"{arm}_losses"] for g in gates])
            for arm in ("flat", "int8")}


def port_gate_losses(cases, directory: Path) -> dict:
    """{arm: (cases, steps) losses} of the port's gate in a CPU world."""
    from test_torch_world import World

    return World("moe_gate_sweep:rank_cases", WORLD, directory,
                 {"cases": np.array(cases)}).results()[0]


def jax_gate_losses(cases, steps: int) -> dict:
    """{arm: (cases, steps) losses} of the JAX package's MoECommStep
    (flat, and hier with the int8 leg) on the gate's problem, from the
    port's init of each case, bridged."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp
    import optax
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as P

    from edl_tpu.models import transformer as jtfm
    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.train import comm as jcomm
    from edl_tpu.train.state import TrainState
    from edl_tpu_torch import bridge
    from edl_tpu_torch.models import transformer as tfm

    kw = dict(vocab_size=16, d_model=16, n_heads=2, n_layers=1, d_ff=32,
              max_len=8, moe=True, n_experts=2 * WORLD, moe_top_k=2)
    cfg = jtfm.TransformerConfig(**kw, dtype=jnp.float32)
    model = jtfm.Transformer(cfg)

    def factory(wire):
        wired = jtfm.Transformer(dataclasses.replace(cfg, moe_wire=wire))
        return functools.partial(jtfm.lm_loss_moe,
                                 aux_weight=cfg.moe_aux_weight,
                                 apply_fn=wired.apply)

    mesh = jmesh.make_mesh(jmesh.MeshSpec({"ep": -1}), n_devices=WORLD)
    arms = {arm: jcomm.MoECommStep(
        factory, mesh=mesh, config=jcomm.CommConfig(bucket_mb=0.25),
        moe_config=mc, donate=False) for arm, mc in (
            ("flat", jcomm.MoEDispatchConfig(mode="flat")),
            ("int8", jcomm.MoEDispatchConfig(mode="hier",
                                             compress="int8")))}
    out = {arm: [] for arm in arms}
    for seed, rows in cases:
        params = bridge.torch_to_flax(tfm.Transformer(
            tfm.TransformerConfig(**kw, dtype=torch.float32), device="cpu",
            seed=int(seed)).state_dict(), kw["n_heads"])
        toks = np.random.default_rng(int(rows)).integers(
            0, 16, size=(2 * WORLD, 8)).astype(np.int32)
        placed = jmesh.shard_batch(mesh, {"tokens": toks},
                                   batch_axes=("ep",))
        for arm, step in arms.items():
            state = jax.tree.map(
                lambda t: jax.device_put(t, NamedSharding(mesh, P())),
                TrainState.create(apply_fn=model.apply, params=params,
                                  tx=optax.sgd(0.3, momentum=0.9)))
            losses = []
            for _ in range(steps):
                state, m = step(state, placed)
                losses.append(float(m["loss"]))
            out[arm].append(losses)
    return {arm: np.array(v) for arm, v in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--rows", default="5,0,1,2")
    args = p.parse_args(argv)
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    sys.path.insert(0, str(TESTS.parent))
    sys.path.insert(0, str(TESTS))
    cases = [(s, int(r)) for s in range(args.seeds)
             for r in args.rows.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        port = port_gate_losses(cases, Path(tmp))
    jax_ = jax_gate_losses(cases, port["flat"].shape[1])
    for i, (seed, rows) in enumerate(cases):
        print(json.dumps({"seed": seed, "rows": rows, **{
            f"{pkg}_{arm}": d[arm][i].tolist() for pkg, d in (
                ("port", port), ("jax", jax_)) for arm in ("flat",
                                                           "int8")}}))
    reading = {pkg: np.abs(d["int8"] - d["flat"]).max(1)
               for pkg, d in (("port", port), ("jax", jax_))}
    print(json.dumps({
        "cases": len(cases),
        "gate_reading": {pkg: [float(r.min()), float(r.max())]
                         for pkg, r in reading.items()},
        "over_0.2": {pkg: int((r > 0.2).sum())
                     for pkg, r in reading.items()},
        "step1_int8_flat_max": {pkg: float(np.abs(
            d["int8"][:, 0] - d["flat"][:, 0]).max()) for pkg, d in (
                ("port", port), ("jax", jax_))},
        "port_jax_max": {arm: float(np.abs(port[arm] - jax_[arm]).max())
                         for arm in ("flat", "int8")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
