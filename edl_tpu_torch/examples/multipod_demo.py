"""One-world data-parallel trainer under the launcher (port of
``edl_tpu.examples.multipod_demo``).

Every launcher-spawned trainer joins one world from the EDL_TPU_* env the
launcher exported (``distributed.init_from_env``); a dp mesh spans every
rank and the SPMD world step (``train/step.WorldTrainStep``) averages the
gradients over it.

Determinism contract (what makes an elastic resize testable): the data
stream is a function of (epoch, global batch size) only, and each rank
feeds its contiguous slice of the same global batch, so a run resized
N -> M ranks is comparable with an unresized run, modulo reduction order.

  python -m edl_tpu_torch.collective.launch -- \\
      python -m edl_tpu_torch.examples.multipod_demo --epochs 5
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from edl_tpu_torch import resolve_device
from edl_tpu_torch.collective.job_env import TrainerEnv
from edl_tpu_torch.models.linear import LinearRegression, mse_loss
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.parallel import mesh as mesh_lib
from edl_tpu_torch.train import state as state_lib
from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
from edl_tpu_torch.train.step import make_train_step
from edl_tpu_torch.utils.config import from_env
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.multipod_demo")

TRUE_W, TRUE_B = 3.0, -1.5


def make_global_data(epoch: int, steps: int, global_batch: int):
    """The full epoch stream, identical on every rank (seed-per-pass),
    the JAX package's numbers."""
    rng = np.random.default_rng(7000 + epoch)
    n = steps * global_batch
    x = rng.normal(size=(n, 1)).astype(np.float32)
    y = (TRUE_W * x + TRUE_B
         + 0.01 * rng.normal(size=(n, 1)).astype(np.float32))
    for i in range(steps):
        s = slice(i * global_batch, (i + 1) * global_batch)
        yield {"x": x[s], "y": y[s]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.examples.multipod_demo")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--steps-per-epoch", type=int, default=20)
    parser.add_argument("--global-batch", type=int, default=32)
    parser.add_argument("--step-time", type=float, default=0.0,
                        help="artificial per-step delay (resize-window test)")
    parser.add_argument("--out", default="",
                        help="rank 0 writes final params JSON here")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    env = TrainerEnv.from_environ()
    device = distributed.rank_device(device, max(0, env.rank))
    env = distributed.init_from_env(env, device=device)
    world = max(1, env.world_size)
    if args.global_batch % world:
        raise SystemExit(f"global batch {args.global_batch} not divisible "
                         f"by world size {world}")
    mesh = distributed.make_mesh_from_env(mesh_lib.MeshSpec({"dp": -1}),
                                          env)
    topo = distributed.slice_topology(env)
    log.info("trainer up: rank=%d world=%d device=%s cluster_v=%d "
             "slices=%dx%d", env.rank, world, device, env.cluster_version,
             topo.n_slices, topo.chips_per_slice)

    model = LinearRegression(1, 1, device=device, seed=0)
    state = state_lib.TrainState.create(
        model=model, tx=state_lib.sgd(0.05, momentum=0.0))

    def loss_fn(model, batch):
        return mse_loss(model(batch["x"]), batch["y"]), {}

    step = make_train_step(loss_fn, mesh=mesh)
    if args.step_time > 0:
        raw_step = step

        def step(s, b):  # noqa: F811 — wrapped for the resize-window test
            time.sleep(args.step_time)
            return raw_step(s, b)

    def data_fn(epoch):
        for g in make_global_data(epoch, args.steps_per_epoch,
                                  args.global_batch):
            yield mesh_lib.shard_batch(mesh, g, device=device)

    loop = TrainLoop(step, state, device=device, config=from_env(
        LoopConfig, num_epochs=args.epochs,
        ckpt_dir=env.checkpoint_path or None,
        log_every_steps=args.steps_per_epoch))
    status = loop.run(data_fn)

    w = float(loop.state.model.Dense_0.weight.detach()[0, 0])
    b = float(loop.state.model.Dense_0.bias.detach()[0])
    log.info("done: epoch=%d step=%d w=%.5f b=%.5f", status.epoch,
             status.step, w, b)
    if args.out and distributed.rank() == 0:
        with open(args.out, "w") as f:
            json.dump({"w": w, "b": b, "epoch": status.epoch,
                       "step": status.step, "world": world}, f)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
