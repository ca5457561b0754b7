"""fit_a_line: linear-regression smoke job with checkpoint/resume (port
of ``edl_tpu.examples.fit_a_line``), on the card unless ``--device cpu``.

The minimum end-to-end slice: a single-process job through the whole
framework path: typed config (env fields), mesh, train step, TrainLoop,
atomic versioned checkpoints (the JAX package's bytes), resume.

    python -m edl_tpu_torch.examples.fit_a_line --num_epochs 5 \\
        --ckpt_dir /tmp/fal

Re-running with the same --ckpt_dir resumes from the last completed
epoch; the data stream is the JAX CLI's, a function of the epoch alone,
so a resumed run ends where an unbroken one does.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np

from edl_tpu_torch import resolve_device
from edl_tpu_torch.models.linear import LinearRegression, mse_loss
from edl_tpu_torch.parallel.mesh import make_mesh
from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
from edl_tpu_torch.train.state import TrainState, sgd
from edl_tpu_torch.train.step import make_train_step
from edl_tpu_torch.utils.config import describe, field, from_env
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.fit_a_line")

NUM_FEATURES = 13  # uci-housing shape


@dataclass
class Config:
    num_epochs: int = field(5, env="EDL_TPU_NUM_EPOCHS")
    steps_per_epoch: int = 50
    batch_size: int = 64
    lr: float = 0.05
    seed: int = 0
    ckpt_dir: str | None = field(None, env="EDL_TPU_CHECKPOINT_PATH")


def synthetic_batches(epoch: int, cfg: Config):
    """Deterministic per-epoch data order (seed-per-pass)."""
    rng = np.random.default_rng(cfg.seed * 1000 + epoch)
    w = np.arange(1, NUM_FEATURES + 1, dtype=np.float32) / NUM_FEATURES
    for _ in range(cfg.steps_per_epoch):
        x = rng.standard_normal((cfg.batch_size, NUM_FEATURES),
                                dtype=np.float32)
        y = x @ w[:, None] + 0.5 + 0.01 * rng.standard_normal(
            (cfg.batch_size, 1), dtype=np.float32)
        yield {"x": x, "y": y}


def loss_fn(model, batch):
    return mse_loss(model(batch["x"]), batch["y"]), {}


def build(cfg: Config, device="cuda", mesh=None):
    """(state, step): the seeded model under plain SGD (optax.sgd(lr):
    no momentum, no weight decay) and the step over ``mesh``."""
    model = LinearRegression(NUM_FEATURES, 1, device=device, seed=cfg.seed)
    state = TrainState.create(model=model, tx=sgd(cfg.lr, momentum=0.0))
    return state, make_train_step(loss_fn, mesh=mesh)


def main(argv: list[str] | None = None) -> float:
    parser = argparse.ArgumentParser(prog="edl_tpu_torch.examples.fit_a_line")
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--ckpt_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k != "device"}
    cfg = from_env(Config, **overrides)
    log.info("\n%s", describe(cfg))

    state, step_fn = build(cfg, device, make_mesh())
    loop = TrainLoop(
        step_fn, state, device=device,
        config=LoopConfig(num_epochs=cfg.num_epochs, ckpt_dir=cfg.ckpt_dir,
                          log_every_steps=25),
    )
    loop.run(lambda epoch: synthetic_batches(epoch, cfg))
    if loop.last_metrics:
        final_loss = float(loop.last_metrics["loss"])
        log.info("done: epoch=%d step=%d loss=%.5f",
                 loop.status.epoch, loop.status.step, final_loss)
        return final_loss
    log.info("done (nothing to train): epoch=%d step=%d",
             loop.status.epoch, loop.status.step)
    return 0.0


if __name__ == "__main__":
    main()
