"""MNIST-scale distillation demo: teacher serving + DistillReader student
(port of ``edl_tpu.examples.mnist_distill``).

A student MLP trains against teacher logits pulled over the network
from a teacher pool, on the card unless ``--device cpu``.

Modes:
  --all-in-one          an in-process teacher (MLP, fixed seed) behind a
                        TeacherServer on loopback: no external services;
  --teachers h:p,h:p    fixed teacher endpoints (teacher_server CLI);
  --discovery h:p --service svc
                        dynamic discovery via the balancer daemon.

Data is synthetic (deterministic), sized like MNIST; no downloads.

  python -m edl_tpu_torch.examples.mnist_distill --all-in-one --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch.data.pipeline import ArraySource, DataLoader
from edl_tpu_torch.distill.reader import DistillReader
from edl_tpu_torch.distill.sharded_teacher import sharded_predict_fn
from edl_tpu_torch.distill.teacher_server import TeacherServer
from edl_tpu_torch.models.mlp import MLP
from edl_tpu_torch.train.classification import (create_state,
                                                make_distill_step,
                                                make_eval_step)
from edl_tpu_torch.train.state import adam
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.mnist_distill")

IMG_SHAPE = (28, 28, 1)
NUM_CLASSES = 10


def synthetic_mnist(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n,) + IMG_SHAPE).astype(np.float32)
    # Labels come from a fixed random projection so they are learnable.
    w = np.random.default_rng(123).normal(
        size=(int(np.prod(IMG_SHAPE)), NUM_CLASSES)).astype(np.float32)
    labels = (images.reshape(n, -1) @ w).argmax(axis=1).astype(np.int32)
    return {"image": images, "label": labels}


def on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def make_teacher_predict(device, seed: int = 42):
    """The forward of a fixed-weight teacher MLP on ``device``."""
    model = MLP(num_classes=NUM_CLASSES, hidden=(512, 256),
                in_features=int(np.prod(IMG_SHAPE)), device=device,
                seed=seed)
    predict, _ = sharded_predict_fn(lambda m, x: m(x), model, device,
                                    output_key="teacher_logits")
    return predict


def train(args) -> int:
    device = resolve_device(args.device)
    data = synthetic_mnist(args.samples, seed=args.seed)
    loader = DataLoader(ArraySource(data), args.batch_size, seed=args.seed,
                        num_workers=0)

    server = None
    teachers = None
    if args.all_in_one:
        server = TeacherServer(make_teacher_predict(device),
                               host="127.0.0.1",
                               max_batch=args.teacher_batch_size * 4).start()
        teachers = [f"127.0.0.1:{server.port}"]
    elif args.teachers:
        teachers = args.teachers.split(",")

    student = MLP(num_classes=NUM_CLASSES, hidden=(64,),
                  in_features=int(np.prod(IMG_SHAPE)), device=device,
                  seed=args.seed)
    state = create_state(student, adam(args.lr))
    step = make_distill_step(NUM_CLASSES, temperature=args.temperature,
                             hard_weight=args.hard_weight)
    eval_step = make_eval_step()
    held_out = on_device({k: v[:512] for k, v in data.items()}, device)

    try:
        for epoch in range(args.epochs):
            dr = DistillReader(
                lambda e=epoch: loader.epoch(e), feeds=["image"],
                predicts=["teacher_logits"], teachers=teachers,
                discovery=args.discovery or None, service=args.service,
                teacher_batch_size=args.teacher_batch_size)
            losses = []
            try:
                for batch in dr():
                    state, metrics = step(state, on_device(batch, device))
                    losses.append(float(metrics["loss"]))
            finally:
                dr.close()
            ev = eval_step(state, held_out)
            log.info("epoch %d loss=%.4f acc1=%.3f", epoch,
                     float(np.mean(losses)), float(ev["acc1"]))
        print(f"final_loss={np.mean(losses):.4f}")
        return 0
    finally:
        if server is not None:
            server.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.examples.mnist_distill")
    parser.add_argument("--all-in-one", action="store_true")
    parser.add_argument("--teachers", default="")
    parser.add_argument("--discovery", default="")
    parser.add_argument("--service", default="mnist_teacher")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--samples", type=int, default=2048)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--teacher-batch-size", type=int, default=16)
    parser.add_argument("--temperature", type=float, default=2.0)
    parser.add_argument("--hard-weight", type=float, default=0.3)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if not (args.all_in_one or args.teachers or args.discovery):
        parser.error("pick --all-in-one, --teachers or --discovery")
    return train(args)


if __name__ == "__main__":
    sys.exit(main())
