"""Elastic CTR training: DeepFM over task-dispensed Criteo-style files
(port of ``edl_tpu.examples.ctr_train``), on the card unless
``--device cpu``.

Elasticity lives entirely in the data plane: every trainer leases
file-shard tasks from the `TaskMaster` table in the coordination store,
so trainers can join or leave mid-epoch and a dead trainer's shards are
re-dispensed after the lease timeout with no record lost or doubled.

Modes:
  default             in-process store, one trainer — smoke/bench run;
  --store h:p         shared store: run N copies of this CLI (distinct
                      --trainer-id) against one store server (the port's
                      or the JAX package's; the task records are the same
                      bytes) for elastic multi-trainer dispensing; the
                      first to start installs the epoch's task table.

Data: --data-dir of .npz files (keys: dense (B,13) f32, sparse (B,26)
int32, label (B,) f32); --make-synthetic N generates them (the JAX CLI's
bytes: deterministic, learnable, the label a fixed projection of the
features). The optimizer is ``train/state.adam`` (torch.optim.Adam with
optax.adam's update over dense gradients of both tables), as the JAX CLI
runs optax.adam and no fused optimizer.

  python -m edl_tpu_torch.examples.ctr_train --make-synthetic 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch.coord.store import InMemStore
from edl_tpu_torch.data.task_loader import TaskDataLoader, npz_loader
from edl_tpu_torch.data.task_master import TaskMaster, file_list_specs
from edl_tpu_torch.models.deepfm import DeepFM, auc, bce_with_logits
from edl_tpu_torch.train.benchlog import BenchmarkLog
from edl_tpu_torch.train.state import TrainState, adam
from edl_tpu_torch.train.step import make_train_step
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.ctr_train")

VOCAB = 10000
N_DENSE, N_SPARSE = 13, 26


def make_synthetic_files(data_dir: str, n_files: int, rows_per_file: int,
                         seed: int = 0) -> list[str]:
    """Deterministic learnable CTR shards (one .npz per 'day part')."""
    os.makedirs(data_dir, exist_ok=True)
    proj = np.random.default_rng(999)
    w_dense = proj.normal(size=(N_DENSE,)).astype(np.float32)
    w_sparse = proj.normal(size=(VOCAB,)).astype(np.float32) * 0.3
    files = []
    for i in range(n_files):
        rng = np.random.default_rng(seed * 10007 + i)
        dense = rng.normal(size=(rows_per_file, N_DENSE)).astype(np.float32)
        sparse = rng.integers(0, VOCAB, size=(rows_per_file, N_SPARSE),
                              dtype=np.int32)
        score = dense @ w_dense + w_sparse[sparse].sum(axis=1)
        label = (score + 0.5 * rng.normal(size=rows_per_file)
                 > 0).astype(np.float32)
        path = os.path.join(data_dir, f"part-{i:03d}.npz")
        np.savez(path, dense=dense, sparse=sparse, label=label)
        files.append(path)
    return files


def loss_fn(model: DeepFM, batch: dict) -> tuple[torch.Tensor, dict]:
    logits = model(batch["dense"], batch["sparse"])
    return bce_with_logits(logits, batch["label"]), {}


def on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@torch.inference_mode()
def evaluate(model: DeepFM, files: list[str], batch_size: int,
             device) -> dict:
    """AUC + loss over a held-out shard list (ragged tails dropped)."""
    scores, labels, losses = [], [], []
    for f in files:
        arrays = npz_loader({"file": f})
        n = len(arrays["label"])
        if n < batch_size:
            raise SystemExit(
                f"eval shard {f} has {n} rows < batch size {batch_size}")
        for lo in range(0, n, batch_size):
            hi = lo + batch_size
            if hi > n:
                break  # the JAX CLI's static shapes: drop the ragged tail
            batch = on_device({k: v[lo:hi] for k, v in arrays.items()},
                              device)
            logits = model(batch["dense"], batch["sparse"])
            losses.append(bce_with_logits(logits, batch["label"]))
            scores.append(torch.sigmoid(logits).reshape(-1))
            labels.append(arrays["label"][lo:hi])
    return {"auc": auc(torch.cat(scores).cpu().numpy(),
                       np.concatenate(labels)),
            "loss": float(torch.stack(losses).mean())}


def train(args) -> int:
    device = resolve_device(args.device)
    if args.make_synthetic:
        files = make_synthetic_files(args.data_dir, args.make_synthetic,
                                     args.rows_per_file, seed=args.seed)
    else:
        files = sorted(
            os.path.join(args.data_dir, f) for f in os.listdir(args.data_dir)
            if f.endswith(".npz"))
    if len(files) < 2:
        raise SystemExit("need >= 2 data files (last one is held out)")
    train_files, eval_files = files[:-1], files[-1:]

    if args.store:
        from edl_tpu_torch.coord.client import StoreClient
        store = StoreClient(args.store)
    else:
        store = InMemStore()
    master = TaskMaster(store, args.job_id, args.trainer_id,
                        lease_timeout=args.lease_timeout)
    loader = TaskDataLoader(master, npz_loader, args.batch_size,
                            drop_remainder=True, seed=args.seed)

    model = DeepFM(vocab_size=VOCAB, embed_dim=args.embed_dim,
                   hidden=tuple(args.hidden), device=device, seed=args.seed)
    state = TrainState.create(model=model, tx=adam(args.lr))
    step = make_train_step(loss_fn)

    blog = BenchmarkLog("deepfm_ctr", batch_size=args.batch_size,
                        world_size=1, trainer_id=args.trainer_id)
    for epoch in range(args.epochs):
        # any trainer may install the table; init_epoch is idempotent
        master.init_epoch(epoch, file_list_specs(train_files))
        model.train()
        t0, n = time.perf_counter(), 0
        done0, lost0 = loader.tasks_completed, loader.tasks_lost
        losses = []
        for batch in loader.epoch(epoch):
            state, metrics = step(state, on_device(batch, device))
            losses.append(metrics["loss"])  # device scalar; read at the end
            n += len(batch["label"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rate = n / max(time.perf_counter() - t0, 1e-9)
        model.eval()
        ev = evaluate(model, eval_files, args.batch_size, device)
        train_loss = (float(torch.stack(losses).mean()) if losses
                      else float("nan"))
        log.info("epoch %d: train_loss=%.4f eval_loss=%.4f auc=%.4f "
                 "(%.0f ex/s, %d tasks, %d lost)", epoch, train_loss,
                 ev["loss"], ev["auc"], rate, loader.tasks_completed - done0,
                 loader.tasks_lost - lost0)
        blog.epoch(epoch, examples_per_sec=rate, **ev)
    final = blog.finalize()["final"]
    if args.benchmark_log:
        blog.write(args.benchmark_log)
    print(f"final_auc={final['auc']:.4f}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="edl_tpu_torch.examples.ctr_train")
    parser.add_argument("--data-dir", default="./ctr_data")
    parser.add_argument("--make-synthetic", type=int, default=0,
                        help="generate N synthetic .npz shards first")
    parser.add_argument("--rows-per-file", type=int, default=4096)
    parser.add_argument("--store", default="",
                        help="shared store host:port (elastic multi-trainer)")
    parser.add_argument("--job-id", default="ctr")
    parser.add_argument("--trainer-id", default=f"trainer-{os.getpid()}")
    parser.add_argument("--lease-timeout", type=float, default=30.0)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--embed-dim", type=int, default=10)
    parser.add_argument("--hidden", type=int, nargs="+",
                        default=[400, 400, 400])
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--benchmark-log", default="",
                        help="dir for benchmark_logs JSON (train/benchlog.py)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return train(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
