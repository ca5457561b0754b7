"""Flagship classification trainer: ResNet50_vd over file-backed npz
shards, on one card or data parallel over a world of ranks (port of
``edl_tpu.examples.imagenet_train``).

Same flags, defaults, log lines and ``final_acc1=`` as the JAX package's
entry point, plus ``--device`` (``cuda`` unless the caller asks for
``cpu``): the reference's LR menu (piecewise or cosine, linear warmup),
label smoothing, mixup, weight decay, momentum-SGD (``--fused-opt
fp32``: one fused kernel K4 per parameter bucket; ``int8|fp8``: the
quantized-momentum kernel K6; ``off``: ``torch.optim.SGD``), the
loader's flip/crop transforms, and a top-1/top-5 eval over ``val.npz``
after each epoch. The flags this slice does not carry exit before any
work, naming the ROADMAP item that brings them.

A world of ranks comes from the launcher's env (``EDL_TPU_RANK``,
``EDL_TPU_WORLD_SIZE``, ``EDL_TPU_COORDINATOR``; rank r trains on
``cuda:{r % device_count}``, NCCL between cards, gloo on the CPU) and
needs the manual gradient path: ``--dcn-compress off|topk|int8`` and/or
``--comm-bucket-mb`` (or their env knobs) build ``train/comm``'s
``CommTrainStep`` (bucketed reductions; int8 runs kernel K8 on a card).
The JAX package's other multi-process path, the SPMD step with
global-batch BatchNorm statistics, is not ported, so a world above one
without them exits. Rank 0 writes the synthetic shards (the others wait
at a barrier), logs, and writes the benchmark log with the step's wire
accounting.

  python -m edl_tpu_torch.examples.imagenet_train --device cpu \\
      --make-synthetic 2 --data-dir "$(mktemp -d)" --rows-per-file 32 \\
      --model ResNetTiny --image-size 32 --num-classes 10 \\
      --batch-size 16 --epochs 2 --fused-opt fp32 --no-augment

  # two ranks on the CPU (gloo), one process each, sharing one data dir
  # and a coordinator port that is free on this host ($PORT):
  EDL_TPU_RANK=$R EDL_TPU_WORLD_SIZE=2 EDL_TPU_COORDINATOR=127.0.0.1:$PORT \\
      python -m edl_tpu_torch.examples.imagenet_train ... --device cpu \\
      --data-dir "$D" --dcn-compress int8
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch import models as zoo
from edl_tpu_torch.collective.job_env import TrainerEnv
from edl_tpu_torch.data.pipeline import (DataLoader, FileSource, random_crop,
                                         random_flip_lr)
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.train import lr as lr_lib
from edl_tpu_torch.train import state as state_lib
from edl_tpu_torch.train.benchlog import BenchmarkLog
from edl_tpu_torch.train.classification import (create_state,
                                                make_classification_step,
                                                make_eval_step)
from edl_tpu_torch.train.comm import CommConfig
from edl_tpu_torch.train.fused_opt import make_fused_tx
from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
from edl_tpu_torch.utils import config
from edl_tpu_torch.utils.config import from_env
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.imagenet_train")

_RESNETS = ("ResNet50", "ResNet101", "ResNet152", "ResNet50_vd",
            "ResNet101_vd", "ResNet152_vd", "ResNetTiny")


def make_synthetic_shards(data_dir: str, n_files: int, rows: int,
                          image_size: int, num_classes: int,
                          seed: int = 0, signal: float = 0.7,
                          label_noise: float = 0.0) -> None:
    """Learnable synthetic image shards + one val shard (deterministic),
    byte for byte the JAX package's: each class is a fixed random
    template blended into noise; ``label_noise`` flips that fraction of
    the recorded labels to another class. Images are float16 on disk."""
    os.makedirs(data_dir, exist_ok=True)
    templates = np.random.default_rng(77).normal(
        size=(num_classes, image_size, image_size, 3)).astype(np.float32)
    for i in range(n_files + 1):  # last = validation shard
        rng = np.random.default_rng(seed * 131 + i)
        label = rng.integers(0, num_classes, size=rows).astype(np.int32)
        img = (rng.normal(size=(rows, image_size, image_size, 3))
               .astype(np.float32) + signal * templates[label])
        if label_noise > 0.0:
            flip = rng.random(rows) < label_noise
            shift = rng.integers(1, num_classes, size=rows)
            label = np.where(flip, (label + shift) % num_classes,
                             label).astype(np.int32)
        name = "val.npz" if i == n_files else f"train-{i:04d}.npz"
        np.savez(os.path.join(data_dir, name),
                 image=img.astype(np.float16), label=label)


def build_schedule(args, steps_per_epoch: int):
    """The reference's LR menu: piecewise (boundaries in epochs, decayed
    by --lr-decay) or cosine over --schedule-epochs (default --epochs),
    with --warmup-epochs of linear warmup. --batch-size is GLOBAL, so the
    LR is tied to the batch, not the world."""
    base = args.lr
    warmup = args.warmup_epochs * steps_per_epoch
    horizon = args.schedule_epochs or args.epochs
    total = horizon * steps_per_epoch
    if args.lr_strategy == "cosine":
        return lr_lib.cosine_with_warmup(base, total, warmup)
    boundaries = [int(e) * steps_per_epoch for e in args.lr_boundaries]
    values = [base * (args.lr_decay ** i)
              for i in range(len(boundaries) + 1)]
    return lr_lib.piecewise_with_warmup(boundaries, values, max(warmup, 1))


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.examples.imagenet_train")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--data-format", choices=("npz", "jpeg", "packed"),
                        default="npz",
                        help="npz: float shards (jpeg and packed are not "
                             "ported yet)")
    parser.add_argument("--decode-threads", type=int,
                        default=max(1, (os.cpu_count() or 1) - 1),
                        help="JPEG decode thread pool width (jpeg format "
                             "only)")
    parser.add_argument("--loader-workers", type=int, default=None,
                        help="input-plane worker PROCESSES (default: "
                             "$EDL_TPU_LOADER_WORKERS, else 0 = inline; "
                             "only 0 is ported)")
    parser.add_argument("--make-synthetic", type=int, default=0,
                        help="generate N train shards (+1 val) first")
    parser.add_argument("--rows-per-file", type=int, default=1024)
    parser.add_argument("--synthetic-signal", type=float, default=0.7,
                        help="template amplitude of the synthetic data: "
                             "lower = harder task")
    parser.add_argument("--synthetic-label-noise", type=float, default=0.0,
                        help="fraction of synthetic labels flipped (pins "
                             "the val accuracy ceiling at ~1-x)")
    parser.add_argument("--model", default="ResNet50_vd",
                        help="zoo factory: ResNet50[_vd], ResNet101[_vd], "
                             "ResNet152[_vd], ResNetTiny")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--epochs", type=int, default=90,
                        help="train (or resume) up to this epoch")
    parser.add_argument("--schedule-epochs", type=int, default=0,
                        help="cosine-strategy LR horizon (default "
                             "--epochs); set to the job's TOTAL epochs "
                             "when an elastic segment stops early")
    parser.add_argument("--batch-size", type=int, default=256,
                        help="GLOBAL batch size")
    parser.add_argument("--lr", type=float, default=0.1,
                        help="base LR at world=1 (linear-scaled)")
    parser.add_argument("--lr-strategy", choices=("piecewise", "cosine"),
                        default="piecewise")
    parser.add_argument("--lr-boundaries", type=int, nargs="+",
                        default=[30, 60, 80], help="epochs")
    parser.add_argument("--lr-decay", type=float, default=0.1)
    parser.add_argument("--warmup-epochs", type=int, default=5)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight-decay", type=float, default=1e-4)
    parser.add_argument("--dcn-compress", choices=("off", "topk", "int8"),
                        default=None,
                        help="cross-slice gradient wire format of the "
                             "manual gradient path (default "
                             "$EDL_TPU_DCN_COMPRESS, else off); a flat "
                             "world with compression treats every rank "
                             "as a slice")
    parser.add_argument("--comm-bucket-mb", type=float, default=None,
                        help="bucket target of the manual gradient path "
                             "in MiB (default $EDL_TPU_COMM_BUCKET_MB; "
                             "4 when only --dcn-compress is given)")
    parser.add_argument("--fused-opt",
                        choices=("off", "fp32", "int8", "fp8"),
                        default=None,
                        help="fused optimizer path (train/fused_opt.py; "
                             "default $EDL_TPU_FUSED_OPT, else off): "
                             "fp32 = momentum-SGD as one kernel pass per "
                             "bucket (off = torch.optim.SGD); int8/fp8 "
                             "also hold the momentum quantized with "
                             "error-feedback residuals (opt state bytes "
                             "halve)")
    parser.add_argument("--dgc-sparsity", type=float, default=0.0,
                        help="deep gradient compression (not ported yet)")
    parser.add_argument("--dgc-rampup-epochs", type=int, default=1)
    parser.add_argument("--label-smoothing", type=float, default=0.1)
    parser.add_argument("--mixup-alpha", type=float, default=0.0)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 activations (fp32 params/optimizer)")
    parser.add_argument("--no-augment", action="store_true",
                        help="disable flip/crop transforms (synthetic-label "
                             "tasks are not augmentation-invariant)")
    parser.add_argument("--augment-device", type=int, default=None,
                        choices=(0, 1),
                        help="crop/flip on the device (not ported yet)")
    parser.add_argument("--rotate", action="store_true",
                        help="jpeg mode: random rotation before the crop")
    parser.add_argument("--teachers", default="",
                        help="distill mode (not ported yet)")
    parser.add_argument("--distill-temperature", type=float, default=2.0)
    parser.add_argument("--distill-hard-weight", type=float, default=0.0)
    parser.add_argument("--distill-topk", type=int, default=0)
    parser.add_argument("--distill-predict-key", default="logits")
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--ckpt-steps", type=int, default=None)
    parser.add_argument("--ckpt-sync", action="store_true")
    parser.add_argument("--benchmark-log", default="")
    parser.add_argument("--profile", default="",
                        help="profiler trace dir (not ported yet)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the port's stand-in "
                             "for the JAX package's platform and mesh "
                             "env contract")
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.rotate and (args.data_format != "jpeg" or args.no_augment):
        raise SystemExit("--rotate is a jpeg-mode augmentation (and is "
                         "incompatible with --no-augment)")
    if 0 < args.schedule_epochs < args.epochs:
        raise SystemExit(
            f"--schedule-epochs {args.schedule_epochs} < --epochs "
            f"{args.epochs}: epochs past the horizon would train at "
            "LR ~0 (the horizon is the job TOTAL; the stop point is "
            "--epochs)")
    device = resolve_device(args.device)
    loop_cfg = from_env(LoopConfig, num_epochs=args.epochs)
    _refuse_unported_env(loop_cfg)
    # the manual gradient path: CLI > env (LoopConfig binding) > off. A
    # compressed wire implies bucketing (default 4 MiB target).
    dcn_compress = (args.dcn_compress if args.dcn_compress is not None
                    else loop_cfg.dcn_compress)
    comm_bucket_mb = (args.comm_bucket_mb
                      if args.comm_bucket_mb is not None
                      else loop_cfg.comm_bucket_mb)
    comm_cfg = None
    if dcn_compress != "off" or comm_bucket_mb > 0:
        comm_cfg = CommConfig(bucket_mb=comm_bucket_mb or 4.0,
                              compress=dcn_compress)
    env = TrainerEnv.from_environ()
    if env.world_size > 1 and comm_cfg is None:
        raise SystemExit(_unported(
            f"a world above 1 (EDL_TPU_WORLD_SIZE={env.world_size}) without "
            "--dcn-compress/--comm-bucket-mb (the SPMD step with "
            "global-batch BatchNorm statistics)", 10))
    # Fused optimizer path: CLI > env (LoopConfig binding) > off;
    # EDL_TPU_OPT_QUANT overrides just the resident-moment codec.
    fused_opt = (args.fused_opt if args.fused_opt is not None
                 else loop_cfg.fused_opt)
    if loop_cfg.opt_quant and fused_opt != "off":
        if loop_cfg.opt_quant not in ("off", "int8", "fp8"):
            raise SystemExit(f"EDL_TPU_OPT_QUANT must be off|int8|fp8, "
                             f"got {loop_cfg.opt_quant!r}")
        fused_opt = ("fp32" if loop_cfg.opt_quant == "off"
                     else loop_cfg.opt_quant)
    if fused_opt not in ("off", "fp32", "int8", "fp8"):
        raise SystemExit(f"EDL_TPU_FUSED_OPT must be off|fp32|int8|fp8, "
                         f"got {fused_opt!r}")
    world = max(1, env.world_size)
    rank = max(0, env.rank)
    device = distributed.rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    distributed.init_from_env(env, device=device)
    if args.make_synthetic and rank == 0:
        make_synthetic_shards(args.data_dir, args.make_synthetic,
                              args.rows_per_file, args.image_size,
                              args.num_classes, args.seed,
                              signal=args.synthetic_signal,
                              label_noise=args.synthetic_label_noise)
    if args.make_synthetic:
        distributed.barrier()   # the others must not list a half-written dir

    val_path = os.path.join(args.data_dir, "val.npz")
    if args.batch_size % world:
        raise SystemExit(f"global batch {args.batch_size} not divisible by "
                         f"world {world}")
    local_bs = args.batch_size // world
    files = sorted(os.path.join(args.data_dir, f)
                   for f in os.listdir(args.data_dir)
                   if f.startswith("train-") and f.endswith(".npz"))
    if not files:
        raise SystemExit(f"no train-*.npz shards under {args.data_dir}")
    source = FileSource(files)
    transforms = () if args.no_augment else (random_flip_lr, random_crop)
    loader = DataLoader(source, local_bs, rank=rank, world=world,
                        seed=args.seed, transforms=transforms,
                        num_workers=0)
    steps_per_epoch = loader.steps_per_epoch()
    log.info("world=%d rank=%d device=%s format=%s shards=%d samples=%d "
             "steps/epoch=%d", world, rank, device, args.data_format,
             len(files), len(source), steps_per_epoch)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = zoo.get_model(args.model)(num_classes=args.num_classes,
                                      dtype=dtype, device=device,
                                      seed=args.seed)
    schedule = build_schedule(args, steps_per_epoch)
    if fused_opt != "off":
        # same math as torch.optim.SGD below: decayed weights fold into
        # the momentum update in-kernel
        tx = make_fused_tx("sgdm", schedule, fused_opt,
                           momentum=args.momentum,
                           weight_decay=args.weight_decay)
        log.info("fused optimizer path: sgd-m %s", fused_opt)
    else:
        tx = state_lib.sgd(schedule, momentum=args.momentum,
                           weight_decay=args.weight_decay)
    state = create_state(model, tx)
    step = make_classification_step(
        args.num_classes, smoothing=args.label_smoothing,
        mixup_alpha=args.mixup_alpha, seed=args.seed, comm=comm_cfg,
        topology=distributed.slice_topology(env))
    if comm_cfg is not None:
        log.info("manual gradient path: bucket=%.1fMiB compress=%s",
                 comm_cfg.bucket_mb, comm_cfg.compress)
    eval_step = make_eval_step()

    eval_batches = None
    if os.path.exists(val_path):
        with np.load(val_path) as z:
            eval_data = {"image": z["image"], "label": z["label"]}

        def eval_batches():
            for lo in range(0, len(eval_data["label"]) - local_bs + 1,
                            local_bs):
                yield {k: v[lo:lo + local_bs] for k, v in eval_data.items()}

    blog = BenchmarkLog(args.model, batch_size=args.batch_size,
                        world_size=world)
    epoch_t0 = [time.perf_counter()]

    def eval_fn(state, epoch):
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the epoch's queued steps
        elapsed = time.perf_counter() - epoch_t0[0]
        # per-trainer rate; benchlog multiplies its max by world_size
        rate = steps_per_epoch * local_bs / max(elapsed, 1e-9)
        results = {"examples_per_sec": rate}
        if eval_batches is not None:
            # rank r evaluates batches r, r + W, ...; the world's means
            sums = torch.zeros(3, dtype=torch.float64, device=device)
            for i, hb in enumerate(eval_batches()):
                if i % world != rank:
                    continue
                ev = eval_step(state, {
                    "image": torch.as_tensor(hb["image"], device=device),
                    "label": torch.as_tensor(hb["label"], device=device)})
                sums += torch.stack([ev["acc1"].double(),
                                     ev["acc5"].double(),
                                     torch.ones((), dtype=torch.float64,
                                                device=device)])
            acc1, acc5, n = distributed.all_reduce(sums).tolist()
            results.update(acc1=acc1 / max(n, 1), acc5=acc5 / max(n, 1))
        blog.epoch(epoch, **results)
        epoch_t0[0] = time.perf_counter()
        return results

    loop = TrainLoop(step, state, device=device, config=loop_cfg,
                     eval_fn=eval_fn)
    status = loop.run(loader.epoch)
    if comm_cfg is not None:
        blog.extra(**step.stats())  # bucket plan + wire accounting
    if rank == 0 and args.benchmark_log:
        blog.write(args.benchmark_log, rank)
    final = blog.finalize().get("final", {})
    log.info("done: epoch=%d step=%d %s", status.epoch, status.step,
             {k: round(v, 4) for k, v in final.items()})
    if final:
        print(f"final_acc1={final.get('acc1', float('nan')):.4f}")
    distributed.shutdown()
    return 0


def _unported(what: str, item: int) -> str:
    return f"{what} is not ported yet (ROADMAP Queue 1 item {item})"


def _refuse_unported(args) -> None:
    """Exit, before any work, on a flag this slice does not carry."""
    refused = [
        (args.data_format != "npz",
         f"--data-format {args.data_format} (the JPEG and packed-records "
         "input planes)", 8),
        (bool(args.augment_device),
         "--augment-device (crop/flip/normalize on the device)", 8),
        (args.dgc_sparsity > 0, "--dgc-sparsity (deep gradient "
         "compression)", 11),
        (bool(args.teachers), "--teachers (distill mode)", 12),
        (bool(args.ckpt_dir) or args.ckpt_steps is not None
         or args.ckpt_sync, "--ckpt-dir/--ckpt-steps/--ckpt-sync "
         "(checkpoints)", 8),
        ((args.loader_workers or 0) > 0,
         "--loader-workers > 0 (the mp loader)", 8),
        (bool(args.profile), "--profile (torch.profiler)", 8),
        (args.model not in _RESNETS,
         f"--model {args.model} (the rest of the model zoo)", 13),
    ]
    for hit, what, item in refused:
        if hit:
            raise SystemExit(_unported(what, item))


def _refuse_unported_env(cfg: LoopConfig) -> None:
    """The same refusals for the env knobs that would turn them on."""
    if cfg.loader_workers > 0:
        raise SystemExit(_unported("EDL_TPU_LOADER_WORKERS > 0 (the mp "
                                   "loader)", 8))
    aug = config.env_str("EDL_TPU_AUGMENT_DEVICE")
    if aug is not None and aug.lower() in ("1", "true", "yes", "on"):
        raise SystemExit(_unported("EDL_TPU_AUGMENT_DEVICE (crop/flip/"
                                   "normalize on the device)", 8))


if __name__ == "__main__":
    sys.exit(main())
