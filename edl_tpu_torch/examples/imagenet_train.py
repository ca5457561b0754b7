"""Flagship classification trainer: ResNet50_vd over file-backed data,
on one card or data parallel over a world of ranks (port of
``edl_tpu.examples.imagenet_train``).

Same flags, defaults, log lines and ``final_acc1=`` as the JAX package's
entry point, plus ``--device`` (``cuda`` unless the caller asks for
``cpu``): the reference's LR menu (piecewise or cosine, linear warmup),
label smoothing, mixup, weight decay, momentum-SGD (``--fused-opt
fp32``: one fused kernel K4 over every parameter bucket; ``int8|fp8``:
the quantized-momentum kernel K6; ``off``: ``torch.optim.SGD``), deep
gradient compression (``--dgc-sparsity``, ``--dgc-rampup-epochs``:
``train/dgc.py``, with the plain momentum-free SGD, exclusive with
``--fused-opt`` as in the JAX package), and a top-1/top-5 eval after
each epoch. The input planes are the JAX
package's: ``--data-format npz`` (float shards, host flip/crop),
``jpeg`` (a file list decoded by cv2 in a thread pool) or ``packed``
(pre-decoded fixed-stride records), each through the deterministic
loader, inline or in ``--loader-workers`` forked processes;
``--augment-device`` moves crop/flip/normalize onto the card. With
loader processes or the device augment, batches are prefetched onto the
card on a staging thread (``EDL_TPU_PREFETCH_BATCHES`` deep, 2 by
default); the inline loader places them on the training thread. ``--ckpt-dir`` writes versioned
checkpoints (async by default, every epoch and every ``--ckpt-steps``)
that the JAX package reads, and a run started on a dir that holds one
resumes from it, mid-epoch included. ``--profile DIR`` writes a
torch.profiler trace of steps 10-15. ``--teachers h:p,...`` distills:
one ``DistillReader`` (reused across epochs) sends each batch's images
to the teacher servers and appends their logits, and the step is the
temperature-KD step against them (``--distill-topk K``: the compressed
wire and the sparse step on the top-K targets); in a world each rank's
reader reads its own shard, under the SPMD world step. The flags this
slice does not carry exit before any work, naming the ROADMAP item that
brings them.

A world of ranks comes from the launcher's env (``EDL_TPU_RANK``,
``EDL_TPU_WORLD_SIZE``, ``EDL_TPU_COORDINATOR``; rank r trains on
``cuda:{r % device_count}``, NCCL between cards, gloo on the CPU). By
default it runs the JAX package's SPMD step over a dp mesh
(``train/step.WorldTrainStep``): each rank its slice of the global
batch, BatchNorm statistics over the global batch, the gradients
averaged by one all-reduce per dtype. ``--dcn-compress off|topk|int8``
and/or ``--comm-bucket-mb`` (or their env knobs) build ``train/comm``'s
``CommTrainStep`` instead (bucketed reductions; int8 runs kernel K8 on a
card; BatchNorm statistics local, the running buffers averaged). Rank 0
writes the synthetic data (the others wait at a barrier), logs, writes
checkpoints and the benchmark log.

Under the elastic launcher with live migration (``EDL_TPU_RESIZE_P2P=1``,
the default) a trainer whose pod stays in a resized world adopts it in
place: the loop's ``reform_mesh`` hook re-forms the process group
(``distributed.reform_world``) and rebuilds the step (the SPMD step on
the new world's mesh, or the comm step) for the new world, and ``on_reform`` re-derives this rank's loader shard for the new
(rank, world) with the global batch unchanged; the epoch resumes at its
step cursor. The JAX package's CLI passes its loop neither hook; there a
survivor keeps its old device world, which the port, whose device world
is its process group, cannot (ROADMAP Queue 3).

  python -m edl_tpu_torch.examples.imagenet_train --device cpu \\
      --make-synthetic 2 --data-dir "$(mktemp -d)" --rows-per-file 32 \\
      --model ResNetTiny --image-size 32 --num-classes 10 \\
      --batch-size 16 --epochs 2 --fused-opt fp32 --no-augment

  # packed records, two loader processes, crop/flip on the device, and
  # checkpoints: run to epoch 1, then the same command with --epochs 2
  # resumes from the checkpoint in $D/ckpt
  python -m edl_tpu_torch.examples.imagenet_train --device cpu \\
      --make-synthetic 2 --data-dir "$D" --data-format packed \\
      --loader-workers 2 --ckpt-dir "$D/ckpt" --model ResNetTiny \\
      --image-size 32 --num-classes 10 --rows-per-file 32 \\
      --batch-size 16 --epochs 1

  # two ranks on the CPU (gloo), one process each, sharing one data dir
  # and a coordinator port that is free on this host ($PORT); add
  # --dcn-compress int8 for the manual gradient path, or
  # --dgc-sparsity 0.99 --dgc-rampup-epochs 0 for DGC:
  EDL_TPU_RANK=$R EDL_TPU_WORLD_SIZE=2 EDL_TPU_COORDINATOR=127.0.0.1:$PORT \\
      python -m edl_tpu_torch.examples.imagenet_train ... --device cpu \\
      --data-dir "$D"

  # a student distilling from a served teacher (the zoo-teacher CLI)
  python -m edl_tpu_torch.distill.teacher_server --device cpu \\
      --model ResNetTiny --num-classes 10 --input-shape 32,32,3 \\
      --input-dtype float16 --host 127.0.0.1 --port 23900 &
  python -m edl_tpu_torch.examples.imagenet_train --device cpu ... \\
      --teachers 127.0.0.1:23900 [--distill-topk 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch import models as zoo
from edl_tpu_torch.collective.job_env import TrainerEnv
from edl_tpu_torch.data.image import (JpegFileListSource,
                                      eval_image_transform,
                                      make_synthetic_jpeg_dataset,
                                      train_image_transform)
from edl_tpu_torch.data.packed_records import PackedSource, pack_npz
from edl_tpu_torch.data.pipeline import (DataLoader, FileSource,
                                         prefetch_to_device, random_crop,
                                         random_flip_lr)
from edl_tpu_torch.ops.augment import make_device_augment
from edl_tpu_torch.models.resnet import set_batch_group
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.parallel.mesh import MeshSpec
from edl_tpu_torch.train import lr as lr_lib
from edl_tpu_torch.train import state as state_lib
from edl_tpu_torch.train.benchlog import BenchmarkLog
from edl_tpu_torch.train.classification import (create_state,
                                                make_classification_step,
                                                make_distill_step,
                                                make_eval_step,
                                                make_sparse_distill_step)
from edl_tpu_torch.train.comm import CommConfig
from edl_tpu_torch.train.dgc import dgc
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
                        help="npz: float shards; jpeg: a train.txt "
                             "'<path> <label>' list of JPEGs with host "
                             "decode + random-resized-crop/flip (cv2) and "
                             "normalization on the device; packed: a "
                             "train.pack pre-decoded fixed-stride record "
                             "file (python -m "
                             "edl_tpu_torch.data.packed_records pack; "
                             "--augment-device default on)")
    parser.add_argument("--decode-threads", type=int,
                        default=max(1, (os.cpu_count() or 1) - 1),
                        help="JPEG decode/augment THREAD pool width "
                             "(ignored when --loader-workers > 0)")
    parser.add_argument("--loader-workers", type=int, default=None,
                        help="input-plane worker PROCESSES with "
                             "shared-memory batch hand-off (default: "
                             "$EDL_TPU_LOADER_WORKERS, else 0 = "
                             "inline/threaded)")
    parser.add_argument("--make-synthetic", type=int, default=0,
                        help="generate N train shards (+1 val) first "
                             "(jpeg format: N random JPEGs + train.txt; "
                             "packed: the shards packed into train.pack)")
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
                        help="DGC: fraction of gradient entries dropped "
                             "per leaf (0.99 sends 1%%); 0 = off")
    parser.add_argument("--dgc-rampup-epochs", type=int, default=1,
                        help="dense epochs before DGC compression starts")
    parser.add_argument("--label-smoothing", type=float, default=0.1)
    parser.add_argument("--mixup-alpha", type=float, default=0.0)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 activations (fp32 params/optimizer)")
    parser.add_argument("--no-augment", action="store_true",
                        help="disable flip/crop transforms (synthetic-label "
                             "tasks are not augmentation-invariant)")
    parser.add_argument("--augment-device", type=int, default=None,
                        choices=(0, 1),
                        help="crop/flip (+ normalize) on the device from "
                             "the loader's per-step seed instead of on the "
                             "host (default $EDL_TPU_AUGMENT_DEVICE, else "
                             "on for --data-format packed); npz/packed "
                             "only")
    parser.add_argument("--rotate", action="store_true",
                        help="jpeg mode: random rotation before the crop")
    parser.add_argument("--teachers", default="",
                        help="distill mode: comma-joined teacher_server "
                             "endpoints; the loss becomes temperature-KD "
                             "against served logits")
    parser.add_argument("--distill-temperature", type=float, default=2.0)
    parser.add_argument("--distill-hard-weight", type=float, default=0.0,
                        help="0 = pure soft labels; >0 mixes hard-label "
                             "CE")
    parser.add_argument("--distill-topk", type=int, default=0,
                        help="negotiate the compressed teacher wire and "
                             "train on sparse top-K targets")
    parser.add_argument("--distill-predict-key", default="logits",
                        help="teacher fetch name (teacher_server "
                             "--output-key)")
    parser.add_argument("--ckpt-dir", default="",
                        help="checkpoint dir (default "
                             "$EDL_TPU_CHECKPOINT_PATH); a run resumes from "
                             "its latest checkpoint")
    parser.add_argument("--ckpt-steps", type=int, default=None,
                        help="also checkpoint every N optimizer steps "
                             "(default $EDL_TPU_CKPT_STEPS, else epoch ends "
                             "only)")
    parser.add_argument("--ckpt-sync", action="store_true",
                        help="synchronous saves (default: async "
                             "snapshot-then-write)")
    parser.add_argument("--benchmark-log", default="")
    parser.add_argument("--profile", default="",
                        help="torch.profiler trace dir; traces steps "
                             "10-15 on rank 0")
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
    if args.data_format == "jpeg" and args.synthetic_label_noise > 0:
        raise SystemExit(
            "--synthetic-label-noise is only implemented for the npz "
            "synthetic generator (jpeg synthetic data is random-labeled "
            "noise already)")
    if 0 < args.schedule_epochs < args.epochs:
        raise SystemExit(
            f"--schedule-epochs {args.schedule_epochs} < --epochs "
            f"{args.epochs}: epochs past the horizon would train at "
            "LR ~0 (the horizon is the job TOTAL; the stop point is "
            "--epochs)")
    # device augmentation: CLI > env > the format's default (on for
    # packed, whose point is a transform-free host)
    if args.augment_device is not None:
        augment_device = bool(args.augment_device)
    else:
        env_aug = config.env_str("EDL_TPU_AUGMENT_DEVICE")
        augment_device = (env_aug.lower() in ("1", "true", "yes", "on")
                          if env_aug is not None
                          else args.data_format == "packed")
    if args.no_augment:
        augment_device = False
    if augment_device and args.data_format == "jpeg":
        raise SystemExit(
            "--augment-device needs fixed-stride pre-decoded pixels and "
            "jpeg decode is host-side: pack the list first (python -m "
            "edl_tpu_torch.data.packed_records pack --jpeg-list train.txt "
            "--root DATA --out DATA/train.pack), then --data-format packed")
    if augment_device and args.teachers:
        raise SystemExit(
            "--augment-device is not supported with --teachers (the "
            "distill reader ships the teacher the SAME pixels the "
            "student trains on; device-augmented pixels never exist on "
            "host)")
    if args.mixup_alpha > 0 and args.teachers:
        raise SystemExit("--mixup-alpha is not supported with "
                         "--teachers (mixed pixels would be sent to "
                         "a teacher that expects clean inputs)")
    device = resolve_device(args.device)
    env = TrainerEnv.from_environ()
    ckpt_kw = {}
    if args.ckpt_steps is not None:
        ckpt_kw["ckpt_every_steps"] = args.ckpt_steps
    if args.ckpt_sync:
        ckpt_kw["ckpt_async"] = False
    loop_cfg = from_env(LoopConfig, num_epochs=args.epochs,
                        ckpt_dir=args.ckpt_dir or env.checkpoint_path
                        or None, profile_dir=args.profile or None,
                        **ckpt_kw)
    loader_workers = (args.loader_workers
                      if args.loader_workers is not None
                      else loop_cfg.loader_workers)
    # the manual gradient path: CLI > env (LoopConfig binding) > off. A
    # compressed wire implies bucketing (default 4 MiB target).
    dcn_compress = (args.dcn_compress if args.dcn_compress is not None
                    else loop_cfg.dcn_compress)
    comm_bucket_mb = (args.comm_bucket_mb
                      if args.comm_bucket_mb is not None
                      else loop_cfg.comm_bucket_mb)
    comm_cfg = None
    if dcn_compress != "off" or comm_bucket_mb > 0:
        if args.teachers:
            raise SystemExit(
                "--dcn-compress/--comm-bucket-mb are not supported "
                "with --teachers (the distill steps carry their own "
                "jit; the dp gradient wire is the student-only path)")
        comm_cfg = CommConfig(bucket_mb=comm_bucket_mb or 4.0,
                              compress=dcn_compress)
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
    if fused_opt != "off" and args.dgc_sparsity > 0:
        raise SystemExit(
            "--fused-opt and --dgc-sparsity are mutually exclusive: "
            "DGC's momentum correction REPLACES optimizer momentum "
            "inside an optax chain, while the fused path owns the "
            "whole momentum update in-kernel. Pick one compression "
            "story (DGC sparsifies the wire, fused-int8 shrinks "
            "resident state).")
    world = max(1, env.world_size)
    rank = max(0, env.rank)
    device = distributed.rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    distributed.init_from_env(env, device=device)
    if args.make_synthetic and rank == 0:
        _make_synthetic(args)
    if args.make_synthetic:
        distributed.barrier()   # the others must not list a half-written dir

    val_path = os.path.join(args.data_dir, "val.npz")
    if args.batch_size % world:
        raise SystemExit(f"global batch {args.batch_size} not divisible by "
                         f"world {world}")
    local_bs = args.batch_size // world
    normalize = None
    if args.data_format == "jpeg":
        list_file = os.path.join(args.data_dir, "train.txt")
        if not os.path.exists(list_file):
            raise SystemExit(f"no train.txt under {args.data_dir}")
        source = JpegFileListSource(list_file, root=args.data_dir)
        # --no-augment keeps the deterministic eval-style decode
        sample_t = (eval_image_transform(args.image_size,
                                         short=args.image_size * 8 // 7)
                    if args.no_augment
                    else train_image_transform(args.image_size,
                                               rotate=args.rotate))

        def make_loader(rank: int, world: int) -> DataLoader:
            return DataLoader(source, args.batch_size // world, rank=rank,
                              world=world, seed=args.seed,
                              sample_transforms=(sample_t,),
                              decode_threads=args.decode_threads,
                              num_workers=loader_workers)
        normalize = "imagenet"  # uint8 off the wire; normalized on the card
        n_files = len(source)
    else:
        if args.data_format == "packed":
            pack_path = os.path.join(args.data_dir, "train.pack")
            if not os.path.exists(pack_path):
                raise SystemExit(
                    f"no train.pack under {args.data_dir} (pack one: "
                    "python -m edl_tpu_torch.data.packed_records pack)")
            source = PackedSource(pack_path)
            # pre-decoded uint8 normalizes like the jpeg plane; float
            # shards were normalized before packing
            if source.fields["image"][1] == np.uint8:
                normalize = "imagenet"
            n_files = 1
        else:
            files = sorted(os.path.join(args.data_dir, f)
                           for f in os.listdir(args.data_dir)
                           if f.startswith("train-") and f.endswith(".npz"))
            if not files:
                raise SystemExit(
                    f"no train-*.npz shards under {args.data_dir}")
            source = FileSource(files)
            n_files = len(files)
        # device augmentation replaces the host batch transforms: the
        # loader ships raw bytes and the per-step seed
        transforms = () if (args.no_augment or augment_device) \
            else (random_flip_lr, random_crop)

        def make_loader(rank: int, world: int) -> DataLoader:
            return DataLoader(source, args.batch_size // world, rank=rank,
                              world=world, seed=args.seed,
                              transforms=transforms,
                              num_workers=loader_workers,
                              emit_batch_seed=augment_device)
    # what changes when the world is re-formed in place (reform_mesh and
    # on_reform below): this rank's shard of the global batch
    w = {"rank": rank, "world": world, "local_bs": local_bs,
         "loader": make_loader(rank, world)}
    steps_per_epoch = w["loader"].steps_per_epoch()
    log.info("world=%d rank=%d device=%s format=%s shards=%d samples=%d "
             "steps/epoch=%d loader_workers=%d augment_device=%s", world,
             rank, device, args.data_format, n_files, len(source),
             steps_per_epoch, loader_workers, augment_device)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = zoo.get_model(args.model)(num_classes=args.num_classes,
                                      dtype=dtype, device=device,
                                      seed=args.seed)
    schedule = build_schedule(args, steps_per_epoch)
    if args.dgc_sparsity > 0:
        # DGC's momentum correction replaces the optimizer's momentum;
        # weight decay stays dense, applied after the compressor
        tx = dgc(schedule, sparsity=args.dgc_sparsity,
                 momentum=args.momentum,
                 rampup_steps=args.dgc_rampup_epochs * steps_per_epoch,
                 weight_decay=args.weight_decay)
        log.info("deep gradient compression: sparsity %.4f, ramp-up %d "
                 "steps", args.dgc_sparsity,
                 args.dgc_rampup_epochs * steps_per_epoch)
    elif fused_opt != "off":
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

    def make_step(world_env: TrainerEnv):
        # without a comm flag a world above one runs the SPMD step over a
        # dp mesh (hybrid when the job declares slices); the global-batch
        # BatchNorm turns on at its first call and off in a world of one
        mesh = None
        set_batch_group(model, None, 1)
        if comm_cfg is None and distributed.world_size() > 1:
            mesh = distributed.make_mesh_from_env(MeshSpec({"dp": -1}),
                                                  world_env)
        if args.teachers:
            # --augment-device is refused with --teachers: the step
            # normalizes what the teacher was sent
            kd = (make_sparse_distill_step if args.distill_topk
                  else make_distill_step)
            return kd(args.num_classes,
                      temperature=args.distill_temperature,
                      hard_weight=args.distill_hard_weight,
                      smoothing=args.label_smoothing,
                      predict_key=args.distill_predict_key,
                      normalize=normalize, mesh=mesh)
        # with device augmentation the augment normalizes (one pass after
        # crop/flip); the step must not normalize twice
        return make_classification_step(
            args.num_classes, smoothing=args.label_smoothing,
            mixup_alpha=args.mixup_alpha, seed=args.seed,
            normalize=None if augment_device else normalize, comm=comm_cfg,
            topology=distributed.slice_topology(world_env), mesh=mesh)
    step = make_step(env)
    distill_reader = None
    if args.teachers:
        from edl_tpu_torch.distill.reader import DistillReader
        if normalize is not None:
            # the student normalizes on the card; the teacher receives
            # the RAW wire feeds and must apply the same preprocessing
            log.warning(
                "distill on the %s plane ships raw uint8 feeds: start "
                "the teacher with --input-normalize %s (a mismatched "
                "teacher emits out-of-distribution logits)",
                args.data_format, normalize)
        # ONE reader reused across epochs: data_fn retargets its source
        # at the current epoch of this rank's loader (seed-per-pass
        # order preserved)
        distill_epoch = [0]
        distill_reader = DistillReader(
            lambda: _owned(w["loader"].epoch(distill_epoch[0]),
                           loader_workers),
            feeds=("image",), predicts=(args.distill_predict_key,),
            teachers=[t for t in args.teachers.split(",") if t],
            compress_topk=args.distill_topk,
            sparse_predicts=bool(args.distill_topk))
    if comm_cfg is not None:
        log.info("manual gradient path: bucket=%.1fMiB compress=%s",
                 comm_cfg.bucket_mb, comm_cfg.compress)
    eval_step = make_eval_step(normalize=normalize)
    augment = None
    if augment_device:
        augment = make_device_augment(pad=4, base_seed=args.seed,
                                      normalize=normalize)
        log.info("device-side augmentation: crop(pad=4)+flip+normalize "
                 "on the prefetch stream from loader-emitted seeds")

    w["eval_batches"] = _eval_batches(args, local_bs, val_path)
    blog = BenchmarkLog(args.model, batch_size=args.batch_size,
                        world_size=world)
    epoch_t0 = [time.perf_counter()]

    def eval_fn(state, epoch):
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the epoch's queued steps
        elapsed = time.perf_counter() - epoch_t0[0]
        # per-trainer rate; benchlog multiplies its max by world_size
        rate = steps_per_epoch * w["local_bs"] / max(elapsed, 1e-9)
        results = {"examples_per_sec": rate}
        if w["eval_batches"] is not None:
            # rank r evaluates batches r, r + W, ...; the world's means
            sums = torch.zeros(3, dtype=torch.float64, device=device)
            for i, hb in enumerate(w["eval_batches"]()):
                if i % w["world"] != w["rank"]:
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

    # Prefetch onto the card on a staging thread when the host work of a
    # batch runs elsewhere (loader processes) or on the card (the device
    # augment): the copy and the augment of batch i+1 overlap step i. The
    # JAX package's CLI always prefetches; here an inline loader's numpy
    # collation on that thread would hold the GIL against the eager
    # step's kernel launches (ResNet50_vd's step went from 44.9 to 70.5 ms
    # with the npz loader on it, PERF.md), so the inline loader places
    # its batches on the training thread, between its launches (or on
    # the loop's own staging thread when EDL_TPU_PREFETCH_BATCHES asks).
    prefetch = loader_workers > 0 or augment_device
    depth = loop_cfg.prefetch_batches or 2
    if prefetch:
        loop_cfg = dataclasses.replace(loop_cfg, prefetch_batches=0)

    def reform_mesh(new_rank: int, new_world: int, cluster):
        """An adopted resize: re-form the process group in the new world
        (a trainer keeps its card) and return the step built for it."""
        new_env = dataclasses.replace(
            env, rank=new_rank, world_size=new_world,
            coordinator=cluster.coordinator,
            cluster_json=cluster.to_json(),
            cluster_version=cluster.version)
        distributed.reform_world(new_env, device=device)
        return make_step(new_env)

    def on_reform(new_rank: int, new_world: int, cluster):
        """This rank's shard of the same global batch in the new world."""
        del cluster
        if args.batch_size % new_world:
            raise SystemExit(f"global batch {args.batch_size} not divisible "
                             f"by world {new_world}")
        w["loader"].close()
        w.update(rank=new_rank, world=new_world,
                 local_bs=args.batch_size // new_world,
                 loader=make_loader(new_rank, new_world))
        w["eval_batches"] = _eval_batches(args, w["local_bs"], val_path)
        blog.result["world_size"] = new_world
        log.info("reformed: world=%d rank=%d local batch %d", new_world,
                 new_rank, w["local_bs"])

    loop = TrainLoop(step, state, device=device, config=loop_cfg,
                     eval_fn=eval_fn, reform_mesh=reform_mesh,
                     on_reform=on_reform)

    def data_fn(epoch):
        if distill_reader is not None:
            distill_epoch[0] = epoch
            batches = distill_reader()
        else:
            batches = w["loader"].epoch(epoch)
        if prefetch:
            return prefetch_to_device(batches, device, size=depth,
                                      augment=augment)
        return batches

    # TrainLoop closes the data plane it drives (decode pool, mp workers
    # and their shm ring) when the run ends, crash paths included
    data_fn.close = lambda: w["loader"].close()
    try:
        status = loop.run(data_fn)
    finally:
        # the error path too: the reader's discovery client thread
        if distill_reader is not None:
            distill_reader.close()
    blog.extra(**loop.ckpt_stats())  # save-stall / restore accounting
    if comm_cfg is not None:
        blog.extra(**loop.step_fn.stats())  # bucket plan + wire accounting
    if w["rank"] == 0 and args.benchmark_log:
        blog.write(args.benchmark_log, w["rank"])
    final = blog.finalize().get("final", {})
    log.info("done: epoch=%d step=%d %s", status.epoch, status.step,
             {k: round(v, 4) for k, v in final.items()})
    if final:
        print(f"final_acc1={final.get('acc1', float('nan')):.4f}")
    distributed.shutdown()
    return 0


def _make_synthetic(args) -> None:
    """Rank 0's synthetic data: JPEGs + train.txt, or npz shards (packed
    into train.pack for --data-format packed; val stays val.npz)."""
    if args.data_format == "jpeg":
        make_synthetic_jpeg_dataset(
            args.data_dir, args.make_synthetic, classes=args.num_classes,
            seed=args.seed, hw=(args.image_size * 3 // 2,
                                args.image_size * 2))
        return
    make_synthetic_shards(args.data_dir, args.make_synthetic,
                          args.rows_per_file, args.image_size,
                          args.num_classes, args.seed,
                          signal=args.synthetic_signal,
                          label_noise=args.synthetic_label_noise)
    if args.data_format == "packed":
        shards = sorted(os.path.join(args.data_dir, f)
                        for f in os.listdir(args.data_dir)
                        if f.startswith("train-") and f.endswith(".npz"))
        pack_npz(shards, os.path.join(args.data_dir, "train.pack"))


def _eval_batches(args, local_bs: int, val_path: str):
    """None, or a zero-arg callable yielding {'image', 'label'} host
    batches of local_bs (streamed)."""
    if args.data_format == "packed":
        val_pack = os.path.join(args.data_dir, "val.pack")
        if os.path.exists(val_pack):
            vsrc = PackedSource(val_pack)
            if len(vsrc) < local_bs:
                log.warning("val.pack has %d < batch %d rows; eval off",
                            len(vsrc), local_bs)
                return None
            return lambda: (vsrc.batch(np.arange(lo, lo + local_bs))
                            for lo in range(0, len(vsrc) - local_bs + 1,
                                            local_bs))
    if args.data_format == "jpeg":
        val_list = os.path.join(args.data_dir, "val.txt")
        if not os.path.exists(val_list):
            return None
        vsrc = JpegFileListSource(val_list, root=args.data_dir)
        if len(vsrc) < local_bs:
            log.warning("val.txt has %d < batch %d images; eval off",
                        len(vsrc), local_bs)
            return None
        vloader = DataLoader(
            vsrc, local_bs, shuffle=False, num_workers=0,
            sample_transforms=(eval_image_transform(
                args.image_size, short=args.image_size * 8 // 7),),
            decode_threads=args.decode_threads)
        return lambda: vloader.epoch(0)
    if not os.path.exists(val_path):
        return None
    with np.load(val_path) as z:
        eval_data = {"image": z["image"], "label": z["label"]}
    return lambda: ({k: v[lo:lo + local_bs] for k, v in eval_data.items()}
                    for lo in range(0, len(eval_data["label"]) - local_bs
                                    + 1, local_bs))


def _owned(batches, loader_workers: int):
    """The loader's batches as arrays of their own: the mp loader's are
    views over its shm ring, valid until the next batch, and the distill
    reader holds a batch until its teachers have answered."""
    if not loader_workers:
        yield from batches
        return
    for batch in batches:
        yield {k: np.array(v) for k, v in batch.items()}


def _unported(what: str, item: int) -> str:
    return f"{what} is not ported yet (ROADMAP Queue 1 item {item})"


def _refuse_unported(args) -> None:
    """Exit, before any work, on a flag this slice does not carry."""
    refused = [
        (args.model not in _RESNETS,
         f"--model {args.model} (the rest of the model zoo)", 13),
    ]
    for hit, what, item in refused:
        if hit:
            raise SystemExit(_unported(what, item))


if __name__ == "__main__":
    sys.exit(main())
