"""Causal-LM pretraining over file-backed token shards, on one device
(port of ``edl_tpu.examples.lm_train``).

Same flags, defaults and log lines as the JAX package's entry point,
plus ``--device`` (``cuda`` unless the caller asks for ``cpu``). The
step runs the transformer with the flash kernels (forward K1, backward
K2/K3) on a card and, with ``--fused-opt fp32``, one fused Adam kernel
(K5) pass per parameter bucket, or with ``--fused-opt int8|fp8`` the
quantized-moment Adam (K7); ``--fused-opt off`` takes
``torch.optim.AdamW``. The flags this slice does not carry exit before
any work, naming the ROADMAP item that brings them.

  python -m edl_tpu_torch.examples.lm_train --device cpu \\
      --make-synthetic 1 --data-dir "$(mktemp -d)" --d-model 64 \\
      --n-heads 2 --n-layers 2 --d-ff 128 --vocab 256 --seq-len 128 \\
      --rows-per-file 64 --batch-size 8 --epochs 1 --fused-opt fp32
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch.bridge import flax_named_parameters
from edl_tpu_torch.collective.job_env import TrainerEnv
from edl_tpu_torch.data.pipeline import DataLoader, FileSource
from edl_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              lm_loss_fn)
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.train import lr as lr_lib
from edl_tpu_torch.train import state as state_lib
from edl_tpu_torch.train.benchlog import BenchmarkLog
from edl_tpu_torch.train.fused_opt import make_fused_tx
from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
from edl_tpu_torch.train.step import make_train_step
from edl_tpu_torch.utils.config import from_env
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.lm_train")


def make_synthetic_shards(data_dir: str, n_files: int, rows: int,
                          seq_len: int, vocab: int, seed: int = 0) -> None:
    """Markov-chain token shards (learnable: next-token depends on
    current token through a fixed random transition table)."""
    os.makedirs(data_dir, exist_ok=True)
    gen = np.random.default_rng(55)
    # each token has 8 plausible successors
    successors = gen.integers(0, vocab, size=(vocab, 8))
    for i in range(n_files + 1):  # last = validation
        rng = np.random.default_rng(seed * 271 + i)
        toks = np.empty((rows, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=rows)
        for t in range(1, seq_len):
            pick = rng.integers(0, 8, size=rows)
            toks[:, t] = successors[toks[:, t - 1], pick]
        name = "val.npz" if i == n_files else f"train-{i:04d}.npz"
        np.savez(os.path.join(data_dir, name), tokens=toks)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="edl_tpu_torch.examples.lm_train")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--make-synthetic", type=int, default=0)
    parser.add_argument("--rows-per-file", type=int, default=512)
    parser.add_argument("--loader-workers", type=int, default=None,
                        help="input-plane worker PROCESSES with "
                             "shared-memory batch hand-off (default: "
                             "$EDL_TPU_LOADER_WORKERS, else 0 = inline)")
    parser.add_argument("--vocab", type=int, default=512)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--d-ff", type=int, default=1024)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--schedule-epochs", type=int, default=0,
                        help="LR horizon (default --epochs); pin to the "
                             "job's total for elastic segments")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="GLOBAL batch size")
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--warmup-steps", type=int, default=100)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--fp16", action="store_true",
                        help="float16 activations + dynamic loss scaling "
                             "(train/amp.py; the reference's --fp16/"
                             "--scale_loss). bf16 is the TPU-native "
                             "choice — this exists for parity and "
                             "fp16 experiments")
    parser.add_argument("--fused-loss", action="store_true",
                        help="streamed-vocab CE: never materializes the "
                             "(B,S,V) logits (ops/fused_xent.py) — use "
                             "when the vocab is large")
    parser.add_argument("--dcn-compress", choices=("off", "topk", "int8"),
                        default=None,
                        help="cross-slice gradient wire format (default "
                             "$EDL_TPU_DCN_COMPRESS, else off): topk "
                             "ships values+indices, int8 one scale per "
                             "chip — both with error-feedback residuals "
                             "behind the loss-parity gate "
                             "(doc/design_comm.md)")
    parser.add_argument("--comm-bucket-mb", type=float, default=None,
                        help="bucket the gradient tree into N-MiB "
                             "reduction groups so late-backward buckets "
                             "overlap earlier buckets' communication "
                             "(default $EDL_TPU_COMM_BUCKET_MB, else 0 "
                             "= XLA's single fused reduction)")
    parser.add_argument("--moe", action="store_true",
                        help="mixture-of-experts FFNs: top-k capacity-"
                             "factor router, expert tables sharded over "
                             "an ep mesh, hierarchical all-to-all "
                             "dispatch (train/comm.py; "
                             "doc/design_comm.md)")
    parser.add_argument("--n-experts", type=int, default=0,
                        help="expert count (default 2x device count; "
                             "must divide evenly over the devices)")
    parser.add_argument("--moe-top-k", type=int, default=2,
                        help="experts per token")
    parser.add_argument("--moe-dispatch", choices=("flat", "hier"),
                        default=None,
                        help="MoE all-to-all decomposition (default "
                             "$EDL_TPU_MOE_DISPATCH, else hier): flat = "
                             "one global collective; hier = ICI leg + "
                             "cross-slice DCN leg, bitwise with flat")
    parser.add_argument("--moe-compress", choices=("off", "int8"),
                        default=None,
                        help="MoE DCN-leg wire format (default "
                             "$EDL_TPU_MOE_COMPRESS, else off): int8 "
                             "ships dispatched activations at one scale "
                             "per destination slice (parity-gated)")
    parser.add_argument("--fused-opt",
                        choices=("off", "fp32", "int8", "fp8"),
                        default=None,
                        help="fused optimizer path (train/fused_opt.py; "
                             "default $EDL_TPU_FUSED_OPT, else off): "
                             "fp32 = one kernel pass per bucket (off = "
                             "torch.optim.AdamW); int8/fp8 also hold the "
                             "moments quantized with error-feedback "
                             "residuals (opt state bytes halve)")
    parser.add_argument("--remat", choices=("off", "on", "auto"),
                        default="off",
                        help="per-block activation checkpointing: on = "
                             "always, auto = models.transformer."
                             "choose_remat decides from the activation-"
                             "footprint estimate vs device memory")
    parser.add_argument("--mesh", choices=("dp", "fsdp", "sp"),
                        default="dp",
                        help="dp: data parallel; fsdp: params sharded; "
                             "sp: sequence parallel — ring attention over "
                             "the sequence axis (long-context mode)")
    parser.add_argument("--fsdp", action="store_true",
                        help=argparse.SUPPRESS)  # legacy alias of --mesh fsdp
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--ckpt-sharded", action="store_true")
    parser.add_argument("--ckpt-steps", type=int, default=None,
                        help="also checkpoint every N optimizer steps "
                             "(cheap under async saves; default "
                             "$EDL_TPU_CKPT_STEPS, else epoch-end only)")
    parser.add_argument("--ckpt-sync", action="store_true",
                        help="synchronous saves (escape hatch; default "
                             "async snapshot-then-write)")
    parser.add_argument("--benchmark-log", default="")
    parser.add_argument("--profile", default="",
                        help="profiler trace dir (not ported yet)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the port's stand-in "
                             "for the JAX package's platform and mesh "
                             "env contract")
    args = parser.parse_args(argv)
    if args.fp16 and args.bf16:
        parser.error("--fp16 and --bf16 are mutually exclusive")
    _refuse_unported(args)
    if 0 < args.schedule_epochs < args.epochs:
        raise SystemExit(
            f"--schedule-epochs {args.schedule_epochs} < --epochs "
            f"{args.epochs}: epochs past the horizon would train at "
            "LR ~0 (the horizon is the job TOTAL; the stop point is "
            "--epochs)")
    device = resolve_device(args.device)
    env = distributed.init_from_env()
    world = max(1, env.world_size)
    rank = max(0, env.rank)
    loop_cfg = from_env(LoopConfig, num_epochs=args.epochs)
    _refuse_unported_env(loop_cfg)
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
    if args.make_synthetic and rank == 0:
        make_synthetic_shards(args.data_dir, args.make_synthetic,
                              args.rows_per_file, args.seq_len, args.vocab,
                              args.seed)

    files = sorted(os.path.join(args.data_dir, f)
                   for f in os.listdir(args.data_dir)
                   if f.startswith("train-") and f.endswith(".npz"))
    if not files:
        raise SystemExit(f"no train-*.npz under {args.data_dir}")
    if args.batch_size % world:
        raise SystemExit("global batch not divisible by world")
    local_bs = args.batch_size // world

    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.seq_len,
        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    model = Transformer(cfg, device=device, seed=args.seed)
    model.train()

    source = FileSource(files)
    loader = DataLoader(source, local_bs, rank=rank, world=world,
                        seed=args.seed, num_workers=0)
    steps_per_epoch = loader.steps_per_epoch()
    total_steps = steps_per_epoch * (args.schedule_epochs or args.epochs)
    # --batch-size is GLOBAL: LR stays batch-tied across elastic resizes
    schedule = lr_lib.cosine_with_warmup(
        args.lr, total_steps,
        min(args.warmup_steps, max(1, total_steps // 10)))
    if fused_opt != "off":
        tx = make_fused_tx("adam", schedule, fused_opt, weight_decay=0.01)
        log.info("fused optimizer path: adam %s", fused_opt)
    else:
        tx = state_lib.adamw(schedule, weight_decay=0.01)
    # the buckets follow the flax flatten order, as the JAX package's do
    state = state_lib.TrainState.create(
        model=model, tx=tx, params=flax_named_parameters(model))
    step = make_train_step(lm_loss_fn)
    log.info("world=%d rank=%d devices=%d params=%s steps/epoch=%d",
             world, rank, 1, sum(p.numel() for p in model.parameters()),
             steps_per_epoch)

    eval_toks = None
    val_path = os.path.join(args.data_dir, "val.npz")
    if os.path.exists(val_path):
        with np.load(val_path) as z:
            eval_toks = z["tokens"][: 4 * local_bs]

    def eval_step(state, batch):
        with torch.no_grad():
            return lm_loss_fn(state.model, batch)[0]

    blog = BenchmarkLog(f"transformer_lm_{args.d_model}d{args.n_layers}L",
                        batch_size=args.batch_size, world_size=world)
    epoch_t0 = [time.perf_counter()]

    def eval_fn(state, epoch):
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the epoch's queued steps
        elapsed = time.perf_counter() - epoch_t0[0]
        # per-rank sequences/s under the examples_per_sec key: benchlog
        # world-scales exactly that key into the global figure
        # (max_examples_per_sec_global); tokens_per_sec is pre-scaled.
        seqs_per_sec = steps_per_epoch * local_bs / max(elapsed, 1e-9)
        results = {"examples_per_sec": seqs_per_sec,
                   "tokens_per_sec": seqs_per_sec * args.seq_len * world}
        if eval_toks is not None:
            losses = [float(eval_step(state, {"tokens": torch.as_tensor(
                eval_toks[lo:lo + local_bs], device=device)}))
                for lo in range(0, len(eval_toks) - local_bs + 1, local_bs)]
            results["eval_loss"] = float(np.mean(losses))
        blog.epoch(epoch, **results)
        epoch_t0[0] = time.perf_counter()
        return results

    loop = TrainLoop(step, state, device=device, config=loop_cfg,
                     eval_fn=eval_fn)

    def data_fn(epoch):
        return ({"tokens": b["tokens"]} for b in loader.epoch(epoch))

    status = loop.run(data_fn)
    if rank == 0 and args.benchmark_log:
        blog.write(args.benchmark_log, rank)
    final = blog.finalize().get("final", {})
    log.info("done: epoch=%d step=%d %s", status.epoch, status.step, final)
    if "eval_loss" in final:
        print(f"final_eval_loss={final['eval_loss']:.4f}")
    return 0


def _unported(what: str, item: int) -> str:
    return f"{what} is not ported yet (ROADMAP Queue 1 item {item})"


def _refuse_unported(args) -> None:
    """Exit, before any work, on a flag this slice does not carry."""
    if args.fp16 and args.fused_opt in ("int8", "fp8"):
        raise SystemExit(
            "--fused-opt int8/fp8 is not supported with --fp16: on a "
            "non-finite step the loss-scaler rolls the state back, but "
            "quantized moments would still carry the overflowed "
            "requantization residuals. Use --fused-opt fp32 (bitwise, "
            "rollback-safe) or bf16/fp32 activations.")
    refused = [
        (args.moe, "--moe (mixture-of-experts blocks and dispatch)", 14),
        (args.fsdp or args.mesh == "fsdp", "--mesh fsdp (sharded params)",
         10),
        (args.mesh == "sp", "--mesh sp (ring attention)", 14),
        (args.dcn_compress not in (None, "off"),
         f"--dcn-compress {args.dcn_compress}", 11),
        (args.comm_bucket_mb not in (None, 0, 0.0),
         "--comm-bucket-mb (the bucketed gradient reduction)", 11),
        (args.fp16, "--fp16 (dynamic loss scaling)", 4),
        (args.fused_loss, "--fused-loss (the streamed-vocab loss)", 14),
        (args.remat != "off", f"--remat {args.remat}", 6),
        (bool(args.ckpt_dir), "--ckpt-dir (checkpoints)", 8),
        ((args.loader_workers or 0) > 0,
         "--loader-workers > 0 (the mp loader)", 8),
        (bool(args.profile), "--profile (torch.profiler)", 8),
        (TrainerEnv.from_environ().world_size > 1,
         "a world above 1 for lm_train (EDL_TPU_WORLD_SIZE > 1)", 11),
    ]
    for hit, what, item in refused:
        if hit:
            raise SystemExit(_unported(what, item))


def _refuse_unported_env(cfg: LoopConfig) -> None:
    """The same refusals for the env knobs that would turn them on."""
    if cfg.dcn_compress != "off" or cfg.comm_bucket_mb > 0:
        raise SystemExit(_unported(
            "EDL_TPU_DCN_COMPRESS / EDL_TPU_COMM_BUCKET_MB (the bucketed "
            "gradient reduction)", 11))
    if cfg.loader_workers > 0:
        raise SystemExit(_unported("EDL_TPU_LOADER_WORKERS > 0 (the mp "
                                   "loader)", 8))


if __name__ == "__main__":
    sys.exit(main())
