"""Causal-LM pretraining over file-backed token shards, on one card or
over a world of ranks (port of ``edl_tpu.examples.lm_train``).

Same flags, defaults and log lines as the JAX package's entry point,
plus ``--device`` (``cuda`` unless the caller asks for ``cpu``). The
step runs the transformer with the flash kernels (forward K1, backward
K2/K3) on a card and, with ``--fused-opt fp32``, one fused Adam kernel
(K5) pass per parameter bucket, or with ``--fused-opt int8|fp8`` the
quantized-moment Adam (K7); ``--fused-opt off`` takes
``torch.optim.AdamW``. ``--fp16`` runs fp16 activations (the flash
kernels' fp16 bodies) with dynamic loss scaling, ``--fused-loss`` the
streamed-vocab loss (``ops/fused_xent.py``; training and eval),
``--remat on|auto`` per-block activation checkpointing (auto:
``models.transformer.auto_remat``). ``--ckpt-dir`` writes versioned
checkpoints (async by default; ``--ckpt-sharded`` for the chunk format)
that the JAX package reads, and a run on a dir that holds one resumes
from it; ``--loader-workers`` forks the shared-memory loader;
``--profile DIR`` writes a torch.profiler trace of steps 10-15.

A world of ranks comes from the launcher's env (``EDL_TPU_RANK``,
``EDL_TPU_WORLD_SIZE``, ``EDL_TPU_COORDINATOR``; rank r on
``cuda:{r % device_count}``). ``--mesh dp`` runs the SPMD world step
(``train/step.WorldTrainStep``: gradients averaged by one all-reduce per
dtype); ``--mesh fsdp`` (or the legacy ``--fsdp``) keeps on each rank
only its slice of every leaf the rules shard over fsdp
(``parallel/sharding.shard_module``), gathered at the point of use and
reduce-scattered in the backward, with the optimizer (K5, or K7 under
``--fused-opt int8|fp8``) over the slices; ``--ckpt-sharded`` then
writes each rank's chunks. ``--dcn-compress off|topk|int8`` and/or
``--comm-bucket-mb`` (or their env knobs) build ``train/comm``'s
``CommTrainStep`` over the transformer (K8 on the int8 wire). The JAX
CLI's conflicts between these flags exit with its words.

``--mesh sp`` is sequence parallelism over the world's ranks: the port's
ranks play the part of the devices that the JAX package's single process
spans (which is why the JAX CLI refuses sp in a world of processes:
its processes would read divergent batches). Every rank reads the same
global batch, runs its block of the sequence (``--seq-len`` must divide
over the ranks) with ring attention (``parallel/ring_attention.py``; the
flash body, K1-K3 on each block pair, on a card) and sums its gradients
with the others' (``train/step.WorldTrainStep``). ``--moe`` swaps each
block's MLP for the mixture of experts (``--n-experts``, default 2 x
world, ``--moe-top-k``) and trains through ``train/comm.MoECommStep``
over an ep mesh of every rank: each rank routes its own rows, and the
expert slots go to their owners by ``--moe-dispatch flat|hier`` with
``--moe-compress off|int8`` on the cross-slice leg (K8 on the card).
``--moe --ckpt-sharded`` exits, naming ROADMAP Queue 1 item 14(d).

  python -m edl_tpu_torch.examples.lm_train --device cpu \\
      --make-synthetic 1 --data-dir "$(mktemp -d)" --d-model 64 \\
      --n-heads 2 --n-layers 2 --d-ff 128 --vocab 256 --seq-len 128 \\
      --rows-per-file 64 --batch-size 8 --epochs 1 --fused-opt fp32

  # two ranks on the CPU with the parameters sharded (one process each,
  # one data dir, a free coordinator port $PORT)
  EDL_TPU_RANK=$R EDL_TPU_WORLD_SIZE=2 EDL_TPU_COORDINATOR=127.0.0.1:$PORT \\
      python -m edl_tpu_torch.examples.lm_train --device cpu ... \\
      --mesh fsdp --fused-opt fp32
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
                                              auto_remat, lm_loss_fn,
                                              lm_loss_fused, lm_loss_moe)
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.parallel.mesh import MeshSpec
from edl_tpu_torch.parallel.ring_attention import SeqParallel
from edl_tpu_torch.parallel.sharding import shard_module
from edl_tpu_torch.train import lr as lr_lib
from edl_tpu_torch.train import state as state_lib
from edl_tpu_torch.train.amp import DynamicLossScale
from edl_tpu_torch.train.benchlog import BenchmarkLog
from edl_tpu_torch.train.comm import (CommConfig, MoEDispatchConfig,
                                      make_moe_comm_step)
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
                        help="torch.profiler trace dir (steps 10-15, rank "
                             "0)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the port's stand-in "
                             "for the JAX package's platform and mesh "
                             "env contract")
    args = parser.parse_args(argv)
    if args.fp16 and args.bf16:
        parser.error("--fp16 and --bf16 are mutually exclusive")
    _refuse_conflicts(args)
    if 0 < args.schedule_epochs < args.epochs:
        raise SystemExit(
            f"--schedule-epochs {args.schedule_epochs} < --epochs "
            f"{args.epochs}: epochs past the horizon would train at "
            "LR ~0 (the horizon is the job TOTAL; the stop point is "
            "--epochs)")
    device = resolve_device(args.device)
    env = TrainerEnv.from_environ()
    world = max(1, env.world_size)
    rank = max(0, env.rank)
    ckpt_kw = {}
    if args.ckpt_steps is not None:
        ckpt_kw["ckpt_every_steps"] = args.ckpt_steps
    if args.ckpt_sync:
        ckpt_kw["ckpt_async"] = False
    loop_cfg = from_env(LoopConfig, num_epochs=args.epochs,
                        ckpt_dir=args.ckpt_dir or env.checkpoint_path
                        or None, ckpt_sharded=args.ckpt_sharded,
                        profile_dir=args.profile or None, **ckpt_kw)
    loader_workers = (args.loader_workers
                      if args.loader_workers is not None
                      else loop_cfg.loader_workers)
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
    if args.fp16 and fused_opt in ("int8", "fp8"):
        raise SystemExit(_FP16_QUANT)
    kind = "fsdp" if args.fsdp else args.mesh
    # the gradient path: CLI > env (LoopConfig binding) > off. A
    # compressed wire implies bucketing (default 4 MiB target).
    dcn_compress = (args.dcn_compress if args.dcn_compress is not None
                    else loop_cfg.dcn_compress)
    comm_bucket_mb = (args.comm_bucket_mb
                      if args.comm_bucket_mb is not None
                      else loop_cfg.comm_bucket_mb)
    comm_cfg = None
    if dcn_compress != "off" or comm_bucket_mb > 0:
        if kind != "dp":
            raise SystemExit(
                f"--dcn-compress/--comm-bucket-mb own the dp gradient "
                f"reduction; --mesh {kind} keeps the XLA-partitioned "
                "step (fsdp/tp collectives are slice-local already)")
        if args.fp16:
            raise SystemExit("--dcn-compress/--comm-bucket-mb are not "
                             "supported with --fp16 (the manual path "
                             "owns the backward's reduction)")
        comm_cfg = CommConfig(bucket_mb=comm_bucket_mb or 4.0,
                              compress=dcn_compress)
    # the MoE dispatch: CLI > env (LoopConfig binding) > hier/off
    moe_dispatch = (args.moe_dispatch if args.moe_dispatch is not None
                    else loop_cfg.moe_dispatch)
    moe_compress = (args.moe_compress if args.moe_compress is not None
                    else loop_cfg.moe_compress)
    if args.moe and dcn_compress != "off":
        raise SystemExit("--dcn-compress compresses the dp gradient "
                         "wire; under --moe the wire knob is "
                         "--moe-compress (gradient compression over "
                         "the ep axis is not parity-gated yet)")
    if kind == "sp" and args.seq_len % world:
        raise SystemExit(f"--mesh sp shards the sequence over {world} "
                         f"devices; --seq-len {args.seq_len} is not "
                         f"divisible by {world}")
    if args.moe and args.batch_size % world:
        raise SystemExit(f"--moe routes per chip: --batch-size "
                         f"{args.batch_size} must divide over {world} "
                         "devices")
    device = distributed.rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    distributed.init_from_env(env, device=device)
    if args.make_synthetic and rank == 0:
        make_synthetic_shards(args.data_dir, args.make_synthetic,
                              args.rows_per_file, args.seq_len, args.vocab,
                              args.seed)
    if args.make_synthetic:
        distributed.barrier()   # the others must not list a half-written dir

    files = sorted(os.path.join(args.data_dir, f)
                   for f in os.listdir(args.data_dir)
                   if f.startswith("train-") and f.endswith(".npz"))
    if not files:
        raise SystemExit(f"no train-*.npz under {args.data_dir}")
    # the batch is split over the data replicas; the sp ranks of a
    # replica all read its whole batch and each runs its sequence block
    replicas = 1 if kind == "sp" else world
    if args.batch_size % replicas:
        raise SystemExit("global batch not divisible by world")
    local_bs = args.batch_size // replicas
    # the mesh (collective: every rank builds its groups): hybrid when the
    # job declares slices, flat otherwise; a world of one has none but
    # under --moe, whose step owns an ep mesh of any size
    mesh = (distributed.make_mesh_from_env(
        MeshSpec({"ep" if args.moe else kind: -1}), env)
        if world > 1 or args.moe else None)
    moe_kw = {}
    if args.moe:
        moe_kw = dict(moe=True, n_experts=args.n_experts or 2 * world,
                      moe_top_k=args.moe_top_k)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.seq_len,
        dtype=(torch.float16 if args.fp16
               else torch.bfloat16 if args.bf16 else torch.float32),
        sp=SeqParallel.of(mesh) if kind == "sp" else None, **moe_kw)
    if args.remat != "off":
        cfg = (auto_remat(cfg, local_bs, device=device)
               if args.remat == "auto"
               else dataclasses.replace(cfg, remat=True))
        log.info("remat=%s (mode %s)", cfg.remat, args.remat)
    model = Transformer(cfg, device=device, seed=args.seed)
    model.train()
    if kind == "fsdp" and mesh is not None:
        # this rank keeps its slice of each leaf the rules shard (the
        # JAX package's init_sharded; the init is the same on every rank)
        specs = shard_module(model, mesh)
        log.info("fsdp: %d of %d leaves sharded over %d ranks",
                 len(specs), len(list(model.parameters())), world)

    source = FileSource(files)
    loader = DataLoader(source, local_bs, rank=rank if replicas > 1 else 0,
                        world=replicas, seed=args.seed,
                        num_workers=loader_workers)
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
    loss_fn = (functools.partial(lm_loss_moe, aux_weight=cfg.moe_aux_weight)
               if args.moe else lm_loss_fused if args.fused_loss
               else lm_loss_fn)
    if args.fp16:
        # TrainLoop's contract is step(state, batch); the loss-scale state
        # rides a closure cell. It is not checkpointed: after a restart
        # the scale re-warms from its init, as in the JAX package
        raw_step = make_train_step(loss_fn, loss_scale=True, mesh=mesh)
        ls_box = [DynamicLossScale.create()]

        def step(state, batch):
            state, metrics, ls_box[0] = raw_step(state, batch, ls_box[0])
            return state, metrics
    elif args.moe:
        # each rank routes its own rows; the wire takes the expert slots
        # to their owners (the dense einsum dispatch is eval's)
        step = make_moe_comm_step(
            lambda wire: functools.partial(loss_fn, wire=wire), mesh=mesh,
            topology=distributed.slice_topology(env), config=comm_cfg,
            moe_config=MoEDispatchConfig(mode=moe_dispatch,
                                         compress=moe_compress))
        log.info("moe path: E=%d top_k=%d dispatch=%s compress=%s",
                 cfg.n_experts, cfg.moe_top_k, moe_dispatch, moe_compress)
    elif comm_cfg is not None:
        step = make_train_step(loss_fn, comm=comm_cfg,
                               topology=distributed.slice_topology(env))
        log.info("manual gradient path: bucket=%.1fMiB compress=%s",
                 comm_cfg.bucket_mb, comm_cfg.compress)
    else:
        step = make_train_step(loss_fn, mesh=mesh)
    log.info("world=%d rank=%d devices=%d params=%s steps/epoch=%d",
             world, rank, 1, sum(p.numel() for p in model.parameters()),
             steps_per_epoch)

    eval_toks = None
    val_path = os.path.join(args.data_dir, "val.npz")
    if os.path.exists(val_path):
        with np.load(val_path) as z:
            eval_toks = z["tokens"][: 4 * local_bs]

    def eval_step(state, batch):
        # eval honours --fused-loss too: the dense loss would form the
        # very logits the streamed loss exists to avoid
        with torch.no_grad():
            return loss_fn(state.model, batch)[0]

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

    data_fn.close = loader.close  # TrainLoop tears down the mp workers
    status = loop.run(data_fn)
    blog.extra(**loop.ckpt_stats())  # save-stall / restore accounting
    if comm_cfg is not None or args.moe:
        blog.extra(**step.stats())  # bucket plan + wire accounting
    if rank == 0 and args.benchmark_log:
        blog.write(args.benchmark_log, rank)
    final = blog.finalize().get("final", {})
    log.info("done: epoch=%d step=%d %s", status.epoch, status.step, final)
    if "eval_loss" in final:
        print(f"final_eval_loss={final['eval_loss']:.4f}")
    distributed.shutdown()
    return 0


# the JAX package's refusal, word for word
_FP16_QUANT = (
    "--fused-opt int8/fp8 is not supported with --fp16: on a "
    "non-finite step the loss-scaler rolls the state back, but "
    "quantized moments would still carry the overflowed "
    "requantization residuals. Use --fused-opt fp32 (bitwise, "
    "rollback-safe) or bf16/fp32 activations.")


def _refuse_conflicts(args) -> None:
    """Exit, before any work, on the JAX CLI's flag conflicts that need
    no world (in its words)."""
    if args.fp16 and args.fused_opt in ("int8", "fp8"):
        raise SystemExit(_FP16_QUANT)
    if args.fsdp and args.mesh != "dp":
        raise SystemExit("--fsdp is a legacy alias of --mesh fsdp; "
                         f"it conflicts with --mesh {args.mesh}")
    kind = "fsdp" if args.fsdp else args.mesh
    if args.moe:
        if kind != "dp":
            raise SystemExit(f"--moe owns the ep mesh (expert tables "
                             f"sharded over every chip); --mesh {kind} "
                             "conflicts")
        if args.fp16:
            raise SystemExit("--moe is not supported with --fp16 (the "
                             "MoE comm step owns the backward; no "
                             "loss-scale hook)")
        if args.fused_loss:
            raise SystemExit("--fused-loss has no MoE variant (the MoE "
                             "loss collects router aux terms)")
        if args.ckpt_sharded:
            raise SystemExit(
                "--moe with --ckpt-sharded writes ep-sharded expert "
                "chunks; not ported yet (ROADMAP Queue 1 item 14(d))")


if __name__ == "__main__":
    sys.exit(main())
