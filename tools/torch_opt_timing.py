#!/usr/bin/env python3
"""Device time of one optimizer step of the PyTorch port's fused optimizer
kernels over the main paths' plans, on one CUDA card.

    PYTHONPATH=<checkout> python3 tools/torch_opt_timing.py

Times, with the launches queued behind a sleep kernel (3 turns, in
turns; a turn queues few enough steps to keep a checkout that launches
bucket by bucket under about 800 queued launches): K5 (fp32 Adam) and
K7 (Adam with int8 m and fp8 v) over the base LM config's 60 buckets
(vocab 32768, d_model 1024, 16 heads, 8 layers, d_ff 4096: 168.9M
parameters), K6 (momentum-SGD with int8 momentum) over ResNet50_vd's 24
optimizer buckets, and K8 (the int8 gradient pack) over the 24
compressed buckets of ResNet50_vd's comm plan at world 2 (a step's
pack on one rank), each through the entry the checkout's training path
uses for a step (one call over every bucket where the checkout has it,
else bucket by bucket). Also the device memory K7 allocates beyond the
model and its state (a workspace, if any). Prints one JSON line with the
card's name and power limit. The port is imported from PYTHONPATH, so
one script times any checkout of it; run two side by side in one call
to compare them.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

TURNS = 3
# steps queued a turn: K7 bucket by bucket is 4 stream entries a bucket
# (240 a step), K6 96 a step, K5 60, K8 shard by shard 72
ITERS = {"K5": 10, "K7": 3, "K6": 8, "K8": 8}


def queued_ms(fn, iters: int) -> float:
    """Device ms of one ``fn()``: a sleep kernel holds the stream while
    the host enqueues ``iters`` calls. Raises if the sleep ended first."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    if start.query():
        raise RuntimeError("the host could not queue the timed steps ahead "
                           "of the card")
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plan(fo, model, tx, gen):
    """The fused optimizer's state over ``model`` and one step of random
    gradients packed into its buckets."""
    from edl_tpu_torch.bridge import flax_named_parameters

    named = flax_named_parameters(model)
    state = tx.init(named)
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
             for _, p in named]
    return state, fo._grad_buckets(tx.plan(named), [p for _, p in named],
                                   grads)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_opt_timing: needs a CUDA card", file=sys.stderr)
        return 1

    import edl_tpu_torch
    from edl_tpu_torch.bridge import flax_named_parameters
    from edl_tpu_torch.models.resnet import ResNet50_vd
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
    from edl_tpu_torch.ops import opt_kernels as ok
    from edl_tpu_torch.ops import pack
    from edl_tpu_torch.train import comm
    from edl_tpu_torch.train import fused_opt as fo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = TransformerConfig(vocab_size=32768, d_model=1024, n_heads=16,
                            n_layers=8, d_ff=4096, max_len=1024,
                            dtype=torch.bfloat16)
    lm = Transformer(cfg, device="cuda", seed=0)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    adam32 = fo.fused_adam(3e-4, weight_decay=0.01)
    s32, g32 = plan(fo, lm, adam32, gen)
    adamq = fo.fused_adam(3e-4, weight_decay=0.01, quant="int8")
    sq, gq = plan(fo, lm, adamq, gen)
    lr, c1, c2 = adam32.scalars(0)
    resnet = ResNet50_vd(num_classes=1000, dtype=torch.bfloat16,
                         device="cuda", seed=0)
    sgdq = fo.fused_sgd(0.1, 0.9, 1e-4, quant="int8")
    s6, g6 = plan(fo, resnet, sgdq, gen)
    leaves = [p for _, p in flax_named_parameters(resnet)]
    wire = comm.plan_buckets(leaves, 4.0, align=2)
    int8 = comm.CommConfig(compress="int8")
    shards = [buf for buf, b in zip(
        comm.pack_buckets([torch.randn(p.shape, generator=gen, device="cuda")
                           * 1e-3 for p in leaves], wire), wire.buckets)
        if comm._needs_residual(b, 1, 2, int8)]

    def k5():
        if hasattr(ok, "adam_fp32_buckets"):
            ok.adam_fp32_buckets(s32.p, g32, s32.m, s32.v, lr, c1, c2,
                                 **hyper)
            return
        for args in zip(s32.p, g32, s32.m, s32.v):
            ok.adam_fp32(*args, lr, c1, c2, **hyper)

    def k7():
        if hasattr(ok, "adam_q_buckets"):
            ok.adam_q_buckets(sq.p, gq, sq.m, sq.v, lr, c1, c2,
                              quant="int8", **hyper)
            return
        for args in zip(sq.p, gq, sq.m, sq.v):
            ok.adam_q(*args, lr, c1, c2, quant="int8", **hyper)

    def k6():
        if hasattr(ok, "sgdm_q_buckets"):
            ok.sgdm_q_buckets(s6.p, g6, s6.m, 0.1, mu=0.9, wd=1e-4,
                              quant="int8")
            return
        for p, g, m in zip(s6.p, g6, s6.m):
            ok.sgdm_q(p, g, m, 0.1, mu=0.9, wd=1e-4, quant="int8")

    def k8():
        if hasattr(pack, "pack_int8_buckets"):
            pack.pack_int8_buckets(shards)
            return
        for x in shards:
            pack.pack_int8(x)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k7()
    torch.cuda.synchronize()
    k7_extra = torch.cuda.max_memory_allocated() - before
    turns: dict[str, list[float]] = {"K5": [], "K7": [], "K6": [], "K8": []}
    for _ in range(TURNS):
        for name, fn in (("K5", k5), ("K7", k7), ("K6", k6), ("K8", k8)):
            turns[name].append(queued_ms(fn, ITERS[name]))
    print(json.dumps({
        "card": card, "torch": torch.__version__, "port": edl_tpu_torch.__file__,
        "ms": {k: sum(v) / len(v) for k, v in turns.items()},
        "ms_turns": turns, "k7_extra_device_bytes": k7_extra,
        "lm_buckets": len(s32.p), "resnet_buckets": len(s6.p),
        "resnet_compressed_buckets": len(shards),
        "resnet_compressed_elems": sum(x.numel() for x in shards),
        "timing": "device: steps queued behind a sleep kernel"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
