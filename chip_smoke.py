#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repo root; needs a card and nvcc

Phases, each printed as JSON lines; any failure exits non-zero:

1. build   — the card's name and power limit (nvidia-smi), then every
             kernel under edl_tpu_torch/ops/csrc built with nvcc for sm_90a
             (one nvcc per source, started together);
2. kernels — each kernel against its plain PyTorch version on the card,
             on the same inputs: K1 (flash forward) and K2/K3 (flash
             backward, with and without a dlse cotangent) over a grid of
             shapes, strided q/k/v and the serving and training shapes
             (bounds: K1 2e-5 fp32 / 3e-2 bf16 as
             tests/test_flash_attention.py; K2/K3 5e-5 fp32 /
             3e-2 x max(1, max |ref|) bf16); K5 (fused Adam) bit for bit
             over 3 steps of a 4 MiB and a ragged bucket, the fused
             optimizer's gate, and (in the timing phase) two steps over
             every bucket of the base config's plan;
3. timing  — each kernel at its main path's shape: its time, its plain
             version's, one PyTorch library call computing the same
             function (timed only, never used by the port), and the
             least time the card could take for the work;
4. serve   — the transformer LM teacher at the repo's base config
             (bench.py's: vocab 32768, d_model 1024, 16 heads, 8 layers,
             d_ff 4096, S 1024, bf16 activations, fp32 params; seeded
             random weights) behind TeacherServer, answering 16
             concurrent TeacherClients with device top-16, in 3 rounds
             of 400 requests. Launch counters are set to 0 just before
             and read just after; the answers are held against the same
             weights with plain dense attention;
5. forward — where one 8-row predict's time goes: the flash launches
             and lm_head timed with CUDA events inside real forwards;
6. train   — the port's lm_train.main at the base config, 16 rows a
             step, 20 steps (--bf16 --fused-opt fp32): step time, the
             forward / backward / optimizer split, launches per step
             (exactly 8 K1, 8 K2, 8 K3 and one K5 per bucket), the loss
             falling; then one step of flash against dense attention on
             the trained weights, and each layer's dq from that step
             against the exact (fp64) gradient: K3's, and the one the
             JAX package's row term rowsum(dO*O), with O in bf16, gives.

The line before the last lists every ported kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent

# (name, source, the TPU kernel it replaces) of every ported kernel
KERNELS = (
    ("flash_fwd", "edl_tpu_torch/ops/csrc/flash_fwd.cu",
     "edl_tpu/ops/flash_attention.py:47"),
    ("flash_bwd_dkdv", "edl_tpu_torch/ops/csrc/flash_bwd.cu",
     "edl_tpu/ops/flash_attention.py:163"),
    ("flash_bwd_dq", "edl_tpu_torch/ops/csrc/flash_bwd.cu",
     "edl_tpu/ops/flash_attention.py:212"),
    ("adam_fp32", "edl_tpu_torch/ops/csrc/adam_fp32.cu",
     "edl_tpu/ops/opt_kernels.py:216"),
)

# The card's published peaks (H100 SXM data sheet, dense).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# Backward bounds: fp32 as tests/test_flash_attention.py (5e-5); bf16
# 3e-2 (the forward's bound) times the reference's largest magnitude, at
# least 1: a gradient is a sum of up to S terms, each rounded to bf16 as
# an operand of the tensor cores, and is itself rounded to bf16.
BWD_ATOL_FP32 = 5e-5
BWD_REL_BF16 = 3e-2

# The serving path: bench.py's base LM config, buckets of 8 rows.
MAIN = dict(b=8, s=1024, h=16, d=64, dtype=torch.bfloat16, causal=True)
# The training path: lm_train at the base config, 16 rows a step.
TRAIN = dict(b=16, s=1024, h=16, d=64, dtype=torch.bfloat16, causal=True)
# 16 clients with one request of 1-4 rows in flight each keep ~40 rows
# queued, so the batcher can fill max_batch = 8 rows.
N_CLIENTS, REQS_PER_CLIENT, ROUNDS, TOPK = 16, 25, 3, 16
# Served top-16 against the same weights with dense attention: both run
# bf16 activations and differ only in where attention rounds, so the
# top-1 class may flip only where two logits nearly tie.
TOP1_AGREE_MIN = 0.95
VAL_ATOL = 0.15


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, s, h, d, dtype, causal) -> tuple[float, str]:
    """Least time for one forward: q, k, v read once, o and lse written
    once, over the memory rate; 2 matmuls x 2 flops per visible
    (query, key) pair x d, over the tensor-core rate of the type."""
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * s * h * d * elem + b * s * h * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def qkv_case(case: dict, gen) -> tuple:
    """q, k, v of a case, as strided views of one (B, S, 3, H, D)
    projection when the case says ``fused``."""
    b, s, h, d, dt = (case[x] for x in ("b", "s", "h", "d", "dtype"))
    if case.get("fused"):
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                          dtype=torch.float32).to(dt)
        return qkv.unbind(2)
    return tuple(torch.randn((b, s, h, d), generator=gen, device="cuda",
                             dtype=torch.float32).to(dt) for _ in range(3))


def phase_kernels(fa, gen) -> dict:
    """K1 vs its plain version on the card; returns {"flash_fwd":
    (max abs error, checks)}."""
    cases = [dict(b=2, s=s, h=4, d=d, dtype=dt, causal=c)
             for dt in (torch.float32, torch.bfloat16)
             for c in (True, False) for s in (128, 384, 1024)
             for d in (64, 128)]
    cases += [dict(b=2, s=1024, h=4, d=32, dtype=dt, causal=True)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [dict(b=2, s=200, h=3, d=64, dtype=torch.float32, causal=True),
              dict(b=2, s=256, h=4, d=64, dtype=torch.bfloat16, causal=True,
                   fused=True),
              MAIN]
    worst = 0.0
    for case in cases:
        b, s, h, d, dt = case["b"], case["s"], case["h"], case["d"], \
            case["dtype"]
        q, k, v = qkv_case(case, gen)
        scale = 1.0 / d ** 0.5
        o_ref, lse_ref = fa._fwd_blockwise(
            q, k, v, blk=fa._fit_block(s, 512), scale=scale,
            causal=case["causal"])
        o, lse = fa.flash_attention_lse(q, k, v, causal=case["causal"])
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok = (o.dtype == dt and o.shape == q.shape
              and lse.shape == (b, s, h)
              and err_o <= ATOL[dt] and err_lse <= ATOL[dt])
        emit({"phase": "kernels", "kernel": "flash_fwd",
              "shape": [b, s, h, d], "dtype": str(dt).split(".")[-1],
              "causal": case["causal"], "strided": bool(case.get("fused")),
              "err_o": err_o, "err_lse": err_lse, "atol": ATOL[dt],
              "ok": ok})
        if not ok:
            fail(f"flash_fwd disagrees with its plain version on {case}: "
                 f"o {err_o}, lse {err_lse}, bound {ATOL[dt]}")
        worst = max(worst, err_o, err_lse)
    return {"flash_fwd": (worst, len(cases))}


def phase_timing(fa, gen) -> dict:
    b, s, h, d, dt, causal = (MAIN[k] for k in
                              ("b", "s", "h", "d", "dtype", "causal"))
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dt) for _ in range(3))
    scale = 1.0 / d ** 0.5
    blk = fa._fit_block(s, 512)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    plain_ms = time_ms(lambda: fa._fwd_blockwise(
        q, k, v, blk=blk, scale=scale, causal=causal), iters=5)

    # the kernel and the library call in turns, three times each
    turns: dict[str, list[float]] = {"kernel": [], "library": []}
    for _ in range(3):
        turns["kernel"].append(time_ms(lambda: fa.flash_attention_lse(
            q, k, v, causal=causal), iters=20))
        turns["library"].append(time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), iters=20))
    bound_ms, bound_by = attention_bound_ms(b, s, h, d, dt, causal)
    out = {"ms": float(np.mean(turns["kernel"])), "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": float(np.mean(turns["library"]))}
    emit({"phase": "timing", "kernel": "flash_fwd",
          "shape": [b, s, h, d], "dtype": "bfloat16", "causal": causal,
          **out, "ms_turns": turns["kernel"],
          "library_ms_turns": turns["library"],
          "library": "F.scaled_dot_product_attention"})
    return out


def bwd_atol(ref: torch.Tensor) -> float:
    if ref.dtype == torch.float32:
        return BWD_ATOL_FP32
    return BWD_REL_BF16 * max(1.0, ref.float().abs().max().item())


def phase_kernels_bwd(fa, gen) -> dict:
    """K2 and K3 against the plain `_bwd_blockwise` on the card, with
    and without a dlse cotangent; returns {name: (max abs error,
    checks)}."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [dict(b=2, s=s, h=4, d=d, dtype=dt, causal=c)
             for dt in (f32, bf16) for c in (True, False)
             for s in (128, 384, 1024) for d in (64, 128)]
    cases += [dict(b=2, s=1024, h=4, d=32, dtype=dt, causal=True)
              for dt in (f32, bf16)]
    cases += [dict(b=2, s=200, h=3, d=64, dtype=f32, causal=True),
              dict(b=2, s=200, h=3, d=64, dtype=bf16, causal=False),
              dict(b=2, s=256, h=4, d=64, dtype=f32, causal=True, fused=True),
              dict(b=2, s=256, h=4, d=64, dtype=bf16, causal=True,
                   fused=True),
              TRAIN]
    worst = {"flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    checks = 0
    for case in cases:
        b, s, h, d, dt, causal = (case[x] for x in
                                  ("b", "s", "h", "d", "dtype", "causal"))
        q, k, v = qkv_case(case, gen)
        do = torch.randn((b, s, h, d), generator=gen, device="cuda",
                         dtype=torch.float32).to(dt)
        scale = 1.0 / d ** 0.5
        _, lse = fa._fwd_cuda(q, k, v, scale=scale, causal=causal)
        for with_dlse in (False, True):
            dlse = (torch.randn((b, s, h), generator=gen, device="cuda")
                    if with_dlse else None)
            ref = fa._bwd_blockwise(q, k, v, lse, do,
                                    blk=fa._fit_block(s, 512), scale=scale,
                                    causal=causal, dlse=dlse)
            got = fa._bwd_cuda(q, k, v, lse, do, scale=scale,
                               causal=causal, dlse=dlse)
            torch.cuda.synchronize()
            names = ("dq", "dk", "dv")
            errs = {n: (g.float() - r.float()).abs().max().item()
                    for n, g, r in zip(names, got, ref)}
            atols = {n: bwd_atol(r) for n, r in zip(names, ref)}
            ok = (all(g.dtype == dt and g.shape == q.shape for g in got)
                  and all(errs[n] <= atols[n] for n in names))
            emit({"phase": "kernels", "kernel": "flash_bwd_dkdv+dq",
                  "shape": [b, s, h, d], "dtype": str(dt).split(".")[-1],
                  "causal": causal, "strided": bool(case.get("fused")),
                  "dlse": with_dlse, "err": errs, "atol": atols, "ok": ok})
            if not ok:
                fail(f"flash backward disagrees with its plain version on "
                     f"{case} (dlse {with_dlse}): {errs}, bounds {atols}")
            worst["flash_bwd_dkdv"] = max(worst["flash_bwd_dkdv"],
                                          errs["dk"], errs["dv"])
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
            checks += 1
    return {n: (e, checks) for n, e in worst.items()}


def phase_kernels_adam(ok_mod, fo, gen) -> dict:
    """K5 against `_adam_math` on the card, bit for bit, over three steps
    of a 4 MiB bucket and a ragged 128-aligned one (zero padding that
    must stay zero); then the fused optimizer's own gate. Returns
    {"adam_fp32": (0.0, checks)}: any difference fails."""
    checks = 0
    tx = fo.fused_adam(lambda step: 3e-4 * (step + 1) / 3, weight_decay=0.01)
    for payload, padded in ((1 << 20, 1 << 20), (127_539, 127_616)):
        def bucket(std):
            x = torch.zeros(padded, device="cuda")
            x[:payload] = torch.randn(payload, generator=gen,
                                      device="cuda") * std
            return x
        p = bucket(0.1)
        kern = [p.clone(), torch.zeros_like(p), torch.zeros_like(p)]
        plain = [p.clone(), torch.zeros_like(p), torch.zeros_like(p)]
        for step in range(3):
            g = bucket(0.02)
            lr, c1, c2 = tx.scalars(step)
            ok_mod.adam_fp32(kern[0], g, kern[1], kern[2], lr, c1, c2,
                             b1=tx.b1, b2=tx.b2, eps=tx.eps,
                             wd=tx.weight_decay)
            new = ok_mod._adam_math(
                plain[0], g, plain[1], plain[2], ok_mod._scalar(lr, p),
                ok_mod._scalar(c1, p), ok_mod._scalar(c2, p), tx.b1, tx.b2,
                tx.eps, tx.weight_decay)
            for t, n in zip(plain, new):
                t.copy_(n)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(kern, plain))
            pad_zero = all(not t[payload:].any().item() for t in kern)
            err = max((a - b).abs().max().item() for a, b in zip(kern, plain))
            emit({"phase": "kernels", "kernel": "adam_fp32",
                  "bucket": [payload, padded], "step": step,
                  "bitwise": bitwise, "padding_zero": pad_zero,
                  "max_abs_err": err, "ok": bitwise and pad_zero})
            if not (bitwise and pad_zero):
                fail(f"adam_fp32 differs from _adam_math on a {padded} "
                     f"bucket at step {step}: max |err| {err}, padding "
                     f"zero {pad_zero}")
            checks += 1
    gate = fo.update_parity_gate(device="cuda")
    emit({"phase": "kernels", "kernel": "adam_fp32", "gate": gate})
    if not gate["ok"]:
        fail(f"fused optimizer gate failed: {gate}")
    return {"adam_fp32": (0.0, checks + 1)}


def bwd_products_ms(products: int, b, s, h, d, dtype, causal) -> float:
    """``products`` block products of 2 flops x d per visible (query,
    key) pair, over the tensor-core rate of the type, in ms."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return products * 2 * b * h * d * pairs / PEAK_FLOPS_S[dtype] * 1e3


def bwd_bound_ms(kernel: str, b, s, h, d, dtype, causal) -> tuple:
    """Least time of one K2 (4 products: S, dP, dV, dK) or K3 (3: S, dP,
    dQ) launch: each input read once, each output written once, over the
    memory rate; the products over the tensor-core rate of the type.
    K3's first sweep, which recomputes S and dP to sum the row term, is
    this design's overhead and not in the bound."""
    elem = torch.tensor([], dtype=dtype).element_size()
    tensors = 6 if kernel == "flash_bwd_dkdv" else 5
    t_bytes = (tensors * b * s * h * d * elem
               + 2 * b * s * h * 4) / PEAK_BYTES_S * 1e3
    t_ops = bwd_products_ms(4 if kernel == "flash_bwd_dkdv" else 3,
                            b, s, h, d, dtype, causal)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_timing_train(fa, gen) -> dict:
    """K1, K2 and K3 at the training shape: each kernel's time, the
    plain backward's, and the backward of F.scaled_dot_product_attention
    (timed only, never used by the port); kernel and library in turns."""
    b, s, h, d, dt, causal = (TRAIN[k] for k in
                              ("b", "s", "h", "d", "dtype", "causal"))
    q, k, v = qkv_case(TRAIN, gen)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    scale = 1.0 / d ** 0.5
    _, lse = fa._fwd_cuda(q, k, v, scale=scale, causal=causal)
    _, rt = fa.flash_bwd_dq(q, k, v, do, lse, scale=scale, causal=causal)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()
    runs = {
        "flash_fwd": lambda: fa._fwd_cuda(q, k, v, scale=scale,
                                          causal=causal),
        "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(
            q, k, v, do, lse, rt, scale=scale, causal=causal),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, scale=scale, causal=causal),
        "sdpa_bwd": lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                retain_graph=True),
    }
    turns: dict[str, list[float]] = {n: [] for n in runs}
    for _ in range(3):
        for n, fn in runs.items():
            turns[n].append(time_ms(fn, iters=20))
    plain_ms = time_ms(lambda: fa._bwd_blockwise(
        q, k, v, lse, do, blk=fa._fit_block(s, 512), scale=scale,
        causal=causal), iters=3, warmup=1)
    library_ms = float(np.mean(turns["sdpa_bwd"]))
    out = {}
    for n in ("flash_bwd_dkdv", "flash_bwd_dq"):
        bound_ms, bound_by = bwd_bound_ms(n, b, s, h, d, dt, causal)
        out[n] = {"ms": float(np.mean(turns[n])), "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms}
    fwd_bound, _ = attention_bound_ms(b, s, h, d, dt, causal)
    emit({"phase": "timing", "shape": [b, s, h, d], "dtype": "bfloat16",
          "causal": causal, "ms_turns": turns,
          "flash_fwd_ms_train_shape": float(np.mean(turns["flash_fwd"])),
          "flash_fwd_bound_ms_train_shape": fwd_bound,
          "plain_bwd_ms": plain_ms,
          "flash_bwd_dq_row_term_sweep_ms_at_peak": bwd_products_ms(
              2, b, s, h, d, dt, causal),
          "library": "backward of F.scaled_dot_product_attention "
                     "(dQ, dK and dV together)",
          "kernels": out})
    return out


def base_config():
    from edl_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=32768, d_model=1024, n_heads=16,
                             n_layers=8, d_ff=4096, max_len=1024,
                             dtype=torch.bfloat16)


def phase_timing_adam(ok_mod, fo, gen) -> tuple[dict, int]:
    """K5 over every bucket of the base config's plan (one optimizer
    step), against the plain `_adam_math` over the same buckets and
    torch.optim.AdamW(fused=True) over the same parameters (timed only,
    never used by the port). First, two steps of K5 over every bucket
    are held against `_adam_math` bit for bit: the plan's large buckets
    (up to 33.5M elements) are the ones whose launches loop over their
    grid. Returns (the timings, the buckets checked)."""
    from edl_tpu_torch.bridge import flax_named_parameters
    from edl_tpu_torch.models.transformer import Transformer

    model = Transformer(base_config(), device="cuda", seed=0)
    named = flax_named_parameters(model)
    tx = fo.fused_adam(3e-4, weight_decay=0.01)
    plan = tx.plan(named)
    state = tx.init(named)
    for _, prm in named:
        prm.grad = torch.randn(prm.shape, generator=gen,
                               device="cuda") * 1e-3
    g_bufs = fo._grad_buckets(plan, [x for _, x in named],
                              [x.grad for _, x in named])
    lr, c1, c2 = tx.scalars(0)
    hyper = dict(b1=tx.b1, b2=tx.b2, eps=tx.eps, wd=tx.weight_decay)

    def kernel_step():
        for i in range(plan.n_buckets):
            ok_mod.adam_fp32(state.p[i], g_bufs[i], state.m[i], state.v[i],
                             lr, c1, c2, **hyper)

    scalars = [ok_mod._scalar(x, state.p[0]) for x in (lr, c1, c2)]

    kern = [[t.clone() for t in ts] for ts in (state.p, state.m, state.v)]
    plain = [[t.clone() for t in ts] for ts in (state.p, state.m, state.v)]
    for step in range(2):
        s_lr, s_c1, s_c2 = tx.scalars(step)
        s_dev = [ok_mod._scalar(x, state.p[0]) for x in (s_lr, s_c1, s_c2)]
        for i in range(plan.n_buckets):
            ok_mod.adam_fp32(kern[0][i], g_bufs[i], kern[1][i], kern[2][i],
                             s_lr, s_c1, s_c2, **hyper)
            new = ok_mod._adam_math(plain[0][i], g_bufs[i], plain[1][i],
                                    plain[2][i], *s_dev, tx.b1, tx.b2,
                                    tx.eps, tx.weight_decay)
            for t, n in zip(plain, new):
                t[i] = n
    torch.cuda.synchronize()
    differ = [i for i in range(plan.n_buckets)
              if not all(torch.equal(a[i], b[i]) for a, b in zip(kern, plain))]
    emit({"phase": "kernels", "kernel": "adam_fp32", "plan_buckets":
          plan.n_buckets, "largest_bucket": max(t.numel() for t in state.p),
          "steps": 2, "bitwise": not differ, "buckets_differing": differ})
    if differ:
        fail(f"adam_fp32 differs from _adam_math on buckets {differ} of "
             f"the base config's plan")
    del kern, plain

    def plain_step():
        for i in range(plan.n_buckets):
            ok_mod._adam_math(state.p[i], g_bufs[i], state.m[i], state.v[i],
                              *scalars, tx.b1, tx.b2, tx.eps,
                              tx.weight_decay)

    lib = torch.optim.AdamW([x for _, x in named], lr=lr, betas=(tx.b1, tx.b2),
                            eps=tx.eps, weight_decay=tx.weight_decay,
                            fused=True)
    turns: dict[str, list[float]] = {"kernel": [], "library": []}
    for _ in range(3):
        turns["kernel"].append(time_ms(kernel_step, iters=10))
        turns["library"].append(time_ms(lib.step, iters=10))
    plain_ms = time_ms(plain_step, iters=3, warmup=1)
    padded = plan.padded_elems()
    bound_ms = 28 * padded / PEAK_BYTES_S * 1e3
    out = {"ms": float(np.mean(turns["kernel"])), "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "library_ms": float(np.mean(turns["library"]))}
    emit({"phase": "timing", "kernel": "adam_fp32", "buckets": plan.n_buckets,
          "padded_elems": padded, "per": "optimizer step (all buckets)",
          "ms_turns": turns["kernel"], "library_ms_turns": turns["library"],
          "library": "torch.optim.AdamW(fused=True)", **out})
    del lib, state, model
    torch.cuda.empty_cache()
    return out, plan.n_buckets


def serve_round(port: int, plans: list[list[np.ndarray]]) -> tuple:
    """Each client sends its plan sequentially on its own connection.
    Returns (answers, client latencies in s, wall s)."""
    from edl_tpu_torch.distill.teacher_server import TeacherClient

    answers: list[list] = [[] for _ in plans]
    latencies: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()

    def client(i: int) -> None:
        try:
            c = TeacherClient(f"127.0.0.1:{port}", timeout=120.0,
                              expand=False)
            try:
                for toks in plans[i]:
                    t = time.monotonic()
                    out = c.predict({"tokens": toks})
                    with lock:
                        latencies.append(time.monotonic() - t)
                    answers[i].append((toks, out))
            finally:
                c.close()
        except Exception as exc:  # noqa: BLE001 — reported, then fatal
            errors.append(f"client {i}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(plans))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving clients failed: {errors or 'client hung'}")
    return [x for a in answers for x in a], latencies, wall_s


def check_answers(answers, seq: int, vocab: int) -> None:
    for toks, out in answers:
        idx, val = out["logits.idx"], out["logits.val"]
        rows = toks.shape[0]
        if (idx.shape != (rows, seq, TOPK) or idx.dtype != np.int32
                or val.shape != (rows, seq, TOPK)
                or val.dtype != np.float16):
            fail(f"bad response shapes {idx.shape} {idx.dtype} "
                 f"{val.shape} {val.dtype}")
        if not np.isfinite(val).all() or idx.min() < 0 or idx.max() >= vocab:
            fail("non-finite values or out-of-range indices served")


def phase_serve(fa) -> tuple:
    from edl_tpu_torch.distill.sharded_teacher import sharded_predict_fn
    from edl_tpu_torch.distill.teacher_server import TeacherServer
    from edl_tpu_torch.models.transformer import Transformer

    cfg = base_config()
    seq = cfg.max_len
    t0 = time.monotonic()
    model = Transformer(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())

    def apply(m, x):
        return m(x)

    predict, meta = sharded_predict_fn(
        apply, model, "cuda", input_key="tokens", output_key="logits",
        serve_topk=TOPK, classes=cfg.vocab_size)
    rng = np.random.default_rng(0)
    warm = predict({"tokens": rng.integers(
        0, cfg.vocab_size, (8, seq)).astype(np.int32)})()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    if warm["logits.idx"].shape != (8, seq, TOPK):
        fail(f"warm-up predict gave {warm['logits.idx'].shape}")

    rounds, first_answers = [], None
    fa.flash_attention_lse.launches = 0
    with TeacherServer(predict, host="127.0.0.1", max_batch=8,
                       compressed_meta=meta) as srv:
        for r in range(ROUNDS):
            plans = [[rng.integers(0, cfg.vocab_size,
                                   (int(rng.integers(1, 5)), seq)
                                   ).astype(np.int32)
                      for _ in range(REQS_PER_CLIENT)]
                     for _ in range(N_CLIENTS)]
            before = srv.batcher.stats()
            launches0 = fa.flash_attention_lse.launches
            answers, latencies, wall_s = serve_round(srv.port, plans)
            after = srv.batcher.stats()
            launches = fa.flash_attention_lse.launches - launches0
            check_answers(answers, seq, cfg.vocab_size)
            hist = {k: c - before["batch_rows_hist"].get(k, 0)
                    for k, c in after["batch_rows_hist"].items()}
            hist = {k: c for k, c in sorted(hist.items(),
                                            key=lambda kv: int(kv[0])) if c}
            groups = sum(hist.values())
            rows = after["served_rows"] - before["served_rows"]
            if launches != cfg.n_layers * groups:
                fail(f"round {r}: flash launches {launches} != "
                     f"{cfg.n_layers} x {groups} forwards")
            lat = np.asarray(latencies) * 1e3
            rnd = {"phase": "serve_round", "round": r,
                   "requests": len(answers), "rows": rows, "wall_s": wall_s,
                   "requests_per_s": len(answers) / wall_s,
                   "rows_per_s": rows / wall_s,
                   "latency_ms_p50": float(np.percentile(lat, 50)),
                   "latency_ms_p95": float(np.percentile(lat, 95)),
                   "latency_ms_max": float(lat.max()),
                   "batches": groups, "rows_per_batch": rows / groups,
                   "batch_rows_hist": hist, "flash_launches": launches}
            emit(rnd)
            rounds.append(rnd)
            first_answers = first_answers or answers
    launches = fa.flash_attention_lse.launches

    # the served answer of one request against plain dense attention
    dense = Transformer(replace(cfg, attention="dense"), device="cuda",
                        seed=1)
    dense.load_state_dict(model.state_dict())
    toks, out = max(first_answers, key=lambda x: x[0].shape[0])
    with torch.inference_mode():
        ref = dense(torch.as_tensor(toks, device="cuda")).float()
        ref_top1 = ref.argmax(dim=-1).cpu().numpy()
        ref_at_idx = torch.gather(ref, -1, torch.tensor(
            out["logits.idx"], dtype=torch.long, device="cuda")).cpu().numpy()
    top1_agree = float(np.mean(out["logits.idx"][..., 0] == ref_top1))
    val_err = float(np.abs(out["logits.val"].astype(np.float32)
                           - ref_at_idx).max())

    def spread(key):
        vals = [r[key] for r in rounds]
        return {"min": min(vals), "median": float(np.median(vals)),
                "max": max(vals)}

    n_req = sum(r["requests"] for r in rounds)
    groups = sum(r["batches"] for r in rounds)
    result = {"phase": "serve", "params": n_params, "setup_s": setup_s,
              "clients": N_CLIENTS, "rounds": ROUNDS, "requests": n_req,
              "requests_per_s": spread("requests_per_s"),
              "rows_per_s": spread("rows_per_s"),
              "latency_ms_p50": spread("latency_ms_p50"),
              "latency_ms_p95": spread("latency_ms_p95"),
              "rows_per_batch": spread("rows_per_batch"),
              "flash_launches": launches,
              "flash_launches_per_forward": launches / max(groups, 1),
              "check_rows": int(toks.shape[0]),
              "top1_agree_vs_dense": top1_agree,
              "top1_agree_min": TOP1_AGREE_MIN,
              "val_max_abs_err_vs_dense": val_err, "val_atol": VAL_ATOL}
    emit(result)
    if n_req < 16:
        fail(f"only {n_req} requests answered")
    if top1_agree < TOP1_AGREE_MIN or val_err > VAL_ATOL:
        fail(f"served top-{TOPK} disagrees with dense attention: top-1 "
             f"{top1_agree} (min {TOP1_AGREE_MIN}), values {val_err} "
             f"(bound {VAL_ATOL})")
    return result, model, dense, predict


def phase_forward(fa, model, dense, predict) -> None:
    """Where one 8-row forward's time goes. The flash launches and the
    fp32 lm_head are timed with CUDA events inside real forwards (the
    wrapper's launch and lm_head's module hooks record them); the rest
    is the forward less those two. top-k is timed alone on random
    logits; predict (forward, top-k, pack, device->host) on the host
    clock."""
    cfg = model.cfg
    rows, seq, iters = 8, cfg.max_len, 5
    toks_np = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    toks = torch.as_tensor(toks_np, device="cuda")
    logits = torch.randn((rows, seq, cfg.vocab_size), device="cuda")

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t) / iters * 1e3

    def event():
        return torch.cuda.Event(enable_timing=True)

    spans: dict[str, list] = {"flash": [], "lm_head": []}
    launch = fa._fwd_cuda

    def timed_launch(*args, **kw):
        start, end = event(), event()
        start.record()
        out = launch(*args, **kw)
        end.record()
        spans["flash"].append((start, end))
        return out

    def head_pre(module, args):
        spans["lm_head"].append((event(), event()))
        spans["lm_head"][-1][0].record()

    def head_post(module, args, out):
        spans["lm_head"][-1][1].record()

    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        predict_ms = host_ms(lambda: predict({"tokens": toks_np})())
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        forward_ms = time_ms(lambda: model(toks), iters=iters)
        dense_forward_ms = time_ms(lambda: dense(toks), iters=iters)
        topk_ms = time_ms(lambda: torch.topk(logits, TOPK, dim=-1),
                          iters=iters)
        hooks = [model.lm_head.register_forward_pre_hook(head_pre),
                 model.lm_head.register_forward_hook(head_post)]
        fa._fwd_cuda = timed_launch
        try:
            model(toks)   # warm-up of the timed path
            torch.cuda.synchronize()
            for v in spans.values():
                v.clear()
            timed_forward_ms = time_ms(lambda: model(toks), iters=iters,
                                       warmup=0)
        finally:
            fa._fwd_cuda = launch
            for h in hooks:
                h.remove()
    flash_ms = sum(a.elapsed_time(b) for a, b in spans["flash"]) / iters
    head_ms = sum(a.elapsed_time(b) for a, b in spans["lm_head"]) / iters
    if len(spans["flash"]) != cfg.n_layers * iters:
        fail(f"timed {len(spans['flash'])} flash launches in {iters} "
             f"forwards")
    emit({"phase": "forward", "rows": rows, "seq": seq,
          "predict_ms": predict_ms, "forward_ms": forward_ms,
          "forward_dense_attention_ms": dense_forward_ms,
          "timed_forward_ms": timed_forward_ms,
          "flash_ms_in_forward": flash_ms,
          "flash_share": flash_ms / timed_forward_ms,
          "lm_head_ms_in_forward": head_ms,
          "lm_head_share": head_ms / timed_forward_ms,
          "rest_of_forward_ms": timed_forward_ms - flash_ms - head_ms,
          "topk_ms_alone": topk_ms, "peak_gib": peak_gib})


# lm_train at the base config: 320 rows of 1024 tokens, 16 rows a step,
# one epoch = 20 steps; steps 4..20 are timed.
TRAIN_ARGV = ["--make-synthetic", "1", "--rows-per-file", "320",
              "--vocab", "32768", "--seq-len", "1024", "--d-model", "1024",
              "--n-heads", "16", "--n-layers", "8", "--d-ff", "4096",
              "--batch-size", "16", "--bf16", "--fused-opt", "fp32",
              "--epochs", "1"]
TIMED_FROM_STEP = 4
# One step, flash (K1-K3) against dense attention, same weights and batch
# (bounds written to PERF.md before the first run): the two differ only
# in where attention rounds to bf16.
ONE_STEP_LOSS_ATOL = 2e-2
ONE_STEP_GRAD_REL = 0.1


def exact_dq(q, k, v, do, o_row, scale: float, rows: int = 2) -> tuple:
    """dq of causal attention in fp64 from the bf16 q, k, v, dO (B, S, H,
    D), with the exact row term rt = sum_k p dP, and with the JAX
    package's rt = rowsum(dO * o_row) (o_row: the forward's bf16 output),
    all else exact. ``rows`` batch rows at a time."""
    out = ([], [])
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    for i in range(0, q.shape[0], rows):
        q64, k64, v64, do64, o64 = (x[i:i + rows].double() for x in
                                    (q, k, v, do, o_row))
        logits = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale
        p = logits.masked_fill(~mask, float("-inf")).softmax(-1)
        dp = torch.einsum("bqhd,bkhd->bhqk", do64, v64)
        for dst, rt in ((out[0], (p * dp).sum(-1)),
                        (out[1], (do64 * o64).sum(-1).transpose(1, 2))):
            ds = p * (dp - rt[..., None]) * scale
            dst.append(torch.einsum("bhqk,bkhd->bqhd", ds, k64))
    return torch.cat(out[0]), torch.cat(out[1])


def row_term_check(fa, caught: list) -> None:
    """Each layer's dq from one training step against the exact fp64
    gradient on the same bf16 inputs: K3's (row term summed from p dP in
    fp32), and the one from the JAX package's row term rowsum(dO * O)
    with O in bf16. Also each layer's keys: the norm of their mean and
    their spread about it, per head, averaged over heads (a large mean
    multiplies the row term's error into dq). Fails if K3's dq is off by
    more than ONE_STEP_GRAD_REL in any layer."""
    layers = []
    for q, k, v, do in caught:
        scale = 1.0 / q.shape[-1] ** 0.5
        o, lse = fa._fwd_cuda(q, k, v, scale=scale, causal=True)
        dq_kernel = fa._bwd_cuda(q, k, v, lse, do, scale=scale,
                                 causal=True)[0]
        exact, from_o = exact_dq(q, k, v, do, o, scale)

        def rel(x):
            return ((x.double() - exact).norm() / exact.norm()).item()

        k64 = k.double()
        mean = k64.mean(dim=1, keepdim=True)         # (B, 1, H, D)
        layers.append({
            "dq_exact_norm": exact.norm().item(),
            "dq_rel_err_kernel": rel(dq_kernel),
            "dq_rel_err_row_term_from_bf16_o": rel(from_o),
            "key_mean_norm": mean.norm(dim=-1).mean().item(),
            "key_spread": (k64 - mean).norm(dim=-1).pow(2).mean(dim=1)
                          .sqrt().mean().item()})
        del exact, from_o
    torch.cuda.empty_cache()
    worst = max(x["dq_rel_err_kernel"] for x in layers)
    emit({"phase": "row_term", "layers": layers,
          "dq_rel_err_kernel_max": worst, "bound": ONE_STEP_GRAD_REL})
    if worst > ONE_STEP_GRAD_REL:
        fail(f"K3's dq is {worst} (relative L2) from the exact gradient "
             f"(bound {ONE_STEP_GRAD_REL})")


def phase_train(fa, ok_mod) -> dict:
    """The port's lm_train.main on the card at the base config. Each step
    is timed on the host clock between two synchronizes, and its forward,
    backward and optimizer with CUDA events (lm_train's loss function and
    TrainState.apply_gradients wrapped for the run); launch counts are
    read around every step. Then one step of flash against dense
    attention on the trained weights and the first batch."""
    import contextlib
    import io
    import tempfile
    from dataclasses import replace as dc_replace

    from edl_tpu_torch.examples import lm_train
    from edl_tpu_torch.models import transformer as tr
    from edl_tpu_torch.models.transformer import Transformer, lm_loss_fn
    from edl_tpu_torch.train import state as state_lib

    counters = (fa.flash_attention_lse, fa.flash_bwd_dkdv, fa.flash_bwd_dq,
                ok_mod.adam_fp32)
    names = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "adam_fp32")

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    steps: list[dict] = []
    ev: dict = {}
    seen: dict = {}
    make_step = lm_train.make_train_step
    apply_gradients = state_lib.TrainState.apply_gradients

    def timed_make(loss_fn, **kw):
        def timed_loss(model, batch):
            ev["fwd0"] = event()
            out = loss_fn(model, batch)
            ev["fwd1"] = event()
            return out

        step = make_step(timed_loss, **kw)

        def timed_step(state, batch):
            if "batch" not in seen:
                seen["batch"] = {k: v.clone() for k, v in batch.items()}
            torch.cuda.synchronize()
            c0 = [c.launches for c in counters]
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps.append({"ms": (t1 - t0) * 1e3, "events": dict(ev),
                          "launches": [c.launches - n
                                       for c, n in zip(counters, c0)],
                          "loss": metrics["loss"]})
            seen["state"] = state
            return state, metrics
        return timed_step

    def timed_apply(self):
        ev["opt0"] = event()
        out = apply_gradients(self)
        ev["opt1"] = event()
        return out

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as data_dir:
        lm_train.make_train_step = timed_make
        state_lib.TrainState.apply_gradients = timed_apply
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            t0 = time.monotonic()
            with contextlib.redirect_stdout(out):
                rc = lm_train.main(["--data-dir", data_dir, *TRAIN_ARGV])
            wall_s = time.monotonic() - t0
            launches = {n: c.launches for n, c in zip(names, counters)}
        finally:
            lm_train.make_train_step = make_step
            state_lib.TrainState.apply_gradients = apply_gradients
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    printed = out.getvalue()
    print(printed, end="", flush=True)
    final = [ln for ln in printed.splitlines()
             if ln.startswith("final_eval_loss=")]
    if rc != 0 or not final:
        fail(f"lm_train.main returned {rc} and printed {printed!r}")
    final_eval_loss = float(final[-1].split("=", 1)[1])

    state = seen["state"]
    n_buckets = len(state.opt_state.p)
    want = [8, 8, 8, n_buckets]
    for i, st in enumerate(steps):
        if st["launches"] != want:
            fail(f"step {i + 1} launched {dict(zip(names, st['launches']))}"
                 f", want {dict(zip(names, want))}")
    losses = [float(st["loss"]) for st in steps]
    timed = steps[TIMED_FROM_STEP - 1:]
    ms = [st["ms"] for st in timed]

    def span(a, b):
        return float(np.median([st["events"][a].elapsed_time(
            st["events"][b]) for st in timed]))

    cfg = state.model.cfg
    b, s = 16, cfg.max_len
    result = {"phase": "train", "argv": TRAIN_ARGV, "steps": len(steps),
              "params": sum(p.numel() for p in state.model.parameters()),
              "buckets": n_buckets, "wall_s": wall_s,
              "step_ms_median": float(np.median(ms)),
              "step_ms_min": min(ms), "step_ms_max": max(ms),
              "timed_steps": f"{TIMED_FROM_STEP}-{len(steps)}",
              "tokens_per_s": b * s / (float(np.median(ms)) / 1e3),
              "breakdown_ms_median": {
                  "forward": span("fwd0", "fwd1"),
                  "backward": span("fwd1", "opt0"),
                  "optimizer": span("opt0", "opt1")},
              "loss_first": losses[0], "loss_last": losses[-1],
              "losses": losses, "final_eval_loss": final_eval_loss,
              "peak_gib": peak_gib,
              "launches_per_step": dict(zip(names, want)),
              "launches": launches}
    emit(result)
    if not all(np.isfinite(losses)) or not np.isfinite(final_eval_loss):
        fail(f"non-finite loss: {losses}, eval {final_eval_loss}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: first {losses[0]}, last {losses[-1]}")

    # one step, flash against dense attention: same weights, same batch
    model = state.model
    dense = Transformer(dc_replace(cfg, attention="dense"),
                        device=model.lm_head.weight.device, seed=1)
    dense.load_state_dict(model.state_dict())
    dense.train()
    batch = seen["batch"]
    grads, step_loss = {}, {}
    # each flash layer's q, k, v and the cotangent of its output
    caught: list[list] = []
    flash_attention = tr.flash_attention

    def catching(q, k, v, **kw):
        o = flash_attention(q, k, v, **kw)
        caught.append([q.detach(), k.detach(), v.detach(), None])
        o.register_hook(lambda g, i=len(caught) - 1:
                        caught[i].__setitem__(3, g.detach()))
        return o

    for name, m in (("flash", model), ("dense", dense)):
        m.zero_grad(set_to_none=True)
        tr.flash_attention = catching if name == "flash" else flash_attention
        try:
            loss, _ = lm_loss_fn(m, batch)
            loss.backward()
        finally:
            tr.flash_attention = flash_attention
        step_loss[name] = loss.item()
        grads[name] = {n: p.grad.float() for n, p in m.named_parameters()}
    rel = {n: ((grads["flash"][n] - g).norm() / g.norm().clamp_min(1e-30))
           .item() for n, g in grads["dense"].items()}
    worst = max(rel, key=rel.get)
    check = {"phase": "train_check", "rows": int(batch["tokens"].shape[0]),
             "loss_flash": step_loss["flash"],
             "loss_dense": step_loss["dense"],
             "loss_abs_diff": abs(step_loss["flash"] - step_loss["dense"]),
             "loss_atol": ONE_STEP_LOSS_ATOL,
             "grad_rel_err_max": rel[worst], "grad_rel_err_max_leaf": worst,
             "grad_rel_err_median": float(np.median(list(rel.values()))),
             "grad_rel_bound": ONE_STEP_GRAD_REL, "grad_rel_err": rel}
    emit(check)
    if (check["loss_abs_diff"] > ONE_STEP_LOSS_ATOL
            or rel[worst] > ONE_STEP_GRAD_REL):
        fail(f"flash and dense attention disagree on one step: loss "
             f"{check['loss_abs_diff']} (bound {ONE_STEP_LOSS_ATOL}), "
             f"grad {worst} {rel[worst]} (bound {ONE_STEP_GRAD_REL})")
    if len(caught) != cfg.n_layers:
        fail(f"caught {len(caught)} flash layers, want {cfg.n_layers}")
    del model, dense, state, seen, grads
    torch.cuda.empty_cache()
    row_term_check(fa, caught)
    del caught
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(HERE))
    import edl_tpu_torch
    if Path(edl_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"edl_tpu_torch imported from {edl_tpu_torch.__file__}, "
             f"not from {HERE}")
    from edl_tpu_torch.ops import _build
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops import opt_kernels as ok_mod
    from edl_tpu_torch.train import fused_opt as fo

    # fp32 products in full fp32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    card = card_line()
    print(card, flush=True)
    built = _build.build_all()
    emit({"phase": "build", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernels": {n: {"seconds": r["seconds"],
                          "ptxas": [ln.strip() for ln in r["log"].splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for n, r in built.items()}})

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernels(fa, gen)
    errs.update(phase_kernels_bwd(fa, gen))
    errs.update(phase_kernels_adam(ok_mod, fo, gen))
    timing = {"flash_fwd": phase_timing(fa, gen)}
    timing.update(phase_timing_train(fa, gen))
    timing["adam_fp32"], plan_checks = phase_timing_adam(ok_mod, fo, gen)
    errs["adam_fp32"] = (0.0, errs["adam_fp32"][1] + plan_checks)
    serve, model, dense, predict = phase_serve(fa)
    launches = {"serve": {"flash_fwd": serve["flash_launches"]}}
    phase_forward(fa, model, dense, predict)
    del model, dense, predict
    torch.cuda.empty_cache()
    launches["train"] = phase_train(fa, ok_mod)
    emit({"seconds": time.monotonic() - t_start, "card": card})

    kernels = []
    for name, source, replaces in KERNELS:
        by_path = {path: n[name] for path, n in launches.items() if name in n}
        for path, n in by_path.items():
            if n <= 0:
                fail(f"{name} was launched {n} times on the {path} path")
        max_err, checks = errs[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "checks": checks,
                        "max_abs_err": max_err, **timing[name],
                        "ok": True})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
