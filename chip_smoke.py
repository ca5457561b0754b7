#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repo root; needs a card and nvcc

Phases, each printed as JSON lines; any failure exits non-zero:

1. build   — the card's name and power limit (nvidia-smi), then every
             kernel under edl_tpu_torch/ops/csrc built with nvcc for sm_90a
             (one nvcc per source, started together); for the flash
             forward and backward (each library's report under its name),
             each kernel's registers and spills (ptxas) and its wgmma
             (HGMMA) and TMA load (UTMALDG) instructions in the built SASS
             (cuobjdump): each bf16 body must hold both, spill nothing and
             never write a register a wgmma reads as its A operand before
             the product (or its loop's next turn) has read it;
2. kernels — each kernel against its plain PyTorch version on the card,
             on the same inputs: K1 (flash forward) and K2/K3 (flash
             backward, with and without a dlse cotangent) over a grid of
             shapes, strided q/k/v, ragged S, one served row (K1) and the
             serving and training shapes (bounds: K1 2e-5 fp32 / 3e-2
             bf16 as tests/test_flash_attention.py; K2/K3 5e-5 fp32 /
             3e-2 x max(1, max |ref|) bf16; K1 twice, and K3 then K2
             twice, bit for bit, on the training shape, a strided and a
             ragged case); bit for bit: K5 (fused Adam)
             over 3 steps of a 4 MiB and a ragged bucket, K4 (momentum-SGD),
             K6 (quantized momentum-SGD, int8 and fp8) and K7 (quantized
             Adam, int8 and fp8) over 3 steps of a 4 MiB, a ragged, an
             all-zero and a pinned-abs-max bucket with wd 0 and 1e-4
             (p, moments, quantized payloads and scales), K5, K6 and K7
             in one table over those four buckets, each step also
             repeated in a second launch and held against the first, the
             fused optimizer's gate (every optimizer x quant mode), and
             (in the timing phase) two steps over every bucket of the
             main paths' plans (K4's, K6's and K7's steps also
             repeated in a second launch): the base LM's (K5 as one
             launch over all 60 buckets; K7 as one entry call, int8 and
             fp8 m) and ResNet50_vd's (K4 as one launch over all 24
             buckets; K6 as one entry call, int8 and fp8);
             K8 (the int8 gradient pack: q and the scale's bits) on the
             CPU tests' grid, a 4 MiB shard and every compressed bucket
             of ResNet50_vd's comm plan at world 2 filled with the real
             gradients of steps 1 and 2, each shard alone and each set
             as one table;
3. timing  — each kernel at its main path's shape: its time, its plain
             version's, one PyTorch library call computing the same
             function (timed only, never used by the port; none for
             K6/K7/K8), and the least time the card could take for the
             work; K1 at the serving (B=8) and training (B=16) shapes
             beside F.scaled_dot_product_attention, device time queued
             and host-paced, with its TFLOP/s over its 2 products; for K2
             and K3 also their sum beside the library call (SDPA's whole
             backward) and each one's TFLOP/s over the products it
             computes. The optimizer kernels and K8 are timed over one
             step of their plan with the host queued ahead of the card
             (device time); K5 also launched once per bucket, and each
             of K6's, K7's and K8's passes alone (K7's C also with its
             loads and stores alone) beside its bytes' bound, K8 on step
             2's gradients (step 1's, mostly zeros, beside it), and K6's
             and K8's registers and spills (ptxas);
4. serve   — the transformer LM teacher at the repo's base config
             (bench.py's: vocab 32768, d_model 1024, 16 heads, 8 layers,
             d_ff 4096, S 1024, bf16 activations, fp32 params; seeded
             random weights) behind TeacherServer, answering 16
             concurrent TeacherClients with device top-16, in 3 rounds
             of 400 requests. Launch counters are set to 0 just before
             and read just after; the answers are held against the same
             weights with plain dense attention;
5. forward — where one 8-row predict's time goes: the flash launches and
             lm_head timed with CUDA events inside real forwards;
6. train   — the port's lm_train.main at the base config, 16 rows a
             step, 20 steps (--bf16 --fused-opt fp32): step time, the
             forward / backward / optimizer split, launches per step
             (exactly 8 K1, 8 K2, 8 K3 and one K5 over every bucket), the
             loss falling; then one step of flash against dense attention on
             the trained weights, and each layer's dq from that step
             against the exact (fp64) gradient: K3's, and the one the
             JAX package's row term rowsum(dO*O), with O in bf16, gives;
7. train_int8 — the same lm_train run with --fused-opt int8: exactly one
             K7 entry call a step (a memset and three passes over every
             bucket) beside K1-K3, peak memory, the loss finite and
             falling and within 0.25 x the fp32 run's improvement of its
             last loss, the optimizer state >= 1.8x smaller;
8. train_resnet — the port's imagenet_train.main at bench.py's ResNet
             config (ResNet50_vd, bf16, 224 px, 1000 classes, 128 images
             a step, 2 epochs of 5 synthetic shards of 256 rows) with
             --fused-opt fp32 (one K4 a step over every bucket), a profiled
             window of 3 more steps (device busy and idle share, the
             kernels that take the time), then --fused-opt int8 (one K6
             entry call a step over every bucket) on the same shards from
             the same init:
             step time, images/s, the split, peak memory, eval acc1/acc5,
             the last epoch's mean loss below the first step's and the
             first epoch's, the int8 run within the envelope of the fp32
             run and its state >= 1.8x smaller;
9. train_resnet_world — imagenet_train.main at the same config over a
             world of two ranks sharing the card (this script re-entered
             with --world-worker, gloo, every collective staged through
             host memory; 64 images a rank), --fused-opt fp32, from the
             same init on the same shards: --dcn-compress int8 and
             --comm-bucket-mb 4 (bucketed dense). Per step and rank:
             exactly one K8 call over every compressed bucket (none
             dense) and one K4 over every optimizer bucket; step and
             reduction times, the device memory the reduction adds and
             each rank's peak; the ranks' final states bitwise equal; the loss finite with falling
             epoch means; the int8 run within 0.25 x the dense run's
             improvement; the int8 wire <= 0.26 x the fp32 leg's bytes;
             loss_parity_gate on ResNet50_vd (3 steps, bitwise dense, int8
             loss delta <= 5e-3).

The line before the last lists every ported kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import re
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
    ("sgdm_fp32", "edl_tpu_torch/ops/csrc/sgdm.cu",
     "edl_tpu/ops/opt_kernels.py:194"),
    ("sgdm_q", "edl_tpu_torch/ops/csrc/sgdm.cu",
     "edl_tpu/ops/opt_kernels.py:202"),
    ("adam_q", "edl_tpu_torch/ops/csrc/adam_q.cu",
     "edl_tpu/ops/opt_kernels.py:227"),
    ("pack_int8", "edl_tpu_torch/ops/csrc/pack.cu",
     "edl_tpu/ops/pack.py:86"),
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


def time_ms_queued(fn, iters: int, warmup: int = 3) -> tuple[float, bool]:
    """Device ms of one ``fn()`` with the host ahead of the card: a sleep
    kernel holds the stream while the host enqueues ``iters`` calls, so
    the launches run back to back and the events time the kernels, not
    the host's launch loop. A stream holds about a thousand pending
    launches before the host blocks: keep ``iters`` x the launches of one
    call under that. Returns (ms, host_bound): host_bound is True when
    the sleep ended before the host had enqueued every call (the time
    then includes idle gaps and is an upper bound)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)      # ~0.1 s at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    host_bound = start.query()          # the sleep already ended
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, bool(host_bound)


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


def kernel_name(mangled: str) -> str:
    """The readable name of a kernel from its mangled symbol, e.g.
    dkdv_wgmma_kernel<64> or sgdm_q_kernel<2,1,0>: the last identifier of
    its (nested) name, when it ends in "kernel", with its integer and
    bool template arguments."""
    m = re.match(r"_ZN?", mangled)
    if m is None:
        return mangled
    i, ident = m.end(), ""
    while d := re.match(r"\d+", mangled[i:]):
        i += d.end()
        ident, i = mangled[i:i + int(d.group())], i + int(d.group())
    if not ident.endswith("kernel"):
        return mangled
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    if args is None:
        return ident
    return ident + "<" + ",".join(re.findall(r"L[ib](\d+)E", args[1])) + ">"


def ptxas_kernels(log: str) -> dict:
    """{kernel: {"registers", "spill_bytes"}} from a ptxas -v log."""
    out: dict[str, dict] = {}
    name = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m[1])
            out[name] = {}
        elif name is not None:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              ln):
                out[name]["spill_bytes"] = int(m[1]) + int(m[2])
            if m := re.search(r"Used (\d+) registers", ln):
                out[name]["registers"] = int(m[1])
    return out


def sass_functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """{kernel: [(address, instruction)]} from cuobjdump --dump-sass."""
    out: dict[str, list] = {}
    ins = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            ins = out.setdefault(kernel_name(ln.split("Function :")[1].strip()),
                                 [])
        elif ins is not None:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
            if m:
                ins.append((int(m[1], 16), m[2]))
    return out


def sass_operands(text: str) -> tuple[str | None, list[str]]:
    """(the register an instruction writes, or None; the registers it
    reads), from its SASS text: the first general register operand,
    after a predicate destination if there is one (SHFL, LOP3), is the
    destination of an instruction that writes one (not of HGMMA, whose
    accumulator it reads too, nor of a store or branch)."""
    regs = re.findall(r"\bR\d+\b", text)
    m = re.match(r"(?:@!?U?P\w+ )?(?!HGMMA|ST|BRA)[A-Z][\w.]* "
                 r"(?:U?P\w+, )?(R\d+)\b", text)
    if m is None:
        return None, regs
    return m[1], regs[1:]


def wgmma_a_hazards(ins: list[tuple[int, str]]) -> list[tuple[str, str]]:
    """Writes that may clobber a register an HGMMA (wgmma) reads as its A
    operand, before the product or a later turn of its loop has read it:
    (1) on a path from the HGMMA to the wait that covers it. An HGMMA
    marked gsb0 closes a commit group, and WARPGROUP.DEPBAR.LE gsb0, N
    returns once at most N groups are pending, so it covers the HGMMA
    once N groups have closed after the HGMMA's own. The path follows the
    innermost loop's back edge as well as its exit. (2) Later in a loop
    whose earlier turns the HGMMA reads the register from unwritten (a
    value from before the loop), the last write before the back edge, if
    something else reads its value before the back edge: it was made for
    another use, and the next turn's product reads it (ptxas has been
    seen to give a loop-invariant operand's register to another value).
    A last value that goes unread to the back edge is the next turn's
    operand (a software-pipelined loop); a register used for something
    else after the wait that covers the product and then written again
    is no hazard."""
    def writes(text, regs):
        return sass_operands(text)[0] in regs

    at = {a: i for i, (a, _) in enumerate(ins)}
    backs = [(a, int(m[1], 16)) for a, t in ins
             if (m := re.search(r"\bBRA (0x[0-9a-f]+)", t))
             and int(m[1], 16) < a]
    found = []
    for i0, (a0, t0) in enumerate(ins):
        m = re.match(r"HGMMA\.\S+ R\d+, R(\d+),", t0)
        if not m:
            continue
        regs = {f"R{int(m[1]) + i}" for i in range(4)}
        loops = [(b, h) for b, h in backs if h <= a0 < b]
        b, h = min(loops) if loops else (None, None)
        todo, seen = [(i0 + 1, int("gsb0" in t0), False)], set()
        while todo:
            i, closed, wrapped = todo.pop()
            while i < len(ins) and (i, closed, wrapped) not in seen:
                seen.add((i, closed, wrapped))
                a, t = ins[i]
                dep = re.search(r"DEPBAR\.LE gsb0, 0x([0-9a-f]+)", t)
                if dep and closed and closed - 1 >= int(dep[1], 16):
                    break
                if writes(t, regs):
                    found.append((hex(a), t))
                closed += t.startswith("HGMMA") and "gsb0" in t
                if a == b and not wrapped and h in at:
                    todo.append((at[h], closed, True))
                i += 1
        if b is not None and not any(writes(t, regs) for a, t in ins
                                     if h <= a < a0):
            body = [(a, t) for a, t in ins if a0 < a <= b]
            last = {sass_operands(t)[0]: j for j, (_, t) in enumerate(body)
                    if sass_operands(t)[0] in regs}
            for j in sorted(last.values()):
                a, t = body[j]
                if any(sass_operands(t)[0] in sass_operands(t2)[1]
                       for _, t2 in body[j + 1:]):
                    found.append((hex(a), t))
    return list(dict.fromkeys(found))


# The libraries whose bf16 bodies are wgmma fed by TMA: K1, and K2/K3.
FLASH_LIBS = ("flash_fwd", "flash_bwd")


def flash_build(build, logs: dict[str, str]) -> dict:
    """What the bf16 flash bodies were built into, per library of
    FLASH_LIBS: per kernel its registers and spills (ptxas), its count of
    wgmma (HGMMA) and TMA load (UTMALDG) instructions in the SASS of the
    built library (cuobjdump), and the writes that may clobber a wgmma's
    A operand (wgmma_a_hazards). Fails unless each library has wgmma
    bodies and each holds both instructions, spills nothing and has no
    such write. Returns {library: report}."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    reports, bad = {}, {}
    for lib in FLASH_LIBS:
        sass = subprocess.run([str(cuobjdump), "--dump-sass",
                               str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        kernels = ptxas_kernels(logs[lib])
        for name, ins in sass_functions(sass).items():
            kernels.setdefault(name, {}).update(
                HGMMA=sum("HGMMA" in t for _, t in ins),
                UTMALDG=sum("UTMALDG" in t for _, t in ins),
                a_operand_hazards=wgmma_a_hazards(ins)[:4])
        wgmma = {n: k for n, k in kernels.items() if "wgmma" in n}
        ok = bool(wgmma) and all(k.get("HGMMA") and k.get("UTMALDG")
                                 and k.get("spill_bytes") == 0
                                 and not k.get("a_operand_hazards")
                                 for k in wgmma.values())
        reports[lib] = {"kernels": kernels, "ok": ok}
        if not ok:
            bad[lib] = wgmma
    if bad:
        emit({"phase": "build", **reports})
        fail(f"bf16 flash bodies lack HGMMA/UTMALDG, spill, or may clobber "
             f"a wgmma operand: {bad}")
    return reports


def phase_kernels(fa, gen) -> dict:
    """K1 vs its plain version on the card, over a grid of shapes, a
    strided (fused qkv) case, bf16 ragged cases (S = 200, causal and
    not), one served row (B=1), a negative scale and the serving and
    training shapes; on
    the training shape, the strided and the ragged causal case also two
    launches, o and lse bit for bit. Returns {"flash_fwd": (max abs
    error, checks)}."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [dict(b=2, s=s, h=4, d=d, dtype=dt, causal=c)
             for dt in (f32, bf16)
             for c in (True, False) for s in (128, 384, 1024)
             for d in (64, 128)]
    cases += [dict(b=2, s=1024, h=4, d=32, dtype=dt, causal=True)
              for dt in (f32, bf16)]
    strided = dict(b=2, s=256, h=4, d=64, dtype=bf16, causal=True, fused=True)
    ragged = [dict(b=2, s=200, h=3, d=64, dtype=bf16, causal=c)
              for c in (True, False)]
    # a negative scale takes the bf16 body's softmax that forms s * scale
    # first (the max of s is the max of the scores only for scale > 0)
    cases += [dict(b=2, s=200, h=3, d=64, dtype=f32, causal=True), strided,
              *ragged, dict(b=1, s=1024, h=16, d=64, dtype=bf16, causal=True),
              dict(b=2, s=384, h=4, d=64, dtype=bf16, causal=True,
                   scale=-0.125),
              MAIN, TRAIN]
    # the cases run twice and held bit for bit between the launches
    twice = {id(TRAIN), id(strided), id(ragged[0])}
    worst, checks = 0.0, 0
    for case in cases:
        b, s, h, d, dt = case["b"], case["s"], case["h"], case["d"], \
            case["dtype"]
        q, k, v = qkv_case(case, gen)
        scale = case.get("scale", 1.0 / d ** 0.5)
        o_ref, lse_ref = fa._fwd_blockwise(
            q, k, v, blk=fa._fit_block(s, 512), scale=scale,
            causal=case["causal"])
        o, lse = fa.flash_attention_lse(q, k, v, causal=case["causal"],
                                        scale=scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok = (o.dtype == dt and o.shape == q.shape
              and lse.shape == (b, s, h)
              and err_o <= ATOL[dt] and err_lse <= ATOL[dt])
        emit({"phase": "kernels", "kernel": "flash_fwd",
              "shape": [b, s, h, d], "dtype": str(dt).split(".")[-1],
              "causal": case["causal"], "strided": bool(case.get("fused")),
              "scale": scale, "err_o": err_o, "err_lse": err_lse,
              "atol": ATOL[dt], "ok": ok})
        if not ok:
            fail(f"flash_fwd disagrees with its plain version on {case}: "
                 f"o {err_o}, lse {err_lse}, bound {ATOL[dt]}")
        worst = max(worst, err_o, err_lse)
        checks += 1
        if id(case) in twice:
            fwd_deterministic(fa, case, q, k, v, o, lse)
            checks += 1
    return {"flash_fwd": (worst, checks)}


def fwd_deterministic(fa, case, q, k, v, o, lse) -> None:
    """K1 launched again on the same inputs: o and lse must be bitwise
    equal to the first launch's (one block writes each row, its sums in
    a fixed order)."""
    o2, lse2 = fa.flash_attention_lse(q, k, v, causal=case["causal"])
    torch.cuda.synchronize()
    same = {"o": torch.equal(o, o2), "lse": torch.equal(lse, lse2)}
    emit({"phase": "kernels", "kernel": "flash_fwd", "shape": list(q.shape),
          "strided": bool(case.get("fused")), "causal": case["causal"],
          "bitwise_repeat": same, "ok": all(same.values())})
    if not all(same.values()):
        fail(f"flash_fwd is not deterministic on {case}: {same}")


# K1 is timed at the serving path's shape and the training path's.
FWD_TIMED = (("serving", MAIN), ("training", TRAIN))


def phase_timing(fa, gen) -> dict:
    """K1 against F.scaled_dot_product_attention (timed only, never used
    by the port) at each shape of FWD_TIMED, in turns (3 turns each):
    device time with the launches queued behind a sleep kernel (50
    launches; fails if the host could not stay ahead) and host-paced time
    (20 launches, the Python wrapper's cost included); the plain version's
    time, the bound, and the TFLOP/s of the 2 products. Returns the
    serving shape's numbers, the training shape's beside them."""
    per = {}
    for label, cfg in FWD_TIMED:
        b, s, h, d, dt, causal = (cfg[k] for k in
                                  ("b", "s", "h", "d", "dtype", "causal"))
        q, k, v = qkv_case(cfg, gen)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        runs = {"kernel": lambda: fa.flash_attention_lse(q, k, v,
                                                         causal=causal),
                "library": lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)}
        queued = {n: [] for n in runs}
        paced = {n: [] for n in runs}
        host_bound = False
        for _ in range(3):
            for n, fn in runs.items():
                ms, hb = time_ms_queued(fn, iters=50)
                queued[n].append(ms)
                host_bound |= hb
                paced[n].append(time_ms(fn, iters=20))
        plain_ms = time_ms(lambda: fa._fwd_blockwise(
            q, k, v, blk=fa._fit_block(s, 512), scale=1.0 / d ** 0.5,
            causal=causal), iters=5)
        bound_ms, bound_by = attention_bound_ms(b, s, h, d, dt, causal)
        ms = float(np.mean(queued["kernel"]))
        library_ms = float(np.mean(queued["library"]))
        per[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "ms_host_paced": float(np.mean(paced["kernel"])),
            "library_ms_host_paced": float(np.mean(paced["library"])),
            "tflops": bwd_tflops(2, ms, b, s, h, d, causal),
            "library_tflops": bwd_tflops(2, library_ms, b, s, h, d, causal)}
        emit({"phase": "timing", "kernel": "flash_fwd", "path": label,
              "shape": [b, s, h, d], "dtype": "bfloat16", "causal": causal,
              **per[label], "ms_turns": queued["kernel"],
              "library_ms_turns": queued["library"],
              "ms_host_paced_turns": paced["kernel"],
              "library_ms_host_paced_turns": paced["library"],
              "host_bound": host_bound, "products": 2,
              "timing": "device: launches queued behind a sleep kernel",
              "library": "F.scaled_dot_product_attention"})
        if host_bound:
            fail("flash_fwd: the host could not queue the timed launches "
                 "ahead of the card")
    return {**per["serving"], "training_shape": per["training"]}


def bwd_atol(ref: torch.Tensor) -> float:
    if ref.dtype == torch.float32:
        return BWD_ATOL_FP32
    return BWD_REL_BF16 * max(1.0, ref.float().abs().max().item())


def phase_kernels_bwd(fa, gen) -> dict:
    """K2 and K3 against the plain `_bwd_blockwise` on the card, with
    and without a dlse cotangent; on the training shape, a strided and a
    ragged case also K3 then K2 twice, bit for bit. Returns {name: (max
    abs error, checks)}."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [dict(b=2, s=s, h=4, d=d, dtype=dt, causal=c)
             for dt in (f32, bf16) for c in (True, False)
             for s in (128, 384, 1024) for d in (64, 128)]
    cases += [dict(b=2, s=1024, h=4, d=32, dtype=dt, causal=True)
              for dt in (f32, bf16)]
    ragged = dict(b=2, s=200, h=3, d=64, dtype=bf16, causal=False)
    strided = dict(b=2, s=256, h=4, d=64, dtype=bf16, causal=True, fused=True)
    cases += [dict(b=2, s=200, h=3, d=64, dtype=f32, causal=True), ragged,
              dict(b=2, s=256, h=4, d=64, dtype=f32, causal=True, fused=True),
              strided, TRAIN]
    # the cases run twice, K3 then K2, and held bit for bit between runs
    twice = {id(TRAIN), id(ragged), id(strided)}
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
            if with_dlse and id(case) in twice:
                bwd_deterministic(fa, case, q, k, v, do, lse, dlse, scale)
                checks += 1
    return {n: (e, checks) for n, e in worst.items()}


def bwd_deterministic(fa, case, q, k, v, do, lse, dlse, scale) -> None:
    """K3 then K2, twice on the same inputs: dq, rt, dk and dv must be
    bitwise equal between the runs (each gradient element is written by
    one block, its sums in a fixed order)."""
    runs = []
    for _ in range(2):
        dq, rt = fa.flash_bwd_dq(q, k, v, do, lse, dlse, scale=scale,
                                 causal=case["causal"])
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, rt, scale=scale,
                                   causal=case["causal"])
        runs.append((dq, rt, dk, dv))
    torch.cuda.synchronize()
    same = {n: torch.equal(a, b)
            for n, a, b in zip(("dq", "rt", "dk", "dv"), *runs)}
    emit({"phase": "kernels", "kernel": "flash_bwd_dkdv+dq",
          "shape": list(q.shape), "strided": bool(case.get("fused")),
          "causal": case["causal"], "bitwise_repeat": same,
          "ok": all(same.values())})
    if not all(same.values()):
        fail(f"flash backward is not deterministic on {case}: {same}")


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


# Block products each backward computes: K2 S, dP, dV, dK; K3 S and dP
# in each of its two sweeps, then dS K; SDPA's backward recomputes S and
# dP once for dQ, dK and dV together.
BWD_PRODUCTS = {"flash_bwd_dkdv": 4, "flash_bwd_dq": 5, "sdpa_bwd": 5}


def bwd_tflops(products: int, ms: float, b, s, h, d, causal) -> float:
    """Achieved TFLOP/s of ``products`` block products over the visible
    (query, key) pairs in ``ms``."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return products * 2 * b * h * d * pairs / (ms * 1e-3) / 1e12


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
    tflops = {n: bwd_tflops(p, float(np.mean(turns[n])), b, s, h, d, causal)
              for n, p in BWD_PRODUCTS.items()}
    out = {}
    for n in ("flash_bwd_dkdv", "flash_bwd_dq"):
        bound_ms, bound_by = bwd_bound_ms(n, b, s, h, d, dt, causal)
        out[n] = {"ms": float(np.mean(turns[n])), "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms, "tflops": tflops[n],
                  "products": BWD_PRODUCTS[n]}
    fwd_bound, _ = attention_bound_ms(b, s, h, d, dt, causal)
    emit({"phase": "timing", "shape": [b, s, h, d], "dtype": "bfloat16",
          "causal": causal, "ms_turns": turns,
          "flash_fwd_ms_train_shape": float(np.mean(turns["flash_fwd"])),
          "flash_fwd_bound_ms_train_shape": fwd_bound,
          "flash_bwd_ms_train_shape": out["flash_bwd_dkdv"]["ms"]
                                      + out["flash_bwd_dq"]["ms"],
          "library_ms": library_ms, "tflops": tflops,
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
    """K5 over every bucket of the base config's plan (one optimizer step,
    one launch through adam_fp32_buckets, the entry fused_apply uses),
    against the plain `_adam_math` over the same buckets,
    torch.optim.AdamW(fused=True) over the same parameters (timed only,
    never used by the port), and K5 launched once per bucket through the
    one-bucket entry, in turns. First, two steps of K5 over every bucket
    are held against `_adam_math` bit for bit: the plan's large buckets
    (up to 33.5M elements) span every block of the grid. Returns (the
    timings, the buckets checked)."""
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
        ok_mod.adam_fp32_buckets(state.p, g_bufs, state.m, state.v, lr, c1,
                                 c2, **hyper)

    def per_bucket_step():
        for i in range(plan.n_buckets):
            ok_mod.adam_fp32(state.p[i], g_bufs[i], state.m[i], state.v[i],
                             lr, c1, c2, **hyper)

    scalars = [ok_mod._scalar(x, state.p[0]) for x in (lr, c1, c2)]

    kern = [[t.clone() for t in ts] for ts in (state.p, state.m, state.v)]
    plain = [[t.clone() for t in ts] for ts in (state.p, state.m, state.v)]
    for step in range(2):
        s_lr, s_c1, s_c2 = tx.scalars(step)
        s_dev = [ok_mod._scalar(x, state.p[0]) for x in (s_lr, s_c1, s_c2)]
        ok_mod.adam_fp32_buckets(kern[0], g_bufs, kern[1], kern[2], s_lr,
                                 s_c1, s_c2, **hyper)
        for i in range(plan.n_buckets):
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
    turns: dict[str, list[float]] = {"kernel": [], "library": [],
                                     "per_bucket": []}
    for _ in range(3):
        for key, fn in (("kernel", kernel_step), ("library", lib.step),
                        ("per_bucket", per_bucket_step)):
            ms, host_bound = time_ms_queued(fn, iters=10)
            if host_bound:
                fail(f"adam_fp32 ({key}): the host could not queue the "
                     "timed launches ahead of the card")
            turns[key].append(ms)
    host_paced_ms = time_ms(kernel_step, iters=10)
    plain_ms = time_ms(plain_step, iters=3, warmup=1)
    padded = plan.padded_elems()
    bound_ms = 28 * padded / PEAK_BYTES_S * 1e3
    out = {"ms": float(np.mean(turns["kernel"])), "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "library_ms": float(np.mean(turns["library"])),
           "per_bucket_launches_ms": float(np.mean(turns["per_bucket"]))}
    emit({"phase": "timing", "kernel": "adam_fp32", "buckets": plan.n_buckets,
          "padded_elems": padded, "per": "optimizer step (all buckets)",
          "launches_per_step": -(-plan.n_buckets // ok_mod.ADAM_TABLE_MAX),
          "ms_turns": turns["kernel"], "library_ms_turns": turns["library"],
          "per_bucket_launches_ms_turns": turns["per_bucket"],
          "timing": "device: launches queued behind a sleep kernel",
          "ms_host_paced": host_paced_ms,
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


def event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def run_probed(module, main_fn, argv: list, counters: dict) -> dict:
    """``main_fn(argv)`` with ``module.make_train_step`` and
    TrainState.apply_gradients wrapped for the run: each step is timed on
    the host clock between two synchronizes, its forward (the loss
    function), backward and optimizer with CUDA events; ``counters``
    ({name: wrapper}) are set to 0 just before the run and read around
    every step and just after. Returns the steps, the last state, the
    first batch, what main printed, its code, wall time and peak memory."""
    import contextlib
    import io

    from edl_tpu_torch.train import state as state_lib

    steps: list[dict] = []
    ev: dict = {}
    seen: dict = {}
    make_step = module.make_train_step
    apply_gradients = state_lib.TrainState.apply_gradients
    names = list(counters)

    def timed_make(loss_fn, **kw):
        def timed_loss(*args):
            ev["fwd0"] = event()
            out = loss_fn(*args)
            ev["fwd1"] = event()
            return out

        step = make_step(timed_loss, **kw)

        def timed_step(state, batch):
            if "batch" not in seen:
                seen["batch"] = {k: v.clone() for k, v in batch.items()}
            torch.cuda.synchronize()
            c0 = [counters[n].launches for n in names]
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps.append({"ms": (t1 - t0) * 1e3, "events": dict(ev),
                          "launches": {n: counters[n].launches - c
                                       for n, c in zip(names, c0)},
                          "loss": float(metrics["loss"])})
            seen["state"] = state
            return state, metrics
        return timed_step

    def timed_apply(self):
        ev["opt0"] = event()
        out = apply_gradients(self)
        ev["opt1"] = event()
        return out

    printed = io.StringIO()
    module.make_train_step = timed_make
    state_lib.TrainState.apply_gradients = timed_apply
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(printed):
            rc = main_fn(argv)
        wall_s = time.monotonic() - t0
        launches = {n: c.launches for n, c in counters.items()}
    finally:
        module.make_train_step = make_step
        state_lib.TrainState.apply_gradients = apply_gradients
    out = printed.getvalue()
    print(out, end="", flush=True)
    return {"rc": rc, "printed": out, "steps": steps, "seen": seen,
            "launches": launches, "wall_s": wall_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def step_summary(steps: list[dict]) -> dict:
    """Median and range of the timed steps' host ms, and the median
    forward / backward / optimizer split by CUDA events."""
    timed = steps[TIMED_FROM_STEP - 1:]
    ms = [st["ms"] for st in timed]

    def span(a, b):
        return float(np.median([st["events"][a].elapsed_time(
            st["events"][b]) for st in timed]))

    return {"step_ms_median": float(np.median(ms)), "step_ms_min": min(ms),
            "step_ms_max": max(ms),
            "timed_steps": f"{TIMED_FROM_STEP}-{len(steps)}",
            "breakdown_ms_median": {"forward": span("fwd0", "fwd1"),
                                    "backward": span("fwd1", "opt0"),
                                    "optimizer": span("opt0", "opt1")}}


def check_launches(steps: list[dict], want: dict, what: str) -> None:
    for i, st in enumerate(steps):
        if st["launches"] != want:
            fail(f"{what} step {i + 1} launched {st['launches']}, want "
                 f"{want}")


def phase_train(fa, ok_mod) -> dict:
    """The port's lm_train.main on the card at the base config (fp32
    fused Adam, K5). Then one step of flash against dense attention on
    the trained weights and the first batch. Returns the launches and
    the losses."""
    from dataclasses import replace as dc_replace
    import tempfile

    from edl_tpu_torch.examples import lm_train
    from edl_tpu_torch.models import transformer as tr
    from edl_tpu_torch.models.transformer import Transformer, lm_loss_fn
    from edl_tpu_torch.train.fused_opt import opt_state_bytes

    counters = {"flash_fwd": fa.flash_attention_lse,
                "flash_bwd_dkdv": fa.flash_bwd_dkdv,
                "flash_bwd_dq": fa.flash_bwd_dq, "adam_fp32": ok_mod.adam_fp32,
                "adam_q": ok_mod.adam_q}
    with tempfile.TemporaryDirectory() as data_dir:
        run = run_probed(lm_train, lm_train.main,
                         ["--data-dir", data_dir, *TRAIN_ARGV], counters)
    steps, seen, launches = run["steps"], run["seen"], run["launches"]
    printed, rc = run["printed"], run["rc"]
    final = [ln for ln in printed.splitlines()
             if ln.startswith("final_eval_loss=")]
    if rc != 0 or not final:
        fail(f"lm_train.main returned {rc} and printed {printed!r}")
    final_eval_loss = float(final[-1].split("=", 1)[1])

    state = seen["state"]
    n_buckets = len(state.opt_state.p)
    # one K5 launch a step over every bucket (per ADAM_TABLE_MAX of them)
    want = {"flash_fwd": 8, "flash_bwd_dkdv": 8, "flash_bwd_dq": 8,
            "adam_fp32": -(-n_buckets // ok_mod.ADAM_TABLE_MAX),
            "adam_q": 0}
    check_launches(steps, want, "lm_train")
    losses = [st["loss"] for st in steps]
    summary = step_summary(steps)
    cfg = state.model.cfg
    b, s = 16, cfg.max_len
    result = {"phase": "train", "argv": TRAIN_ARGV, "steps": len(steps),
              "params": sum(p.numel() for p in state.model.parameters()),
              "buckets": n_buckets, "wall_s": run["wall_s"], **summary,
              "tokens_per_s": b * s / (summary["step_ms_median"] / 1e3),
              "loss_first": losses[0], "loss_last": losses[-1],
              "losses": losses, "final_eval_loss": final_eval_loss,
              "peak_gib": run["peak_gib"],
              "opt_state_bytes": opt_state_bytes(state.opt_state),
              "launches_per_step": want, "launches": launches}
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
    return {k: v for k, v in launches.items() if v}, result


# -- momentum-SGD (K4), quantized momentum-SGD (K6), quantized Adam (K7) ---

# (counter name, optimizer, quant) of every case held against its plain
# version; K5 (adam, off) has its own phase above
OPT_KINDS = (("sgdm_fp32", "sgdm", "off"), ("sgdm_q", "sgdm", "int8"),
             ("sgdm_q", "sgdm", "fp8"), ("adam_q", "adam", "int8"),
             ("adam_q", "adam", "fp8"))
# (label, payload, padded): a 4 MiB bucket, a ragged one whose padding
# must stay zero, an all-zero one (scales 1.0), and one whose abs-max is a
# single pinned element (x / scale lands on the codec's edge, 127 or 448)
OPT_BUCKETS = (("4MiB", 1 << 20, 1 << 20), ("ragged", 127_539, 127_616),
               ("zero", 0, 4096), ("pinned_amax", 65_536, 65_536))
# bytes an element each kernel must move: K4 p, g, m read and p, m
# written; K6 p, g read, p written, q, rq read and written; K7 the same
# with four int8 planes
OPT_BOUND_BYTES = {"sgdm_fp32": 20, "sgdm_q": 16, "adam_q": 20}


def opt_bucket(gen, label: str, payload: int, padded: int,
               std: float) -> torch.Tensor:
    """One of OPT_BUCKETS on the card: ``payload`` random elements of
    ``std`` then zero padding; the pinned one's abs-max is one element."""
    x = torch.zeros(padded, device="cuda")
    if payload:
        x[:payload] = torch.randn(payload, generator=gen,
                                  device="cuda") * std
    if label == "pinned_amax":
        x[payload // 3] = -40 * std
    return x


def opt_moments(ok_mod, opt: str, quant: str, p: torch.Tensor) -> list:
    def zero():
        if quant == "off":
            return torch.zeros_like(p)
        return ok_mod.zero_plane(p.numel(), quant, device=p.device)
    return [zero()] if opt == "sgdm" else [zero(), zero()]


def opt_step(ok_mod, opt: str, quant: str, p, g, moments, scalars,
             wd: float, plain: bool) -> None:
    """One bucket step: the kernel (through the bucket function), or the
    plain version on the same device."""
    lr, c1, c2 = scalars
    if opt == "sgdm":
        if plain:
            ok_mod._sgdm_plain(p, g, moments[0], lr, 0.9, wd, quant)
        else:
            ok_mod.sgdm_bucket(p, g, moments[0], lr, mu=0.9, wd=wd,
                               quant=quant)
    elif plain:
        ok_mod._adam_plain(p, g, *moments, lr, c1, c2, 0.9, 0.999, 1e-8,
                           wd, quant)
    else:
        ok_mod.adam_bucket(p, g, *moments, lr, c1, c2, b1=0.9, b2=0.999,
                           eps=1e-8, wd=wd, quant=quant)


def plan_step(ok_mod, opt: str, quant: str, p_bufs, g_bufs, moments,
              scalars, wd: float, plain: bool) -> None:
    """One step over every bucket of a plan through the entry fused_apply
    uses: one K4 or K5 launch over all the buckets, K6's or K7's entry
    over all of them; or the plain version bucket by bucket."""
    if not plain:
        lr, c1, c2 = scalars
        ms = [m[0] for m in moments]
        if opt == "sgdm" and quant == "off":
            ok_mod.sgdm_fp32_buckets(p_bufs, g_bufs, ms, lr, mu=0.9, wd=wd)
            return
        if opt == "sgdm":
            ok_mod.sgdm_q_buckets(p_bufs, g_bufs, ms, lr, mu=0.9, wd=wd,
                                  quant=quant)
            return
        vs = [m[1] for m in moments]
        hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=wd)
        if quant == "off":
            ok_mod.adam_fp32_buckets(p_bufs, g_bufs, ms, vs, lr, c1, c2,
                                     **hyper)
        else:
            ok_mod.adam_q_buckets(p_bufs, g_bufs, ms, vs, lr, c1, c2,
                                  quant=quant, **hyper)
        return
    for p, g, m in zip(p_bufs, g_bufs, moments):
        opt_step(ok_mod, opt, quant, p, g, m, scalars, wd, plain)


def opt_tensors(p, moments) -> list:
    out = [p]
    for m in moments:
        out.extend(m if isinstance(m, tuple) else (m,))   # a QPlane
    return out


def phase_kernels_opt(ok_mod, fo, gen) -> dict:
    """K4, K6 and K7 against their plain versions on the card, bit for
    bit (p, the fp32 moment or both QPlanes' payloads and scales) over 3
    steps of each of OPT_BUCKETS, with wd 0 and 1e-4. Returns {name:
    (0.0, checks)}: any difference fails."""
    txs = {"sgdm": fo.fused_sgd(lambda step: 0.1 * (step + 1) / 3),
           "adam": fo.fused_adam(lambda step: 3e-4 * (step + 1) / 3)}
    checks = {name: 0 for name, _, _ in OPT_KINDS}
    for label, payload, padded in OPT_BUCKETS:
        p0 = opt_bucket(gen, label, payload, padded, 0.1)
        grads = [opt_bucket(gen, label, payload, padded, 0.02)
                 for _ in range(3)]
        for name, opt, quant in OPT_KINDS:
            for wd in (0.0, 1e-4):
                kern = (p0.clone(), opt_moments(ok_mod, opt, quant, p0))
                plain = (p0.clone(), opt_moments(ok_mod, opt, quant, p0))
                for step, g in enumerate(grads):
                    scalars = txs[opt].scalars(step)
                    for side, is_plain in ((kern, False), (plain, True)):
                        opt_step(ok_mod, opt, quant, side[0], g, side[1],
                                 scalars, wd, is_plain)
                    torch.cuda.synchronize()
                    a, b = opt_tensors(*kern), opt_tensors(*plain)
                    bitwise = all(fo.bitwise_equal(x, y)
                                  for x, y in zip(a, b))
                    pad_zero = all(not t[payload:].any().item()
                                   for t in a if t.dim() == 1)
                    err = (kern[0] - plain[0]).abs().max().item()
                    scales = [t.item() for t in a if t.dim() == 0]
                    emit({"phase": "kernels", "kernel": name, "quant": quant,
                          "bucket": label, "size": [payload, padded],
                          "wd": wd, "step": step, "bitwise": bitwise,
                          "padding_zero": pad_zero, "p_max_abs_err": err,
                          "scales": scales, "ok": bitwise and pad_zero})
                    if not (bitwise and pad_zero):
                        fail(f"{name} ({quant}) differs from its plain "
                             f"version on the {label} bucket, wd {wd}, "
                             f"step {step}: p err {err}, padding zero "
                             f"{pad_zero}")
                    checks[name] += 1
    return {name: (0.0, n) for name, n in checks.items()}


# K5, K6 and K7 in one table call over mixed buckets: (name, opt, quant)
TABLE_ORDER = ("ragged", "4MiB", "zero", "pinned_amax")
TABLE_CASES = (("adam_fp32", "adam", "off"), ("sgdm_q", "sgdm", "int8"),
               ("sgdm_q", "sgdm", "fp8"), ("adam_q", "adam", "int8"),
               ("adam_q", "adam", "fp8"))


def clone_side(side: list) -> list:
    """A copy of [(p, moments)] for every bucket (QPlanes included)."""
    return [(p.clone(), [type(m)(*(t.clone() for t in m))
                         if isinstance(m, tuple) else m.clone()
                         for m in moments]) for p, moments in side]


def phase_kernels_tables(ok_mod, fo, gen) -> dict:
    """K5, K6 and K7 (K6 and K7 with int8 and fp8 moments) in one table
    over OPT_BUCKETS' ragged, 4 MiB, all-zero and pinned-abs-max buckets,
    through the entries fused_apply uses: 3 steps with wd 0 and 1e-4 bit
    for bit against the plain version bucket by bucket, and each step
    repeated from the same state in a second launch, bit for bit against
    the first. The 4 MiB bucket's 1,024 chunks span the grid: K6's and
    K7's new scales must wait for every block of their last pass. Returns
    {name: (0.0, checks)}: any difference fails."""
    txs = {"sgdm": fo.fused_sgd(lambda step: 0.1 * (step + 1) / 3),
           "adam": fo.fused_adam(lambda step: 3e-4 * (step + 1) / 3)}
    spec = {label: (payload, padded) for label, payload, padded in OPT_BUCKETS}
    p0 = [opt_bucket(gen, lb, *spec[lb], 0.1) for lb in TABLE_ORDER]
    grads = [[opt_bucket(gen, lb, *spec[lb], 0.02) for lb in TABLE_ORDER]
             for _ in range(3)]
    checks = {name: 0 for name, _, _ in TABLE_CASES}
    for name, opt, quant in TABLE_CASES:
        for wd in (0.0, 1e-4):
            kern = [(p.clone(), opt_moments(ok_mod, opt, quant, p))
                    for p in p0]
            plain = clone_side(kern)
            for step, g in enumerate(grads):
                scalars = txs[opt].scalars(step)
                again = clone_side(kern)
                for side, is_plain in ((kern, False), (plain, True),
                                       (again, False)):
                    plan_step(ok_mod, opt, quant, [p for p, _ in side], g,
                              [m for _, m in side], scalars, wd, is_plain)
                torch.cuda.synchronize()

                def same(a, b):
                    return all(fo.bitwise_equal(x, y)
                               for u, w in zip(a, b)
                               for x, y in zip(opt_tensors(*u),
                                               opt_tensors(*w)))

                bitwise, repeat = same(kern, plain), same(kern, again)
                pad_zero = all(not t[spec[lb][0]:].any().item()
                               for lb, side in zip(TABLE_ORDER, kern)
                               for t in opt_tensors(*side) if t.dim() == 1)
                emit({"phase": "kernels", "kernel": name, "quant": quant,
                      "table": list(TABLE_ORDER), "wd": wd,
                      "step": step, "bitwise": bitwise,
                      "bitwise_repeat": repeat, "padding_zero": pad_zero,
                      "ok": bitwise and repeat and pad_zero})
                if not (bitwise and repeat and pad_zero):
                    fail(f"{name} ({quant}) over the mixed table, "
                         f"wd {wd}, step {step}: bit for bit {bitwise}, "
                         f"repeat {repeat}, padding zero {pad_zero}")
                checks[name] += 1
    return {name: (0.0, n) for name, n in checks.items()}


def plan_world(ok_mod, fo, model, tx, gen):
    """The fused optimizer's plan over ``model``'s parameters (flax
    flatten order), its parameter buckets and one step of random
    gradients packed into buckets."""
    from edl_tpu_torch.bridge import flax_named_parameters

    named = flax_named_parameters(model)
    plan = tx.plan(named)
    state = tx.init(named)
    for _, prm in named:
        prm.grad = torch.randn(prm.shape, generator=gen,
                               device="cuda") * 1e-3
    g_bufs = fo._grad_buckets(plan, [x for _, x in named],
                              [x.grad for _, x in named])
    return named, plan, state, g_bufs


def plan_bitwise(ok_mod, fo, name, opt, quant, tx, p_bufs, g_bufs,
                 wd) -> int:
    """2 steps of the kernel over every bucket of a plan (`plan_step`)
    against the plain version, bit for bit, each step also repeated from
    the same state in a second launch, bit for bit against the first.
    Returns the buckets checked."""
    kern = [(p.clone(), opt_moments(ok_mod, opt, quant, p)) for p in p_bufs]
    plain = [(p.clone(), opt_moments(ok_mod, opt, quant, p))
             for p in p_bufs]

    def differ(a, b):
        return [i for i in range(len(p_bufs))
                if not all(fo.bitwise_equal(x, y) for x, y in
                           zip(opt_tensors(*a[i]), opt_tensors(*b[i])))]

    repeat_differ = []
    for step in range(2):
        scalars = tx.scalars(step)
        again = clone_side(kern)
        for side, is_plain in ((kern, False), (plain, True), (again, False)):
            plan_step(ok_mod, opt, quant, [p for p, _ in side], g_bufs,
                      [m for _, m in side], scalars, wd, is_plain)
        torch.cuda.synchronize()
        repeat_differ += differ(kern, again)
        del again
    plain_differ = differ(kern, plain)
    emit({"phase": "kernels", "kernel": name, "quant": quant,
          "plan_buckets": len(p_bufs),
          "largest_bucket": max(p.numel() for p in p_bufs), "steps": 2,
          "bitwise": not plain_differ, "buckets_differing": plain_differ,
          "bitwise_repeat": not repeat_differ,
          "buckets_differing_repeat": repeat_differ})
    if plain_differ or repeat_differ:
        fail(f"{name} ({quant}) differs from its plain version on buckets "
             f"{plain_differ} of the plan, or from a second launch on "
             f"{repeat_differ}")
    del kern, plain
    torch.cuda.empty_cache()
    return len(p_bufs)


def time_plan(ok_mod, name, opt, quant, tx, p_bufs, g_bufs, wd,
              library=None) -> dict:
    """One optimizer step over every bucket of a plan (`plan_step`, as
    fused_apply runs it): the kernel and the library call in turns (3
    turns of up to 10 steps), the plain version over 3 steps, and the
    bound from the bytes the kernel must move."""
    moments = [opt_moments(ok_mod, opt, quant, p) for p in p_bufs]
    scalars = tx.scalars(0)

    def step(plain):
        plan_step(ok_mod, opt, quant, p_bufs, g_bufs, moments, scalars, wd,
                  plain)

    turns: dict[str, list[float]] = {"kernel": [], "library": []}
    host_bound = False
    # stream entries of one step: one K4 launch; a memset and three passes
    # for K6 and K7 (per table of buckets)
    if quant == "off":
        entries = 1
    else:
        entries = 4 * -(-len(p_bufs) // (ok_mod.ADAM_Q_TABLE_MAX
                                          if opt == "adam"
                                          else ok_mod.SGDM_Q_TABLE_MAX))
    iters = max(2, min(10, 800 // entries))
    for _ in range(3):
        ms, hb = time_ms_queued(lambda: step(False), iters=iters)
        turns["kernel"].append(ms)
        host_bound |= hb
        if library is not None:
            ms, hb = time_ms_queued(library, iters=10)
            turns["library"].append(ms)
            host_bound |= hb
    host_paced_ms = time_ms(lambda: step(False), iters=10)
    plain_ms = time_ms(lambda: step(True), iters=3, warmup=1)
    padded = sum(p.numel() for p in p_bufs)
    out = {"ms": float(np.mean(turns["kernel"])), "plain_ms": plain_ms,
           "bound_ms": OPT_BOUND_BYTES[name] * padded / PEAK_BYTES_S * 1e3,
           "bound_by": "bytes",
           "library_ms": (float(np.mean(turns["library"]))
                          if library is not None else None)}
    emit({"phase": "timing", "kernel": name, "quant": quant,
          "buckets": len(p_bufs), "padded_elems": padded,
          "per": "optimizer step (all buckets)",
          "ms_turns": turns["kernel"], "library_ms_turns": turns["library"],
          "timing": "device: launches queued behind a sleep kernel",
          "stream_entries": entries, "queued_steps": iters,
          "host_bound": host_bound, "ms_host_paced": host_paced_ms, **out})
    if host_bound:
        fail(f"{name}: the host could not queue the timed launches ahead "
             "of the card")
    return out


# bytes an element each K6 pass moves at wd != 0 (A, B: p, g and the two
# planes read; C: p, g read, p written, the planes read and written)
K6_PASS_BYTES = {"A": 10, "B": 10, "C": 16}


def ptxas_of(log: str, prefix: str) -> dict:
    """Registers and spills (ptxas) of the kernels named ``prefix<...>``
    in a library's build log."""
    return {n: k for n, k in ptxas_kernels(log).items()
            if n.startswith(prefix)}


def time_passes(run_pass, passes: dict, bytes_per_elem: dict,
                elems: int) -> dict:
    """Device ms of each pass alone (``passes``: name -> the arguments of
    ``run_pass``, which runs one pass over the plan) beside its bytes'
    bound, queued behind a sleep kernel (10 calls, the mean of 3 turns).
    Fails if the host fell behind."""
    out: dict = {"passes_ms": {}, "passes_bound_ms": {}}
    host_bound = {}
    for _ in range(3):
        for key, args in passes.items():
            ms, host_bound[key] = time_ms_queued(lambda: run_pass(*args),
                                                 iters=10)
            out["passes_ms"].setdefault(key, []).append(ms)
    out["passes_ms"] = {k: float(np.mean(v))
                        for k, v in out["passes_ms"].items()}
    out["passes_bound_ms"] = {k: b * elems / PEAK_BYTES_S * 1e3
                              for k, b in bytes_per_elem.items()}
    if any(host_bound.values()):
        fail(f"the host could not queue the timed passes ahead of the "
             f"card: {host_bound}")
    return out


def phase_timing_sgdm(ok_mod, fo, gen, sgdm_log: str) -> tuple[dict, dict]:
    """K4 and K6 over every bucket of ResNet50_vd's plan: 2 steps bit for
    bit against the plain version (K4, K6 int8 and fp8, each step repeated
    in a second launch), then one step's time (K4; K6 int8, imagenet_train's
    quantized path), K4 beside torch.optim.SGD(momentum=0.9,
    weight_decay=1e-4, fused=True) (timed only, never used by the port);
    each of K6's passes alone beside its bytes' bound, and K6's registers
    and spills (ptxas). Returns (timings, checks)."""
    from edl_tpu_torch.models.resnet import ResNet50_vd

    model = ResNet50_vd(num_classes=1000, dtype=torch.bfloat16,
                        device="cuda", seed=0)
    tx = fo.fused_sgd(0.1, 0.9, 1e-4)
    named, plan, state, g_bufs = plan_world(ok_mod, fo, model, tx, gen)
    checks = {"sgdm_fp32": plan_bitwise(ok_mod, fo, "sgdm_fp32", "sgdm",
                                        "off", tx, state.p, g_bufs, 1e-4)}
    checks["sgdm_q"] = sum(plan_bitwise(ok_mod, fo, "sgdm_q", "sgdm", q, tx,
                                        state.p, g_bufs, 1e-4)
                           for q in ("int8", "fp8"))
    lib = torch.optim.SGD([x for _, x in named], lr=0.1, momentum=0.9,
                          weight_decay=1e-4, fused=True)
    timing = {"sgdm_fp32": time_plan(ok_mod, "sgdm_fp32", "sgdm", "off", tx,
                                     state.p, g_bufs, 1e-4, lib.step),
              "sgdm_q": time_plan(ok_mod, "sgdm_q", "sgdm", "int8", tx,
                                  state.p, g_bufs, 1e-4)}
    planes = [ok_mod.zero_plane(p.numel(), "int8", device="cuda")
              for p in state.p]
    # one full step first: the passes alone then read its words
    ok_mod.sgdm_q_buckets(state.p, g_bufs, planes, 0.1, mu=0.9, wd=1e-4,
                          quant="int8")
    passes = time_passes(
        lambda which: ok_mod.sgdm_q_pass(
            state.p, g_bufs, planes, 0.1, mu=0.9, wd=1e-4, quant="int8",
            which=which),
        {key: (which,) for which, key in enumerate(K6_PASS_BYTES)},
        K6_PASS_BYTES, plan.padded_elems())
    ptxas = ptxas_of(sgdm_log, "sgdm_q_kernel")
    emit({"phase": "timing", "kernel": "sgdm_q", "quant": "int8",
          "buckets": plan.n_buckets, "padded_elems": plan.padded_elems(),
          "ms": timing["sgdm_q"]["ms"],
          "bound_ms": timing["sgdm_q"]["bound_ms"], **passes,
          "timing": "device: launches queued behind a sleep kernel",
          "ptxas": ptxas})
    timing["sgdm_q"]["passes_ms"] = passes["passes_ms"]
    emit({"phase": "timing", "plan": "ResNet50_vd", "params": sum(
        x.numel() for _, x in named), "buckets": plan.n_buckets,
        "library": "torch.optim.SGD(momentum=0.9, weight_decay=1e-4, "
                   "fused=True)"})
    del lib, state, model, named, g_bufs, planes
    torch.cuda.empty_cache()
    return timing, checks


# bytes an element each K7 pass moves (A, B: g and four planes read; C:
# p, g read, p written, four planes read and written)
K7_PASS_BYTES = {"A": 8, "B": 8, "C": 20, "C_loads_only": 20}


def phase_timing_adam_q(ok_mod, fo, gen) -> tuple[dict, int]:
    """K7 over every bucket of the base LM config's plan: 2 steps bit for
    bit against the plain version (int8 and fp8 m), then one step's time
    (int8, lm_train's quantized path), and each pass alone (A, B, C, and
    C with its loads and stores alone) beside its bytes' bound. No PyTorch
    call computes a quantized-moment Adam: library_ms is null. Returns
    (timing, checks)."""
    from edl_tpu_torch.models.transformer import Transformer

    model = Transformer(base_config(), device="cuda", seed=0)
    tx = fo.fused_adam(3e-4, weight_decay=0.01)
    named, plan, state, g_bufs = plan_world(ok_mod, fo, model, tx, gen)
    checks = sum(plan_bitwise(ok_mod, fo, "adam_q", "adam", q, tx, state.p,
                              g_bufs, 0.01) for q in ("int8", "fp8"))
    timing = time_plan(ok_mod, "adam_q", "adam", "int8", tx, state.p,
                       g_bufs, 0.01)
    p_bufs = state.p
    ms = [ok_mod.zero_plane(p.numel(), "int8", device="cuda") for p in p_bufs]
    vs = [ok_mod.zero_plane(p.numel(), ok_mod.V_QUANT, device="cuda")
          for p in p_bufs]
    lr, c1, c2 = tx.scalars(0)
    hyper = dict(b1=tx.b1, b2=tx.b2, eps=tx.eps, wd=0.01, quant="int8")
    # one full step first: the passes alone then read its words
    ok_mod.adam_q_buckets(p_bufs, g_bufs, ms, vs, lr, c1, c2, **hyper)
    padded = sum(p.numel() for p in p_bufs)
    passes = time_passes(
        lambda which: ok_mod.adam_q_pass(p_bufs, g_bufs, ms, vs, lr, c1, c2,
                                         which=which, **hyper),
        {key: (which,) for which, key in enumerate(K7_PASS_BYTES)},
        K7_PASS_BYTES, padded)
    emit({"phase": "timing", "kernel": "adam_q", "quant": "int8",
          "buckets": len(p_bufs), "padded_elems": padded, **passes,
          "timing": "device: launches queued behind a sleep kernel"})
    timing["passes_ms"] = passes["passes_ms"]
    del state, model, named, g_bufs, ms, vs
    torch.cuda.empty_cache()
    return timing, checks


# The quantized run of a path ends within this relative envelope of its
# fp32 run (the JAX package's convergence_smoke bar):
# |loss_fp32 - loss_quant| <= ENVELOPE * (loss at step 1 - loss_fp32),
# with at least STATE_CUT x fewer optimizer-state bytes.
ENVELOPE = 0.25
STATE_CUT = 1.8


def envelope_check(what: str, fp32: dict, quant: dict) -> dict:
    improvement = fp32["losses"][0] - fp32["loss_last"]
    delta = abs(fp32["loss_last"] - quant["loss_last"])
    cut = fp32["opt_state_bytes"] / quant["opt_state_bytes"]
    out = {"phase": f"{what}_quant_vs_fp32", "loss_step1": fp32["losses"][0],
           "loss_fp32": fp32["loss_last"], "loss_quant": quant["loss_last"],
           "delta": delta, "improvement": improvement,
           "delta_rel": delta / improvement if improvement > 0 else None,
           "envelope": ENVELOPE, "opt_state_bytes_fp32":
           fp32["opt_state_bytes"],
           "opt_state_bytes_quant": quant["opt_state_bytes"],
           "state_cut": cut, "state_cut_min": STATE_CUT}
    emit(out)
    if not (improvement > 0 and delta <= ENVELOPE * improvement):
        fail(f"{what}: the quantized run ends at {quant['loss_last']}, "
             f"{delta} from fp32's {fp32['loss_last']}, outside "
             f"{ENVELOPE} x the improvement {improvement}")
    if cut < STATE_CUT:
        fail(f"{what}: optimizer state cut {cut} < {STATE_CUT}")
    return out


def phase_train_int8(fa, ok_mod, fp32: dict) -> dict:
    """lm_train with the train phase's argv but --fused-opt int8: exactly
    8 K1, 8 K2, 8 K3 and one K7 entry call (a memset and three passes over
    every bucket) each step; the loss finite and falling and within the
    envelope of the train phase's fp32 run."""
    import tempfile

    from edl_tpu_torch.examples import lm_train
    from edl_tpu_torch.train.fused_opt import opt_state_bytes

    argv = [("int8" if a == "fp32" else a) for a in TRAIN_ARGV]
    counters = {"flash_fwd": fa.flash_attention_lse,
                "flash_bwd_dkdv": fa.flash_bwd_dkdv,
                "flash_bwd_dq": fa.flash_bwd_dq, "adam_fp32": ok_mod.adam_fp32,
                "adam_q": ok_mod.adam_q}
    with tempfile.TemporaryDirectory() as data_dir:
        run = run_probed(lm_train, lm_train.main,
                         ["--data-dir", data_dir, *argv], counters)
    if run["rc"] != 0 or "final_eval_loss=" not in run["printed"]:
        fail(f"lm_train.main --fused-opt int8 returned {run['rc']}")
    state = run["seen"]["state"]
    n_buckets = len(state.opt_state.p)
    # one K7 entry call a step over every bucket (per ADAM_Q_TABLE_MAX)
    want = {"flash_fwd": 8, "flash_bwd_dkdv": 8, "flash_bwd_dq": 8,
            "adam_fp32": 0,
            "adam_q": -(-n_buckets // ok_mod.ADAM_Q_TABLE_MAX)}
    check_launches(run["steps"], want, "lm_train --fused-opt int8")
    losses = [st["loss"] for st in run["steps"]]
    summary = step_summary(run["steps"])
    result = {"phase": "train_int8", "argv": argv, "steps": len(losses),
              "buckets": n_buckets, "wall_s": run["wall_s"], **summary,
              "tokens_per_s": 16 * 1024 / (summary["step_ms_median"] / 1e3),
              "loss_first": losses[0], "loss_last": losses[-1],
              "losses": losses, "peak_gib": run["peak_gib"],
              "opt_state_bytes": opt_state_bytes(state.opt_state),
              "launches_per_step": want, "launches": run["launches"]}
    emit(result)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"lm_train int8: losses {losses} not finite and falling")
    envelope_check("train_int8", fp32, result)
    del state, run
    torch.cuda.empty_cache()
    return {k: v for k, v in result["launches"].items() if v}


# imagenet_train at bench.py's ResNet config (bench.py:75-76): ResNet50_vd,
# bf16 activations, 224 px, 1000 classes, 128 images a step, momentum-SGD
# (lr 0.1, warmup 1 epoch), no augmentation, on 5 synthetic shards of 256
# rows (1,280 rows: 10 steps an epoch), 3 epochs. 1,280 images of 1,000
# classes are first memorized: the loader reshuffles each epoch, so a
# step late in an epoch holds images seen longer ago than one early in
# it, and the per-step loss climbs within each epoch at lr 0.1 (step 11
# 6.62, step 20 7.10, above step 1's 7.00) while the epoch means fall.
# The same run with fp32 activations follows that climb within 0.0064,
# so it is not bf16's (RESNET_BF16_ATOL below checks it every run). In a
# third epoch every step stays below step 1: the check is that, and the
# epoch means falling.
RESNET_ARGV = ["--model", "ResNet50_vd", "--bf16", "--image-size", "224",
               "--num-classes", "1000", "--batch-size", "128", "--no-augment",
               "--warmup-epochs", "1", "--epochs", "3",
               "--rows-per-file", "256"]
RESNET_SHARDS = 5
RESNET_STEPS_PER_EPOCH = 10
PROFILED_STEPS = 3
# per-step losses of the bf16 run against the same run with fp32
# activations: a tenth of the climb within an epoch (measured 0.0064 over
# 30 steps, H100 80GB HBM3 at 700 W)
RESNET_BF16_ATOL = 0.05


def profile_steps(classification, state, batch) -> dict:
    """PROFILED_STEPS more steps of imagenet_train's step (its default
    label smoothing) on the run's trained state and first batch, first
    timed on the host clock, then under torch.profiler: the device time a
    step takes (one stream, so kernels do not overlap), its idle share of
    the unprofiled step (the profiler slows the host, so the profiled wall
    time would overstate it), and the kernels that take the most device
    time. A device time above the step is no idle share: it is reported
    as null with the two numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = classification.make_classification_step(1000, smoothing=0.1)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILED_STEPS):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own rows (kernels, memsets, copies), not the host ops
    # that launched them
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / PROFILED_STEPS
    out = {"phase": "profile_resnet", "steps": PROFILED_STEPS,
           "wall_ms_per_step": wall_ms / PROFILED_STEPS,
           "device_busy_ms_per_step": busy_ms,
           "step_ms_unprofiled": step_ms,
           # None: no device time seen, or more than the step (not measured)
           "device_idle_share": (1 - busy_ms / step_ms
                                 if 0 < busy_ms <= step_ms else None),
           "top_kernels": [{"name": e.key[:120], "calls": e.count
                            // PROFILED_STEPS,
                            "ms_per_step": device_us(e) / 1e3
                            / PROFILED_STEPS}
                           for e in sorted(kernels, key=device_us,
                                           reverse=True)[:20]]}
    emit(out)
    return out


def resnet_want(counters: dict, kernel: str) -> dict:
    """The launches of a step of imagenet_train on one card: one call of
    ``kernel`` over every bucket (K4's launch, or K6's entry call) and no
    other counted launch."""
    return {n: int(n == kernel) for n in counters}


def resnet_run(imagenet_train, classification, opt_state_bytes,
               counters: dict, argv: list, name: str, kernel: str) -> dict:
    """One imagenet_train.main run at ``argv``: exactly one call of
    ``kernel`` a step over every bucket (K4, or K6's entry) and no other
    counted launch (``resnet_want``), the loss finite, the epoch means
    falling and no step of the last epoch above step 1's loss."""
    run = run_probed(classification, imagenet_train.main, argv, counters)
    if run["rc"] != 0 or "final_acc1=" not in run["printed"]:
        fail(f"imagenet_train {name} returned {run['rc']} and printed "
             f"{run['printed']!r}")
    blog_dir = argv[argv.index("--benchmark-log") + 1]
    with open(os.path.join(blog_dir, "log_0.json")) as f:
        final = json.load(f)["final"]
    state = run["seen"]["state"]
    n_buckets = len(state.opt_state.p)
    want = resnet_want(counters, kernel)
    check_launches(run["steps"], want, f"imagenet_train {name}")
    losses = [st["loss"] for st in run["steps"]]
    epochs = [float(np.mean(losses[i:i + RESNET_STEPS_PER_EPOCH]))
              for i in range(0, len(losses), RESNET_STEPS_PER_EPOCH)]
    summary = step_summary(run["steps"])
    result = {"phase": f"train_resnet_{name}", "argv": argv,
              "steps": len(losses),
              "params": sum(p.numel() for p in state.model.parameters()),
              "buckets": n_buckets, "wall_s": run["wall_s"], **summary,
              "images_per_s": 128 / (summary["step_ms_median"] / 1e3),
              "loader_examples_per_s_epoch": final["examples_per_sec"],
              "loss_first": losses[0], "loss_last": losses[-1],
              "epoch_mean_losses": epochs,
              "last_epoch_max": max(losses[-RESNET_STEPS_PER_EPOCH:]),
              "losses": losses, "eval_acc1": final["acc1"],
              "eval_acc5": final["acc5"], "peak_gib": run["peak_gib"],
              "opt_state_bytes": opt_state_bytes(state.opt_state),
              "launches_per_step": want, "launches": run["launches"]}
    emit(result)
    if not (all(np.isfinite(losses)) and len(epochs) >= 3
            and all(b < a for a, b in zip(epochs, epochs[1:]))
            and result["last_epoch_max"] < losses[0]):
        fail(f"imagenet_train {name}: losses {losses} not finite, the "
             f"epoch means {epochs} not falling, or a step of the last "
             "epoch not below step 1's")
    result["seen"] = run["seen"]
    return result


def phase_train_resnet(ok_mod) -> tuple[dict, dict]:
    """The port's imagenet_train.main at RESNET_ARGV with --fused-opt fp32
    (K4), then int8 (K6), then fp32 with fp32 activations, on the same
    shards from the same init: step time and images/s, the forward /
    backward / optimizer split, peak memory, exactly one K4 (or one K6
    entry call) each step, the loss finite and falling, eval acc1/acc5; the
    int8 run within the envelope of the fp32 run with at least STATE_CUT x
    fewer optimizer-state bytes; the bf16 run's per-step losses within
    RESNET_BF16_ATOL of the fp32-activation run's."""
    import tempfile

    from edl_tpu_torch.examples import imagenet_train
    from edl_tpu_torch.train import classification
    from edl_tpu_torch.train.fused_opt import opt_state_bytes

    counters = {"sgdm_fp32": ok_mod.sgdm_fp32, "sgdm_q": ok_mod.sgdm_q}
    fp32_activations = [a for a in RESNET_ARGV if a != "--bf16"]
    runs = {}
    with tempfile.TemporaryDirectory() as data_dir:
        for name, argv, mode, kernel in (
                ("fp32", RESNET_ARGV, "fp32", "sgdm_fp32"),
                ("int8", RESNET_ARGV, "int8", "sgdm_q"),
                ("fp32_activations", fp32_activations, "fp32",
                 "sgdm_fp32")):
            argv = ["--data-dir", data_dir, *argv, "--fused-opt", mode,
                    "--benchmark-log", os.path.join(data_dir, name)]
            if not runs:
                argv += ["--make-synthetic", str(RESNET_SHARDS)]
            run = resnet_run(imagenet_train, classification,
                             opt_state_bytes, counters, argv, name, kernel)
            seen = run.pop("seen")
            if name == "fp32":
                run["profile"] = profile_steps(
                    classification, seen["state"], seen["batch"])
            runs[name] = run
            del seen
            torch.cuda.empty_cache()
    envelope_check("train_resnet", runs["fp32"], runs["int8"])
    gap = float(np.max(np.abs(np.subtract(
        runs["fp32"]["losses"], runs["fp32_activations"]["losses"]))))
    emit({"phase": "train_resnet_bf16_vs_fp32_activations",
          "max_abs_loss_gap": gap, "atol": RESNET_BF16_ATOL})
    if not gap <= RESNET_BF16_ATOL:
        fail(f"ResNet bf16 run's losses {gap} from the fp32-activation "
             f"run's, above {RESNET_BF16_ATOL}")
    launches = {f"train_resnet_{m}": {k: v for k, v in r["launches"].items()
                                      if v} for m, r in runs.items()
                if m != "fp32_activations"}
    return launches, runs


# -- K8 (the int8 gradient pack) ---------------------------------------------

# K8 must move 5 B an element (the fp32 shard read once, its int8 payload
# written once); this design reads the shard twice: 9 B.
PACK_BOUND_BYTES = 5
PACK_DESIGN_BYTES = 9


def pack_grid(gen) -> dict[str, torch.Tensor]:
    """The CPU tests' shards (tests/test_torch_pack.py and
    tests/test_torch_pack_buckets.py: lengths 1 to 4099, all-zero, a
    pinned abs-max, exact half-steps, subnormals beside a normal abs-max
    and alone) and a 4 MiB shard, on the card."""
    rng = np.random.default_rng(0)
    grid = {f"len{n}": rng.normal(size=n) for n in (1, 127, 128, 200, 4099)}
    grid["len3"] = rng.normal(size=3)
    grid["zero"] = np.zeros(300)
    pinned = rng.normal(0, 0.1, size=1000)
    pinned[333] = -4.0
    grid["pinned_amax"] = pinned
    grid["half_steps_1"] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                            -125.5, 3.5]
    grid["half_steps_2"] = [-254.0, 1.0, 3.0, 5.0, -1.0, -3.0, 7.0, 251.0]
    grid["subnormals"] = [1e-40, -3e-39, 1e-45, 5e-39, 0.75, -1.0, 0.0]
    grid["all_subnormal"] = [1e-40, -3e-39, 2e-45, 5e-39]
    shards = {k: torch.tensor(np.asarray(v, np.float32), device="cuda")
              for k, v in grid.items()}
    shards["4MiB"] = torch.randn(1 << 20, generator=gen, device="cuda")
    return shards


def pack_same(a: tuple, b: tuple) -> bool:
    """Two packs' q and scale bits equal."""
    return (torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


def pack_bitwise(pack_mod, name: str, x: torch.Tensor) -> None:
    """K8 against its plain version on the same shard: q and the scale's
    bits equal, or the run fails."""
    q, scale = pack_mod.pack_int8(x)
    pq, pscale = pack_mod._pack_plain(x)
    torch.cuda.synchronize()
    bitwise = pack_same((q, scale), (pq, pscale))
    emit({"phase": "kernels", "kernel": "pack_int8", "shard": name,
          "elems": x.numel(), "scale": scale.item(), "bitwise": bitwise,
          "q_differing": int((q != pq).sum().item()), "ok": bitwise})
    if not bitwise:
        fail(f"pack_int8 differs from its plain version on {name}: scale "
             f"{scale.item()!r} vs {pscale.item()!r}")


def pack_table_bitwise(pack_mod, name: str, xs: list) -> None:
    """K8 once over a table of every shard of ``xs`` (pack_int8_buckets,
    one launch counted) against its plain version shard by shard, bit for
    bit, or the run fails."""
    before = pack_mod.pack_int8.launches
    got = pack_mod.pack_int8_buckets(xs)
    calls = pack_mod.pack_int8.launches - before
    want = [pack_mod._pack_plain(x) for x in xs]
    torch.cuda.synchronize()
    differ = [i for i, (a, b) in enumerate(zip(got, want))
              if not pack_same(a, b)]
    emit({"phase": "kernels", "kernel": "pack_int8", "table": name,
          "shards": len(xs), "elems": sum(x.numel() for x in xs),
          "calls": calls, "bitwise": not differ, "shards_differing": differ,
          "ok": not differ and calls == 1})
    if differ or calls != 1:
        fail(f"pack_int8_buckets over {name}: {calls} calls, shards "
             f"{differ} differ from the plain version")


# The plain SGD step between the two steps of resnet_comm_buckets.
COMM_BUCKETS_LR = 0.01


def resnet_comm_buckets(gen, world: int = 2) -> list[list[torch.Tensor]]:
    """Every compressed bucket of ResNet50_vd's comm plan at ``world``
    ranks (4 MiB, int8), filled with the real gradients of steps 1 and 2:
    one rank's share of RESNET_ARGV's batch (128 / world images of 224 px,
    bf16 activations, a new batch a step), smoothed cross-entropy, the
    step's 1/W scaling, and between the steps one plain SGD step
    (COMM_BUCKETS_LR). Step 1's gradients are mostly exact zeros (each
    residual block's last BatchNorm scale starts at zero, so no gradient
    reaches the convolutions inside the branch); step 2's are what the
    rest of a run packs. Returns [step 1's buckets, step 2's]."""
    from edl_tpu_torch.bridge import flax_named_parameters
    from edl_tpu_torch.models.resnet import ResNet50_vd
    from edl_tpu_torch.train import classification, comm

    model = ResNet50_vd(num_classes=1000, dtype=torch.bfloat16,
                        device="cuda", seed=0)
    named = flax_named_parameters(model)
    plan = comm.plan_buckets([p for _, p in named], 4.0, align=world)
    config = comm.CommConfig(compress="int8")
    rows = 128 // world
    steps = []
    for step in (1, 2):
        images = torch.randn((rows, 224, 224, 3), generator=gen,
                             device="cuda")
        labels = torch.randint(0, 1000, (rows,), generator=gen,
                               device="cuda")
        loss = classification.soft_cross_entropy(
            model(images), classification.smoothed_labels(labels, 1000, 0.1))
        loss.backward()
        grads = [p.grad * (1.0 / world) for _, p in named]
        bufs = [buf for buf, b in zip(comm.pack_buckets(grads, plan),
                                      plan.buckets)
                if comm._needs_residual(b, 1, world, config)]
        elems = sum(b.numel() for b in bufs)
        finite = all(bool(torch.isfinite(b).all()) for b in bufs)
        emit({"phase": "kernels", "kernel": "pack_int8",
              "plan": f"ResNet50_vd comm plan at world {world}",
              "step": step, "buckets": plan.n_buckets,
              "compressed": len(bufs), "elems": elems, "loss": loss.item(),
              "finite": finite,
              "zero_share": sum(int((b == 0).sum()) for b in bufs) / elems})
        if not finite:
            fail(f"ResNet50_vd's step {step} gradients are not finite")
        steps.append(bufs)
        with torch.no_grad():
            for _, p in named:
                p.add_(p.grad, alpha=-COMM_BUCKETS_LR)
                p.grad = None
    del model, named, grads
    return steps


def phase_kernels_pack(pack_mod, gen) -> tuple[dict, list[torch.Tensor]]:
    """K8 against its plain version, bit for bit: the CPU tests' grid, a
    4 MiB shard and every compressed bucket of ResNet50_vd's comm plan at
    world 2 with the real gradients of steps 1 and 2 (step 2's each shard
    alone too), each set as one table (pack_int8_buckets); a bf16 shard
    and a strided one refused. Returns ({"pack_int8": (0.0, checks)},
    the plan's buckets at steps 1 and 2)."""
    checks = 0
    grid = pack_grid(gen)
    for name, x in grid.items():
        pack_bitwise(pack_mod, name, x)
        checks += 1
    pack_table_bitwise(pack_mod, "the CPU tests' grid and a 4 MiB shard",
                       list(grid.values()))
    checks += 1
    for bad, err in ((torch.ones(8, device="cuda", dtype=torch.bfloat16),
                      TypeError),
                     (torch.ones(16, device="cuda")[::2], ValueError)):
        try:
            pack_mod.pack_int8(bad)
        except err:
            checks += 1
        else:
            fail(f"pack_int8 took a {bad.dtype} strided={bad.stride()} shard")
    steps = resnet_comm_buckets(gen)
    for i, buf in enumerate(steps[1]):
        pack_bitwise(pack_mod, f"ResNet50_vd step 2 bucket {i}", buf)
        checks += 1
    for step, bufs in enumerate(steps, 1):
        pack_table_bitwise(pack_mod, f"ResNet50_vd's compressed buckets at "
                           f"step {step}", bufs)
    return {"pack_int8": (0.0, checks + len(steps))}, steps


# bytes an element each K8 pass moves (the abs-max pass: x read; the pack
# pass: x read, q written)
K8_PASS_BYTES = {"amax": 4, "pack": 5}


def phase_timing_pack(pack_mod, steps: list[list[torch.Tensor]],
                      pack_log: str) -> dict:
    """K8 over ResNet50_vd's compressed buckets at world 2 with step 2's
    gradients (``steps``: resnet_comm_buckets'), through pack_int8_buckets
    (one call over every bucket, the entry the comm step uses): device
    time with the host queued ahead (the mean of 3 turns; step 1's mostly
    zero gradients beside it), the host-paced time and the plain
    version's; each pass alone beside its bytes' bound, and K8's registers
    and spills (ptxas). No PyTorch call computes the same function:
    library_ms is null."""
    bufs = steps[1]

    def step(plain: bool):
        if plain:
            for buf in bufs:
                pack_mod._pack_plain(buf)
        else:
            pack_mod.pack_int8_buckets(bufs)

    # stream entries of one call: a memset and two kernels
    iters = 10
    turns, step1_turns, host_bound = [], [], False
    for _ in range(3):
        ms, hb = time_ms_queued(lambda: step(False), iters=iters)
        turns.append(ms)
        host_bound |= hb
        ms, hb = time_ms_queued(
            lambda: pack_mod.pack_int8_buckets(steps[0]), iters=iters)
        step1_turns.append(ms)
        host_bound |= hb
    host_paced_ms = time_ms(lambda: step(False), iters=10)
    plain_ms = time_ms(lambda: step(True), iters=3, warmup=1)
    elems = sum(b.numel() for b in bufs)
    out = {"ms": float(np.mean(turns)), "plain_ms": plain_ms,
           "bound_ms": PACK_BOUND_BYTES * elems / PEAK_BYTES_S * 1e3,
           "bound_by": "bytes", "library_ms": None}
    packed = pack_mod.pack_int8_buckets(bufs)
    qs, scales = [q for q, _ in packed], [s for _, s in packed]
    passes = time_passes(
        lambda which: pack_mod.pack_int8_pass(bufs, qs, scales, which=which),
        {"amax": (0,), "pack": (1,)}, K8_PASS_BYTES, elems)
    emit({"phase": "timing", "kernel": "pack_int8", "buckets": len(bufs),
          "elems": elems, "per": "one step's compressed buckets",
          "gradients": "step 2", "ms_turns": turns,
          "ms_step1_gradients": float(np.mean(step1_turns)),
          "queued_steps": iters,
          "timing": "device: launches queued behind a sleep kernel",
          "host_bound": host_bound, "ms_host_paced": host_paced_ms,
          "design_bytes_ms": PACK_DESIGN_BYTES * elems / PEAK_BYTES_S * 1e3,
          **passes, "ptxas": ptxas_of(pack_log, "pack_kernel"), **out})
    if host_bound:
        fail("pack_int8: the host could not queue the timed launches ahead "
             "of the card")
    out["passes_ms"] = passes["passes_ms"]
    return out


# -- train_resnet_world: imagenet_train over two ranks on one card -----------

# Two ranks share cuda:0 (NCCL refuses two ranks on one card): gloo
# between them, every collective staged through host memory. Each rank is
# this script re-entered with --world-worker.
WORLD = 2
WORLD_RUNS = (("int8", ["--dcn-compress", "int8"]),
              ("dense", ["--comm-bucket-mb", "4"]))
WORLD_TIMEOUT_S = 420
GATE_ENVELOPE = 5e-3
DCN_CUT_MAX = 0.26      # the int8 wire's bytes against the fp32 leg's


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_world(run: str, argv: list, out_dir: Path) -> list[dict]:
    """WORLD ranks of ``run`` as processes of this script, all on cuda:0,
    meeting at a TCP store on 127.0.0.1. A rank that exits non-zero, or
    any rank still running after WORLD_TIMEOUT_S, fails the run; every
    rank is stopped before this returns. Returns each rank's JSON."""
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    try:
        for rank in range(WORLD):
            env = dict(os.environ, EDL_TPU_RANK=str(rank),
                       EDL_TPU_WORLD_SIZE=str(WORLD),
                       EDL_TPU_COORDINATOR=coordinator)
            with open(out_dir / f"{run}.rank{rank}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--world-worker", run, str(out_dir), json.dumps(argv)],
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                    cwd=str(HERE)))
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        for rank in range(WORLD):
            tail = (out_dir / f"{run}.rank{rank}.log").read_text()[-3000:]
            print(f"--- {run} rank {rank} (exit {codes[rank]}) ---\n{tail}",
                  file=sys.stderr, flush=True)
        fail(f"train_resnet_world {run}: ranks exited {codes} (negative: "
             f"killed at the {WORLD_TIMEOUT_S} s limit or by a peer's "
             "failure)")
    return [json.loads((out_dir / f"{run}.rank{r}.json").read_text())
            for r in range(WORLD)]


def world_train(argv: list) -> dict:
    """One rank of imagenet_train.main(argv): each step timed on the host
    clock between two synchronizes, its reduction with CUDA events and the
    device memory it allocates beyond what was live when it began, K8's
    and K4's launches counted (set to 0 just before the run, read just
    after); the rank's peak device memory over the run; the final state's
    digest. Runs any checkout of the port that is first on sys.path."""
    import hashlib

    from edl_tpu_torch.examples import imagenet_train
    from edl_tpu_torch.ops import opt_kernels as ok_mod
    from edl_tpu_torch.ops import pack as pack_mod
    from edl_tpu_torch.train import comm

    counters = {"pack_int8": pack_mod.pack_int8,
                "sgdm_fp32": ok_mod.sgdm_fp32}
    steps: list[dict] = []
    seen: dict = {}
    step_fn, reduce_fn = comm.CommTrainStep._step, comm.CommTrainStep._reduce

    def timed_reduce(self, grads):
        # the peak since the last reset folds into the run's before the
        # reduction's own window starts
        seen["peak"] = max(seen["peak"], torch.cuda.max_memory_allocated())
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e0 = event()
        out = reduce_fn(self, grads)
        seen["reduce"] = (e0, event())
        seen["reduce_extra"] = torch.cuda.max_memory_allocated() - live
        return out

    def timed_step(self, state, batch):
        torch.cuda.synchronize()
        c0 = {n: c.launches for n, c in counters.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(self, state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        e0, e1 = seen["reduce"]
        steps.append({"ms": (t1 - t0) * 1e3,
                      "reduce_ms": e0.elapsed_time(e1),
                      "reduce_extra_bytes": seen["reduce_extra"],
                      "launches": {n: c.launches - c0[n]
                                   for n, c in counters.items()},
                      "loss": float(metrics["loss"])})
        seen["state"], seen["step"] = state, self
        return state, metrics

    comm.CommTrainStep._step = timed_step
    comm.CommTrainStep._reduce = timed_reduce
    try:
        torch.cuda.reset_peak_memory_stats()
        seen["peak"] = 0
        for c in counters.values():
            c.launches = 0
        t0 = time.monotonic()
        rc = imagenet_train.main(argv)
        wall_s = time.monotonic() - t0
        launches = {n: c.launches for n, c in counters.items()}
        peak = max(seen["peak"], torch.cuda.max_memory_allocated())
    finally:
        comm.CommTrainStep._step = step_fn
        comm.CommTrainStep._reduce = reduce_fn
    state, step = seen["state"], seen["step"]
    digest = hashlib.sha256()
    for name, t in state.model.state_dict().items():
        digest.update(name.encode())
        digest.update(t.detach().cpu().numpy().tobytes())
    off = replace(step.config, compress="off")
    return {"rc": rc, "wall_s": wall_s, "steps": steps,
            "launches": launches, "peak_gib": peak / 2**30,
            "digest": digest.hexdigest(),
            "comm_buckets": step.plan.n_buckets,
            "compressed_buckets": sum(
                comm._needs_residual(b, step.chips, step.n_slices,
                                     step.config)
                for b in step.plan.buckets),
            "opt_buckets": len(state.opt_state.p), "stats": step.stats(),
            "topology": [step.n_slices, step.chips],
            "fp32_leg_bytes": comm.dcn_bytes_per_step(step.plan, off,
                                                      WORLD, 1)}


def world_gate() -> dict:
    """loss_parity_gate on ResNet50_vd at world 2 over 3 steps (int8,
    imagenet_train's schedule and fused fp32 SGD, a seeded batch of 128
    images, this rank's 64), under the default algorithms."""
    from edl_tpu_torch.examples import imagenet_train
    from edl_tpu_torch.models.resnet import ResNet50_vd
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.train import classification as cls
    from edl_tpu_torch.train import comm
    from edl_tpu_torch.train.fused_opt import make_fused_tx

    args = imagenet_train._parser().parse_args(["--data-dir", "-",
                                                *RESNET_ARGV])
    schedule = imagenet_train.build_schedule(args, RESNET_STEPS_PER_EPOCH)

    def state_fn():
        model = ResNet50_vd(num_classes=1000, dtype=torch.bfloat16,
                            device="cuda", seed=0)
        return cls.create_state(model, make_fused_tx(
            "sgdm", schedule, "fp32", momentum=0.9, weight_decay=1e-4))

    def loss_fn(model, batch):
        model.train()
        logits = model(batch["image"])
        targets = cls.smoothed_labels(batch["label"], 1000, 0.1)
        return cls.soft_cross_entropy(logits, targets), {}

    rng = np.random.default_rng(1)
    rows, r = 128 // WORLD, distributed.rank()
    images = rng.normal(size=(128, 224, 224, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, size=128).astype(np.int32)
    batch = {"image": torch.from_numpy(images[r * rows:(r + 1) * rows]),
             "label": torch.from_numpy(labels[r * rows:(r + 1) * rows])}
    batch = {k: v.cuda() for k, v in batch.items()}
    config = comm.CommConfig(compress="int8")
    return comm.loss_parity_gate(loss_fn, state_fn, batch, config=config,
                                 steps=3, envelope=GATE_ENVELOPE)


def world_worker(run: str, out_dir: str, argv_json: str) -> int:
    """One rank (the EDL_TPU_* env names it) of a train_resnet_world run:
    join the world over gloo, run, write this rank's JSON."""
    sys.path.insert(0, str(HERE))
    from edl_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = distributed.init_from_env(backend="gloo")
    torch.cuda.set_device(distributed.rank_device("cuda", env.rank))
    result = (world_gate() if run == "gate"
              else world_train(json.loads(argv_json)))
    result.update(rank=env.rank, card=torch.cuda.current_device(),
                  backend="gloo")
    Path(out_dir, f"{run}.rank{env.rank}.json").write_text(
        json.dumps(result))
    distributed.shutdown()
    return 0


def world_want(name: str) -> dict:
    """The launches of a step of one rank in the world run ``name``: one
    K8 call over every compressed bucket in the int8 run (none in the
    dense run) and one K4 launch over every optimizer bucket."""
    return {"pack_int8": int(name == "int8"), "sgdm_fp32": 1}


def world_summary(name: str, ranks: list[dict], blog_dir: Path) -> dict:
    """The gates of one world training run, each fatal: the launches of
    ``world_want`` every step on each rank, the ranks' final states bitwise
    equal, the loss finite with falling epoch means and the last epoch
    below step 1."""
    for rk in ranks:
        want = world_want(name)
        for i, st in enumerate(rk["steps"]):
            if st["launches"] != want:
                fail(f"world {name} rank {rk['rank']} step {i + 1} "
                     f"launched {st['launches']}, want {want}")
        if rk["rc"] != 0 or len(rk["steps"]) != 3 * RESNET_STEPS_PER_EPOCH:
            fail(f"world {name} rank {rk['rank']}: rc {rk['rc']}, "
                 f"{len(rk['steps'])} steps")
    if len({rk["digest"] for rk in ranks}) != 1:
        fail(f"world {name}: the ranks' final states differ "
             f"({[rk['digest'][:16] for rk in ranks]})")
    r0 = ranks[0]
    losses = [st["loss"] for st in r0["steps"]]
    epochs = [float(np.mean(losses[i:i + RESNET_STEPS_PER_EPOCH]))
              for i in range(0, len(losses), RESNET_STEPS_PER_EPOCH)]
    timed = r0["steps"][TIMED_FROM_STEP - 1:]
    step_ms = float(np.median([st["ms"] for st in timed]))
    with open(blog_dir / "log_0.json") as f:
        blog = json.load(f)
    result = {"phase": f"train_resnet_world_{name}", "world": WORLD,
              "backend": "gloo (both ranks on cuda:0, staged through host "
                         "memory)",
              "steps": len(losses), "wall_s": [rk["wall_s"] for rk in ranks],
              "step_ms_median": step_ms,
              "step_ms_min": min(st["ms"] for st in timed),
              "step_ms_max": max(st["ms"] for st in timed),
              "reduce_ms_median": float(np.median(
                  [st["reduce_ms"] for st in timed])),
              "reduce_extra_mib_max": max(
                  st["reduce_extra_bytes"] for st in r0["steps"]) / 2**20,
              "peak_gib": [rk["peak_gib"] for rk in ranks],
              "timed_steps": f"{TIMED_FROM_STEP}-{len(losses)}",
              "images_per_s": 128 / (step_ms / 1e3),
              "loss_first": losses[0], "loss_last": losses[-1],
              "epoch_mean_losses": epochs, "losses": losses,
              "last_epoch_max": max(losses[-RESNET_STEPS_PER_EPOCH:]),
              "eval_acc1": blog["final"].get("acc1"),
              "eval_acc5": blog["final"].get("acc5"),
              "comm_buckets": r0["comm_buckets"],
              "compressed_buckets": r0["compressed_buckets"],
              "opt_buckets": r0["opt_buckets"], "topology": r0["topology"],
              "stats": r0["stats"], "fp32_leg_bytes": r0["fp32_leg_bytes"],
              "benchmark_log_keys": sorted(blog),
              "launches": {n: sum(rk["launches"][n] for rk in ranks)
                           for n in r0["launches"]},
              "launches_per_step_per_rank": r0["steps"][0]["launches"],
              "digest": r0["digest"]}
    emit(result)
    if not (all(np.isfinite(losses)) and len(epochs) == 3
            and all(b < a for a, b in zip(epochs, epochs[1:]))
            and epochs[-1] < losses[0]):
        fail(f"world {name}: losses {losses} not finite, or the epoch "
             f"means {epochs} not falling below step 1's")
    return result


def phase_train_resnet_world() -> dict:
    """imagenet_train at RESNET_ARGV over a world of two ranks on one
    card (gloo), --fused-opt fp32, from the same init on the same shards:
    --dcn-compress int8 (K8 on every compressed bucket) and
    --comm-bucket-mb 4 (bucketed dense); then loss_parity_gate on
    ResNet50_vd. Gates: world_summary's for each run; the int8 run's last
    loss within ENVELOPE x the dense run's improvement; the gate bitwise
    dense with an int8 loss delta <= GATE_ENVELOPE; the int8 wire's bytes
    <= DCN_CUT_MAX x the same plan's fp32 leg. Returns each run's
    launches."""
    import tempfile

    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, flags in WORLD_RUNS:
            argv = ["--data-dir", str(tmp / "data"), *RESNET_ARGV,
                    "--fused-opt", "fp32", *flags, "--benchmark-log",
                    str(tmp / name)]
            if not runs:
                argv += ["--make-synthetic", str(RESNET_SHARDS)]
            runs[name] = world_summary(name, spawn_world(name, argv, tmp),
                                       tmp / name)
        gate = spawn_world("gate", [], tmp)[0]
    int8, dense = runs["int8"], runs["dense"]
    improvement = dense["loss_first"] - dense["loss_last"]
    delta = abs(int8["loss_last"] - dense["loss_last"])
    cut = int8["stats"]["dcn_bytes_per_step"] / int8["fp32_leg_bytes"]
    out = {"phase": "train_resnet_world_gates", "gate": gate,
           "int8_vs_dense": {"loss_dense": dense["loss_last"],
                             "loss_int8": int8["loss_last"], "delta": delta,
                             "improvement": improvement,
                             "envelope": ENVELOPE},
           "dcn_bytes_per_step": int8["stats"]["dcn_bytes_per_step"],
           "fp32_leg_bytes": int8["fp32_leg_bytes"], "dcn_cut": cut,
           "dcn_cut_max": DCN_CUT_MAX}
    emit(out)
    if not (improvement > 0 and delta <= ENVELOPE * improvement):
        fail(f"world int8 run ends at {int8['loss_last']}, {delta} from the "
             f"dense run's {dense['loss_last']}, outside {ENVELOPE} x "
             f"{improvement}")
    if not (gate["bitwise_dense"]
            and gate["max_loss_delta"] <= GATE_ENVELOPE):
        fail(f"loss_parity_gate on ResNet50_vd: {gate}")
    if not cut <= DCN_CUT_MAX:
        fail(f"int8 wire {cut} x the fp32 leg's bytes, above {DCN_CUT_MAX}")
    return {f"train_resnet_world_{n}": {k: v for k, v in r["launches"].items()
                                        if v} for n, r in runs.items()}


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
    from edl_tpu_torch.ops import pack as pack_mod
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
                      for n, r in built.items()},
          **flash_build(_build, {n: built[n]["log"] for n in FLASH_LIBS})})

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernels(fa, gen)
    errs.update(phase_kernels_bwd(fa, gen))
    errs.update(phase_kernels_adam(ok_mod, fo, gen))
    errs.update(phase_kernels_opt(ok_mod, fo, gen))
    for name, (_, n) in phase_kernels_tables(ok_mod, fo, gen).items():
        errs[name] = (0.0, errs[name][1] + n)
    pack_errs, pack_bufs = phase_kernels_pack(pack_mod, gen)
    errs.update(pack_errs)
    timing = {"flash_fwd": phase_timing(fa, gen)}
    timing.update(phase_timing_train(fa, gen))
    timing["adam_fp32"], plan_checks = phase_timing_adam(ok_mod, fo, gen)
    errs["adam_fp32"] = (0.0, errs["adam_fp32"][1] + plan_checks)
    sgdm_timing, sgdm_checks = phase_timing_sgdm(ok_mod, fo, gen,
                                                 built["sgdm"]["log"])
    timing.update(sgdm_timing)
    timing["adam_q"], adam_q_checks = phase_timing_adam_q(ok_mod, fo, gen)
    sgdm_checks["adam_q"] = adam_q_checks
    timing["pack_int8"] = phase_timing_pack(pack_mod, pack_bufs,
                                            built["pack"]["log"])
    del pack_bufs
    for name, n in sgdm_checks.items():
        errs[name] = (0.0, errs[name][1] + n)
    serve, model, dense, predict = phase_serve(fa)
    launches = {"serve": {"flash_fwd": serve["flash_launches"]}}
    phase_forward(fa, model, dense, predict)
    del model, dense, predict
    torch.cuda.empty_cache()
    launches["train"], lm_fp32 = phase_train(fa, ok_mod)
    launches["train_int8"] = phase_train_int8(fa, ok_mod, lm_fp32)
    resnet_launches, _ = phase_train_resnet(ok_mod)
    launches.update(resnet_launches)
    launches.update(phase_train_resnet_world())
    emit({"seconds": time.monotonic() - t_start, "card": card})

    kernels = []
    for name, source, replaces in KERNELS:
        by_path = {path: n[name] for path, n in launches.items() if name in n}
        if not by_path:
            fail(f"{name} was launched on no path")
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
    if sys.argv[1:2] == ["--world-worker"]:
        sys.exit(world_worker(*sys.argv[2:5]))
    sys.exit(main())
