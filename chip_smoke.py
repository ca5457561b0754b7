#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repo root; needs a card and nvcc

Phases, each printed as one JSON line; any failure exits non-zero:

1. build   — the card's name and power limit (nvidia-smi), then every
             kernel under edl_tpu_torch/ops/csrc built with nvcc for sm_90a
             (one nvcc per source, started together);
2. kernels — each kernel against its plain PyTorch version on the card,
             on the same inputs, over a grid of shapes and the serving
             path's shape (bounds as in tests/test_flash_attention.py:
             2e-5 fp32, 3e-2 bf16);
3. timing  — each kernel at the serving path's shape: its time, its
             plain version's, one PyTorch library call computing the same
             function (timed only, never used by the port), and the
             least time the card could take for the work;
4. serve   — the transformer LM teacher at the repo's base config
             (bench.py's: vocab 32768, d_model 1024, 16 heads, 8 layers,
             d_ff 4096, S 1024, bf16 activations, fp32 params; seeded
             random weights) behind TeacherServer, answering 16
             concurrent TeacherClients with device top-16, in 3 rounds
             of 400 requests (enough in flight to fill 8-row batches).
             Launch counters are set to 0 just before and read just
             after; the answers are held against the same weights with
             plain dense attention;
5. forward — where one 8-row predict's time goes: the flash launches
             and lm_head timed with CUDA events inside real forwards.

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

# The card's published peaks (H100 SXM data sheet, dense).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

# The serving path: bench.py's base LM config, buckets of 8 rows.
MAIN = dict(b=8, s=1024, h=16, d=64, dtype=torch.bfloat16, causal=True)
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


def phase_kernels(fa, gen) -> float:
    """Kernel vs plain version on the card; returns the max abs error."""
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
        if case.get("fused"):
            # q/k/v as strided views of one (B, S, 3, H, D) projection
            qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                              dtype=torch.float32).to(dt)
            q, k, v = qkv.unbind(2)
        else:
            q, k, v = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda", dtype=torch.float32).to(dt)
                       for _ in range(3))
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
    return worst


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
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)

    cfg = TransformerConfig(vocab_size=32768, d_model=1024, n_heads=16,
                            n_layers=8, d_ff=4096, max_len=1024,
                            dtype=torch.bfloat16)
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
    max_err = phase_kernels(fa, gen)
    timing = phase_timing(fa, gen)
    serve, model, dense, predict = phase_serve(fa)
    phase_forward(fa, model, dense, predict)

    kernels = [{"name": "flash_fwd", "route": "cuda",
                "source": "edl_tpu_torch/ops/csrc/flash_fwd.cu",
                "replaces": "edl_tpu/ops/flash_attention.py:47",
                "launches": serve["flash_launches"],
                "max_abs_err": max_err, **timing, "ok": True}]
    emit({"seconds": time.monotonic() - t_start, "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
