#!/usr/bin/env python3
"""Device time of one step of the PyTorch port's lm_train, by kernel, under
torch.profiler, on one CUDA card.

    PYTHONPATH=<checkout> python3 tools/torch_lm_step_profile.py

Builds lm_train's step at the base config (vocab 32768, d_model 1024, 16
heads of 64, 8 layers, d_ff 4096, S 1024, bf16 activations, fused fp32
Adam) with seeded random weights and 16 rows of seeded random tokens a
step, runs WARMUP steps, then profiles STEPS more. Prints one JSON
line: the card (name and power limit), the host ms a step, the device ms a
step summed over every kernel, the flash backward's share (the dK/dV and
dQ kernels of ops/csrc/flash_bwd.cu) and the flash forward's, and the
kernels that take the most device time. The port is imported from
PYTHONPATH, so one script profiles any checkout of it, side by side.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import torch

FLASH_BWD = re.compile(r"\b(dkdv|dq)_\w*kernel")
FLASH_FWD = re.compile(r"\bflash_fwd\w*kernel")
WARMUP, STEPS, TOP = 3, 3, 8


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lm_step_profile: needs a CUDA card", file=sys.stderr)
        return 1

    import edl_tpu_torch
    from edl_tpu_torch.bridge import flax_named_parameters
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lm_loss_fn)
    from edl_tpu_torch.train import state as state_lib
    from edl_tpu_torch.train.fused_opt import make_fused_tx
    from edl_tpu_torch.train.step import make_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = TransformerConfig(vocab_size=32768, d_model=1024, n_heads=16,
                            n_layers=8, d_ff=4096, max_len=1024,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", seed=0)
    model.train()
    state = state_lib.TrainState.create(
        model=model, tx=make_fused_tx("adam", 3e-4, "fp32", weight_decay=0.01),
        params=flax_named_parameters(model))
    step = make_train_step(lm_loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (16, cfg.max_len),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}

    for _ in range(WARMUP):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    kernels: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3 / STEPS

    def share(pattern):
        return sum(ms for k, ms in kernels.items() if pattern.search(k))

    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    print(json.dumps({
        "card": card, "port": edl_tpu_torch.__file__, "steps": STEPS,
        "host_ms_per_step": host_ms,
        "device_ms_per_step": sum(kernels.values()),
        "flash_bwd_device_ms_per_step": share(FLASH_BWD),
        "flash_fwd_device_ms_per_step": share(FLASH_FWD),
        "top_kernels_ms_per_step": {k[:120]: ms for k, ms in top}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
