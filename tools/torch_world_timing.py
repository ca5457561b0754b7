#!/usr/bin/env python3
"""chip_smoke.py's int8 world run for one or more checkouts of the PyTorch
port, in turns, on one CUDA card.

    python3 tools/torch_world_timing.py <checkout> [<checkout> ...]

For each checkout named, in the order given (a checkout named twice runs
twice): imagenet_train at chip_smoke's ResNet50_vd config (RESNET_ARGV,
3 epochs of 10 steps, --fused-opt fp32 --dcn-compress int8) over two
ranks sharing cuda:0 through gloo. Each rank is chip_smoke's world_train
with the checkout first on its PYTHONPATH: each step's host ms and its
reduction's ms (CUDA events), the device memory the reduction allocates
beyond what was live when it began, the rank's peak device memory and its
K8 launches a step. The first run makes the synthetic shards; every run
reads them. Prints one JSON line a run, then one with the card's name and
power limit. To compare two checkouts on one card, name them in turns
(A B B A).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def chip_smoke():
    """chip_smoke.py of this tree, loaded by its path (a checkout on
    PYTHONPATH may hold another)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(out: str, argv_json: str) -> int:
    """One rank (the EDL_TPU_* env names it): world_train, its JSON to
    ``out``."""
    cs = chip_smoke()
    import edl_tpu_torch
    from edl_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = distributed.init_from_env(backend="gloo")
    torch.cuda.set_device(distributed.rank_device("cuda", env.rank))
    result = cs.world_train(json.loads(argv_json))
    result.update(rank=env.rank, port=edl_tpu_torch.__file__)
    Path(out).write_text(json.dumps(result))
    distributed.shutdown()
    return 0


def run(cs, checkout: Path, argv: list, tmp: Path, turn: int) -> dict:
    """The int8 world run of ``checkout``: both ranks, stopped before
    this returns. Returns its summary."""
    coordinator = f"127.0.0.1:{cs.free_port()}"
    outs = [tmp / f"turn{turn}.rank{r}.json" for r in range(cs.WORLD)]
    procs = []
    try:
        for rank in range(cs.WORLD):
            env = dict(os.environ, PYTHONPATH=str(checkout),
                       EDL_TPU_RANK=str(rank),
                       EDL_TPU_WORLD_SIZE=str(cs.WORLD),
                       EDL_TPU_COORDINATOR=coordinator)
            with open(tmp / f"turn{turn}.rank{rank}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--worker", str(outs[rank]), json.dumps(argv)],
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                    cwd=str(checkout)))
        deadline = time.monotonic() + cs.WORLD_TIMEOUT_S
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
    if any(p.returncode for p in procs):
        for rank in range(cs.WORLD):
            tail = (tmp / f"turn{turn}.rank{rank}.log").read_text()[-3000:]
            print(f"--- {checkout} rank {rank} ---\n{tail}", file=sys.stderr)
        raise RuntimeError(f"{checkout}: ranks exited "
                           f"{[p.returncode for p in procs]}")
    ranks = [json.loads(o.read_text()) for o in outs]
    timed = ranks[0]["steps"][cs.TIMED_FROM_STEP - 1:]
    return {
        "checkout": str(checkout), "port": ranks[0]["port"], "turn": turn,
        "steps": len(ranks[0]["steps"]),
        "timed_steps": f"{cs.TIMED_FROM_STEP}-{len(ranks[0]['steps'])}",
        "step_ms_median": float(np.median([st["ms"] for st in timed])),
        "step_ms_min": min(st["ms"] for st in timed),
        "step_ms_max": max(st["ms"] for st in timed),
        "reduce_ms_median": float(np.median([st["reduce_ms"]
                                             for st in timed])),
        "reduce_extra_mib_max": [
            max(st["reduce_extra_bytes"] for st in rk["steps"]) / 2**20
            for rk in ranks],
        "peak_gib": [rk["peak_gib"] for rk in ranks],
        "launches_per_step_per_rank": ranks[0]["steps"][0]["launches"],
        "dcn_bytes_per_step": ranks[0]["stats"]["dcn_bytes_per_step"],
        "ranks_bitwise_equal": len({rk["digest"] for rk in ranks}) == 1,
        "loss_last": ranks[0]["steps"][-1]["loss"]}


def main(checkouts: list[str]) -> int:
    if not torch.cuda.is_available() or not checkouts:
        print("torch_world_timing: needs a CUDA card and one or more "
              "checkouts", file=sys.stderr)
        return 1
    cs = chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for turn, checkout in enumerate(checkouts):
            argv = ["--data-dir", str(tmp / "data"), *cs.RESNET_ARGV,
                    "--fused-opt", "fp32", "--dcn-compress", "int8",
                    "--benchmark-log", str(tmp / f"log{turn}")]
            if turn == 0:
                argv += ["--make-synthetic", str(cs.RESNET_SHARDS)]
            print(json.dumps(run(cs, Path(checkout).resolve(), argv, tmp,
                                 turn)), flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "run": "int8 world, 2 ranks on cuda:0 (gloo)"}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(*sys.argv[2:4]))
    sys.exit(main(sys.argv[1:]))
