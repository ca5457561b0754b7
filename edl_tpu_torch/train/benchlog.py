"""Benchmark-result JSON emission for training jobs (copy of
``edl_tpu.train.benchlog``).

Capability of the reference's benchmark_test output (example/collective/
resnet50/train_with_fleet.py:642-658: rank 0 writes
benchmark_logs/log_{rank} holding final eval metrics, the per-epoch
metric log, max epoch throughput x world size, and the batch size) with
a sane schema instead of numbered string keys.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.train.benchlog")


class BenchmarkLog:
    """Collects per-epoch metrics + throughput; writes one JSON file.

    Usage:
        blog = BenchmarkLog("resnet50_vd", batch_size=256, world_size=8)
        for epoch ...:
            blog.epoch(epoch, examples_per_sec=..., **eval_metrics)
        blog.write(out_dir, rank)
    """

    def __init__(self, model: str, batch_size: int, world_size: int = 1,
                 **extra: Any):
        self.result: dict[str, Any] = {
            "model": model,
            "batch_size": batch_size,
            "world_size": world_size,
            "started_unix": time.time(),
            "epochs": [],
            **extra,
        }

    def extra(self, **kv: Any) -> None:
        """Merge late top-level extras (e.g. the train loop's checkpoint
        save-stall/restore accounting, known only after the run)."""
        self.result.update({k: _scalar(v) for k, v in kv.items()})

    def epoch(self, epoch: int, examples_per_sec: float | None = None,
              **metrics: Any) -> None:
        entry = {"epoch": epoch, **{k: _scalar(v) for k, v in metrics.items()}}
        if examples_per_sec is not None:
            entry["examples_per_sec"] = float(examples_per_sec)
        self.result["epochs"].append(entry)

    def finalize(self) -> dict:
        if self.result.get("elapsed_secs") is not None:
            return self.result  # idempotent: keep the first finalize's stats
        epochs = self.result["epochs"]
        speeds = [e["examples_per_sec"] for e in epochs
                  if "examples_per_sec" in e]
        if speeds:
            # reference result['1']: max epoch speed x trainer count
            self.result["max_examples_per_sec"] = max(speeds)
            self.result["max_examples_per_sec_global"] = (
                max(speeds) * self.result["world_size"])
        if epochs:
            self.result["final"] = {k: v for k, v in epochs[-1].items()
                                    if k != "epoch"}
        self.result["elapsed_secs"] = time.time() - self.result["started_unix"]
        return self.result

    def write(self, out_dir: str = "./benchmark_logs", rank: int = 0) -> str:
        self.finalize()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"log_{rank}.json")
        with open(path, "w") as f:
            json.dump(self.result, f, indent=1)
        log.info("benchmark log written to %s", path)
        return path


def _scalar(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
