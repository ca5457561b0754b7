"""Typed config with env-var overlay (trimmed copy of
``edl_tpu.utils.config``).

Dataclass fields declare an ``env`` name in metadata; ``from_env`` builds
the config as defaults < env < explicit kwargs, with values parsed by the
field's declared type. ``ENV_VARS`` lists only the knobs the port reads;
their names and meanings are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from typing import Any, TypeVar

T = TypeVar("T")

ENV_VARS: dict[str, str] = {
    "EDL_TPU_LOG_LEVEL": "python log level for edl_tpu loggers",
    "EDL_TPU_WIRE_STALL_S": "mid-frame wire stall deadline seconds "
                            "(<=0 disables)",
    "EDL_TPU_TRACE": "causal span tracing: 1 = on (sink ./edl_trace), "
                     "a path = on with that sink dir, 0/unset = off",
    "EDL_TPU_SERVE_BATCHING": "teacher batch admission mode: continuous "
                              "(iteration-level) or window (coalesce)",
    "EDL_TPU_SERVE_ADMIT_CAP": "bounded per-(tenant, class) teacher "
                               "queue; past it submits reject with "
                               "retry-after",
    "EDL_TPU_SERVE_CLASS_WEIGHTS": "WFQ weights per priority class, "
                                   "e.g. high=4,normal=2,low=1 (also "
                                   "scales shed delay budgets)",
    "EDL_TPU_SERVE_SHED_MS": "normal-class queue-delay budget (ms) for "
                             "overload shedding; <=0 disables the "
                             "delay-based shed rule",
    # trainer environment (collective/job_env.TrainerEnv)
    "EDL_TPU_JOB_ID": "job identifier shared by every pod of one job",
    "EDL_TPU_POD_ID": "this pod's unique id within the job",
    "EDL_TPU_RANK": "trainer rank within the elastic world",
    "EDL_TPU_WORLD_SIZE": "elastic world size (launcher pod count)",
    "EDL_TPU_COORDINATOR": "distributed coordinator endpoint",
    "EDL_TPU_CLUSTER_JSON": "serialized Cluster doc handed to trainers",
    "EDL_TPU_CLUSTER_VERSION": "cluster generation the trainer launched "
                               "into",
    "EDL_TPU_STORE_ENDPOINTS": "coordination store endpoints",
    "EDL_TPU_SLICES": "multi-slice topology: number of slices",
    "EDL_TPU_SLICE_ID": "this trainer's slice index (rank-contiguous)",
    # train loop (train/loop.LoopConfig)
    "EDL_TPU_NUM_EPOCHS": "epochs to train",
    "EDL_TPU_LOG_EVERY": "log metrics every N steps",
    "EDL_TPU_CHECKPOINT_PATH": "checkpoint directory root",
    "EDL_TPU_PROFILE_DIR": "profiler trace output directory",
    "EDL_TPU_PREFETCH_BATCHES": "host->device prefetch depth",
    "EDL_TPU_LOADER_WORKERS": "mp input-plane worker processes (0 = inline)",
    "EDL_TPU_COMM_BUCKET_MB": "gradient reduction bucket size MiB "
                              "(0 = one fused reduction)",
    "EDL_TPU_DCN_COMPRESS": "cross-slice gradient wire format: off | topk "
                            "| int8",
    "EDL_TPU_FUSED_OPT": "fused optimizer path: off | fp32 | int8 | fp8",
    "EDL_TPU_AUGMENT_DEVICE": "crop/flip/normalize on the device "
                              "(imagenet_train; refused until ported)",
    "EDL_TPU_OPT_QUANT": "override the resident-moment codec of the fused "
                         "optimizer: off | int8 | fp8 (empty = what "
                         "EDL_TPU_FUSED_OPT implies)",
}


def _declared(name: str) -> str:
    if name not in ENV_VARS:
        raise KeyError(f"{name} is not declared in "
                       "edl_tpu_torch.utils.config.ENV_VARS")
    return name


def env_str(name: str, default: str | None = None) -> str | None:
    """Read a declared knob as a string (None/default when unset)."""
    value = os.environ.get(_declared(name))
    return default if value is None or value == "" else value


def env_float(name: str, default: float = 0.0) -> float:
    value = os.environ.get(_declared(name), "").strip()
    try:
        return float(value) if value else default
    except ValueError:
        return default


def field(default: Any = dataclasses.MISSING, *,
          env: str | tuple[str, ...] | None = None, **kw):
    """Dataclass field that can be overridden by the env var ``env`` (a
    tuple names aliases — first one set wins)."""
    metadata = dict(kw.pop("metadata", {}))
    if env is not None:
        metadata["env"] = env
    if default is not dataclasses.MISSING and not kw.get("default_factory"):
        kw["default"] = default
    return dataclasses.field(metadata=metadata, **kw)


def _parse(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str):
        return typ(value)
    return value


def from_env(cls: type[T], **overrides: Any) -> T:
    """Build ``cls`` with env-var overlay: defaults < env < overrides."""
    hints = typing.get_type_hints(cls)
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        env_name = f.metadata.get("env")
        names = (env_name,) if isinstance(env_name, str) else (env_name or ())
        for name in names:
            if name.startswith("EDL_TPU_"):
                _declared(name)   # typo'd knobs fail loudly, not silently
            if name in os.environ:
                kwargs[f.name] = _parse(os.environ[name],
                                        hints.get(f.name, str))
                break
    kwargs.update(overrides)
    return cls(**kwargs)
