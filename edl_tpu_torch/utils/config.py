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
    "EDL_TPU_SERVE_RETRY_BUDGET": "reader-side bounded retry budget per "
                                  "task on teacher shed responses",
    "EDL_TPU_DISTILL_NOP": "distill reader no-op mode (wire debugging)",
    # trainer environment (collective/job_env.TrainerEnv)
    "EDL_TPU_JOB_ID": "job identifier shared by every pod of one job",
    "EDL_TPU_POD_ID": "this pod's unique id within the job",
    "EDL_TPU_RANK": "trainer rank within the elastic world",
    "EDL_TPU_WORLD_SIZE": "elastic world size (launcher pod count)",
    "EDL_TPU_COORDINATOR": "distributed coordinator endpoint",
    "EDL_TPU_CLUSTER_JSON": "serialized Cluster doc handed to trainers",
    "EDL_TPU_CLUSTER_VERSION": "cluster generation the trainer launched "
                               "into",
    "EDL_TPU_STORE_ENDPOINTS": "coordination store endpoints "
                               "(comma-joined for failover)",
    "EDL_TPU_SLICES": "multi-slice topology: number of slices",
    "EDL_TPU_SLICE_ID": "this trainer's slice index (rank-contiguous)",
    "EDL_TPU_JOBSERVER": "JobServer endpoint for resize control",
    # store client (coord/client.StoreClient) and watches (coord/store)
    "EDL_TPU_RELAY_ENDPOINTS": "watch relay tier endpoints (refused: "
                               "ROADMAP Queue 1 item 17)",
    "EDL_TPU_WATCH_RESYNC_S": "resync safety-net period for event-driven "
                              "watch consumers",
    "EDL_TPU_FLIGHT_RECORDER_N": "flight-recorder ring capacity per "
                                 "process (0 = off)",
    # launcher (collective/job_env.JobEnv)
    "EDL_TPU_NODES_RANGE": "elastic node range 'min:max'",
    "EDL_TPU_NPROC_PERNODE": "trainer processes per node (0 = auto)",
    "EDL_TPU_UP_LIMIT_NODES": "hard ceiling on world growth",
    "EDL_TPU_LOG_DIR": "launcher workerlog directory",
    "EDL_TPU_LEASE_TTL": "store lease TTL seconds for pod claims",
    "EDL_TPU_BARRIER_STABLE": "seconds membership must hold still to pass "
                              "the barrier",
    "EDL_TPU_BARRIER_TIMEOUT": "elastic barrier hard timeout seconds",
    "EDL_TPU_REJOIN_DELAY": "pod rejoin backoff seconds after a kick",
    "EDL_TPU_RESIZE_P2P": "peer-to-peer live state migration (0 = "
                          "stop-resume from disk)",
    "EDL_TPU_DONOR_LINGER": "seconds a released trainer keeps serving its "
                            "sealed snapshot",
    "EDL_TPU_ADOPT_TIMEOUT": "launcher wait for in-place adoption before "
                             "stop-resume",
    # reform state machine (collective/reform.ReformConfig)
    "EDL_TPU_REFORM_QUIESCE_S": "reform quiesce-phase deadline seconds "
                                "(step/ckpt drain; stop-resume downgrade)",
    "EDL_TPU_REFORM_MESH_S": "reform mesh-re-formation deadline seconds "
                             "(stop-resume downgrade)",
    "EDL_TPU_REFORM_RESTORE_S": "reform peer/disk restore deadline seconds "
                                "(peer failure downgrades to disk)",
    "EDL_TPU_REFORM_REJIT_S": "reform re-jit + first-step deadline seconds "
                              "(advisory past dispatch; launcher adopt "
                              "timeout is the hard bound)",
    # utilization publishing (coord/collector.UtilizationPublisher)
    "EDL_TPU_PUBLISH_UTIL": "trainer utilization publishing (0 = off)",
    "EDL_TPU_STORE_SHARDS": "shard-group count when splitting a flat "
                            "replica list (refused above 1: ROADMAP Queue "
                            "1 item 17)",
    # autoscaler (scaler/controller.ScalerConfig)
    "EDL_TPU_SCALER_INTERVAL": "fallback decision interval seconds",
    "EDL_TPU_SCALER_MIN_TICK": "floor between event-triggered passes",
    "EDL_TPU_SCALER_COOLDOWN": "per-job resize cooldown seconds",
    "EDL_TPU_SCALER_GAIN": "marginal-gain threshold to grow",
    "EDL_TPU_SCALER_STALENESS": "utilization record staleness bound",
    "EDL_TPU_SCALER_MIN_NODES": "per-job world floor",
    "EDL_TPU_SCALER_MAX_NODES": "per-job world ceiling",
    "EDL_TPU_SCALER_LEADER_TTL": "scaler leader-election lease TTL",
    "EDL_TPU_ELASTIC_DOWNTIME_S": "seed value for the per-resize downtime "
                                  "charge",
    "EDL_TPU_DOWNTIME_ARTIFACT": "bench JSON to seed the downtime charge "
                                 "from",
    # serving elasticity (scaler/serving.ServingConfig)
    "EDL_TPU_SERVE_SLO_P95_MS": "serving latency SLO target (p95, ms)",
    "EDL_TPU_SERVE_QUEUE_HIGH": "queued requests per teacher counting as "
                                "a breach",
    "EDL_TPU_SERVE_SHED_HIGH": "pool-wide shed rate (rejects/sec) "
                               "counting as a breach even at healthy "
                               "p95",
    "EDL_TPU_SERVE_UTIL_LOW": "shrink only under this mean utilization",
    "EDL_TPU_SERVE_SHRINK_HEADROOM": "shrink only with p95 under this "
                                     "fraction of the SLO",
    "EDL_TPU_SERVE_BREACH_TICKS": "consecutive breach ticks before a grow",
    "EDL_TPU_SERVE_IDLE_TICKS": "consecutive idle ticks before a shrink",
    "EDL_TPU_SERVE_COOLDOWN": "serving resize cooldown seconds",
    "EDL_TPU_SERVE_GROW_FACTOR": "multiplicative grow cap",
    "EDL_TPU_SERVE_MIN_TEACHERS": "pool floor",
    "EDL_TPU_SERVE_MAX_TEACHERS": "pool ceiling",
    "EDL_TPU_SERVE_DRAIN_DEADLINE": "graceful-drain budget before "
                                    "hard-kill",
    # spot capacity (examples/elastic_demo --spot)
    "EDL_TPU_SPOT_NOTICE_S": "spot preemption notice window seconds a "
                             "noticed worker has to quiesce-seal-donate "
                             "before the hard kill (0 = ignore notices)",
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
    "EDL_TPU_MOE_DISPATCH": "MoE all-to-all decomposition: flat | hier "
                            "(in-slice leg + cross-slice leg)",
    "EDL_TPU_MOE_COMPRESS": "MoE dispatch cross-slice wire format: "
                            "off | int8 (parity-gated)",
    "EDL_TPU_FUSED_OPT": "fused optimizer path: off | fp32 | int8 | fp8",
    "EDL_TPU_AUGMENT_DEVICE": "crop/flip/normalize on the device "
                              "(imagenet_train; default on for packed)",
    "EDL_TPU_SAVE_CHECKPOINT_INTER": "checkpoint every N epochs",
    "EDL_TPU_CKPT_STEPS": "also checkpoint every N optimizer steps "
                          "(0 = epoch ends only)",
    "EDL_TPU_SAVE_CHECKPOINT_STEPS": "alias of EDL_TPU_CKPT_STEPS",
    "EDL_TPU_CHECKPOINT_KEEP": "sealed checkpoint versions to keep",
    "EDL_TPU_CKPT_ASYNC": "async snapshot-then-write saves (0 = sync)",
    "EDL_TPU_CHECKPOINT_SHARDED": "chunk + index checkpoint format "
                                  "instead of one msgpack",
    "EDL_TPU_CKPT_REMOTE": "checkpoint mirror URI (file://, gs://, "
                           "hdfs://)",
    "EDL_TPU_CKPT_VERIFY": "verify chunk crc32s on restore (default on)",
    "EDL_TPU_CKPT_RESTORE_THREADS": "chunk region-read threads on restore",
    "EDL_TPU_PROFILE": "1 = timeline spans to stderr",
    "EDL_TPU_PROFILE_START": "global step the profiler window opens at",
    "EDL_TPU_PROFILE_STEPS": "steps the profiler window spans",
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


def env_int(name: str, default: int = 0) -> int:
    value = os.environ.get(_declared(name), "").strip()
    try:
        return int(value) if value else default
    except ValueError:
        return default


def env_present(name: str) -> bool:
    """Is the declared knob set at all (the 'under the launcher?' probe)."""
    return _declared(name) in os.environ


def env_flag(name: str, default: bool = False) -> bool:
    value = os.environ.get(_declared(name), "").strip().lower()
    if not value:
        return default
    return value in ("1", "true", "yes", "on")


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


def describe(cfg: Any) -> str:
    """Pretty one-per-line dump of a config dataclass."""
    lines = [f"----------- {type(cfg).__name__} -----------"]
    for f in dataclasses.fields(cfg):
        lines.append(f"{f.name}: {getattr(cfg, f.name)}")
    lines.append("------------------------------------------")
    return "\n".join(lines)
