"""Scaler CLI: run the decision plane against a live store and JobServer
(port of ``edl_tpu.scaler.__main__``).

    python -m edl_tpu_torch.scaler --store STOREHOST:2379 --job myjob \
        --server JOBSERVERHOST:8180 --interval 5

    # observe-only (decisions journaled, nothing actuated):
    python -m edl_tpu_torch.scaler --store ... --job myjob --dry-run

Flags are flag-else-env (`EDL_TPU_SCALER_*`; utils/config overlay).
`--policy fairshare --budget N` scales several `--job`s against one
node budget by marginal throughput, store-only (a `--server` holds a
single job's state, so it cannot be combined with several `--job`).

`--service NAME` adds a teacher pool to the loop (`scaler/serving.py`):
its registrar-published latency/queue/utilization rollup drives a
`ServingPolicy` targeting `--slo-p95-ms` (or, under `--policy
fairshare`, the pool joins the trainer jobs in one budget water-fill).
From this CLI the serving plane observes and journals only: the
`TeacherPoolActuator` lives in the process that owns the pool.
"""

from __future__ import annotations

import argparse
import json
import sys

from edl_tpu_torch.scaler.controller import ScalerConfig, ScalerController
from edl_tpu_torch.scaler.policy import FairSharePolicy, ThroughputPolicy
from edl_tpu_torch.utils.config import from_env


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.scaler",
        description="Elastic autoscaler: Collector -> policy -> JobServer")
    parser.add_argument("--store", required=True,
                        help="store endpoint (host:port or redis://...)")
    parser.add_argument("--job", action="append", default=[],
                        dest="jobs", help="job id (repeatable)")
    parser.add_argument("--service", action="append", default=[],
                        dest="services",
                        help="teacher-pool service name to scale by its "
                             "serving SLO (repeatable; observe/journal "
                             "only from this CLI — live actuation runs "
                             "where the pool runs, e.g. elastic_demo "
                             "--serve-scaler or an embedded "
                             "TeacherPoolActuator)")
    parser.add_argument("--slo-p95-ms", type=float, default=None,
                        help="serving SLO target "
                             "(EDL_TPU_SERVE_SLO_P95_MS)")
    parser.add_argument("--registry-root", default="edl_distill",
                        help="service registry root for --service")
    parser.add_argument("--server", default=None,
                        help="JobServer host:port for limits + /resize")
    parser.add_argument("--policy", choices=("throughput", "fairshare"),
                        default="throughput")
    parser.add_argument("--budget", type=int, default=None,
                        help="node budget (fairshare policy)")
    parser.add_argument("--interval", type=float, default=None,
                        help="decision interval s "
                             "(EDL_TPU_SCALER_INTERVAL)")
    parser.add_argument("--cooldown", type=float, default=None,
                        help="per-job seconds between resizes")
    parser.add_argument("--gain-threshold", type=float, default=None,
                        help="hysteresis: min relative marginal gain")
    parser.add_argument("--downtime-s", type=float, default=None,
                        help="measured elastic_downtime_s to amortize "
                             "(EDL_TPU_ELASTIC_DOWNTIME_S)")
    parser.add_argument("--journal", default=None,
                        help="JSON-lines decision journal file")
    parser.add_argument("--dry-run", action="store_true",
                        help="journal decisions without actuating")
    parser.add_argument("--once", action="store_true",
                        help="one tick (skips leader election), then exit")
    args = parser.parse_args(argv)
    if not args.jobs and not args.services:
        parser.error("at least one --job or --service is required")
    if args.policy == "fairshare" and args.budget is None:
        parser.error("--policy fairshare requires --budget")
    if args.server and len(args.jobs) > 1:
        # one JobServer holds ONE job's state: sharing it would read the
        # same min/max/desired for every job and land every /resize on
        # the same JobState, the jobs overwriting each other each tick
        parser.error("--server actuates a single job; with multiple "
                     "--job run store-only (omit --server, decisions "
                     "are journaled) or one scaler per job")

    overrides = {k: v for k, v in (
        ("interval", args.interval), ("cooldown_s", args.cooldown),
        ("gain_threshold", args.gain_threshold),
        ("downtime_s", args.downtime_s)) if v is not None}
    config = from_env(ScalerConfig, **overrides)
    policy_kw = dict(gain_threshold=config.gain_threshold,
                     cooldown_s=config.cooldown_s)
    policy = (FairSharePolicy(args.budget, **policy_kw)
              if args.policy == "fairshare"
              else ThroughputPolicy(**policy_kw))
    serving_policy, serving_config = None, None
    if args.services:
        from edl_tpu_torch.scaler.serving import ServingConfig, ServingPolicy
        serve_overrides = {}
        if args.slo_p95_ms is not None:
            serve_overrides["slo_p95_ms"] = args.slo_p95_ms
        serving_config = from_env(ServingConfig, **serve_overrides)
        if args.policy != "fairshare":
            # fairshare runs both planes itself (decide_mixed); the
            # throughput policy pairs with a dedicated ServingPolicy
            serving_policy = ServingPolicy(serving_config)

    from edl_tpu_torch.coord.redis_store import connect_store
    store = connect_store(args.store)
    controller = ScalerController(
        store, args.jobs, policy, config=config,
        job_server=args.server, dry_run=args.dry_run,
        journal_path=args.journal, elect=not args.once,
        services=args.services, serving_policy=serving_policy,
        serving_config=serving_config,
        registry_root=args.registry_root)
    try:
        if args.once:
            for entry in controller.tick():
                print(json.dumps(entry, sort_keys=True), flush=True)
            return 0
        controller.run()
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        controller.stop()
        store.close()


if __name__ == "__main__":
    sys.exit(main())
