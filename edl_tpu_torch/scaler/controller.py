"""The scaler control loop: Collector snapshots -> policy -> JobServer
(port of ``edl_tpu.scaler.controller``).

A leader-elected controller scrapes each job's `Collector` snapshot,
digests it into a `JobView` (aggregate fresh throughput, live world
size, generation), asks the policy, and actuates accepted proposals
through the JobServer's ``/resize`` endpoint, or only journals them
under ``--dry-run``.

Exactly one scaler acts: controllers campaign on a lease-backed
leadership key (`coord/lock.LeaderElection`); a follower's ticks are
no-ops, and on takeover the new leader replays the decision journal's
tail to re-learn the throughput models, resume the cooldown clocks and
reseed the measured downtimes (so a leader crash never causes a double
resize).

The downtime a grow must amortize is measured, not configured: every
actuated resize arms a probe that closes on the first fresh utilization
at the new world. When the trainers acked the resize into the migration
plane (``/<job>/migration/ack/``, written at an adopted or restored
generation's first step) the probe takes the worst acked ``downtime_s``,
the survivors' own training gap; else the actuation-to-fresh interval.
The configured ``downtime_s`` is only the fallback before the first
measurement.

The serving plane rides the same election and journal (``services=`` /
``serving_policy=`` / ``serving_actuate=``): teacher pools are digested
from `Collector.service_rollup` into ServingViews, decided by a
`ServingPolicy` (or jointly with the trainers by a budget policy
exposing ``decide_mixed``, FairShare), and actuated through a
`TeacherPoolActuator`; their journal entries carry ``kind: "serving"``
and ``service`` so each policy's replay finds its own.

Every decision, hold or resize, with its inputs and reason, is one JSON
journal entry, appended both as a JSON line to ``journal_path`` and under
the store prefix ``/{scope}/scaler/journal/`` (bounded retention; what a
successor replays). For the same observations the entries are the JAX
package's.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable

from edl_tpu_torch.coord.collector import Collector
from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace
from edl_tpu_torch.scaler.policy import JobView, Proposal, ScalingPolicy
from edl_tpu_torch.utils.config import field
from edl_tpu_torch.utils.exceptions import EdlStoreError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.scaler.controller")


@dataclass
class ScalerConfig:
    # the decision-pass FALLBACK period: with store watches the
    # controller ticks when fresh utilization actually arrives (floor =
    # min_tick_s), so reaction latency is event latency, not interval/2
    interval: float = field(5.0, env="EDL_TPU_SCALER_INTERVAL")
    # event-driven tick floor: a busy job publishing utilization every
    # second must not turn the scaler into a hot loop
    min_tick_s: float = field(1.0, env="EDL_TPU_SCALER_MIN_TICK")
    cooldown_s: float = field(30.0, env="EDL_TPU_SCALER_COOLDOWN")
    gain_threshold: float = field(0.05, env="EDL_TPU_SCALER_GAIN")
    # the resize price the policy amortizes every grow against — the
    # FALLBACK only: the controller measures the real downtime of every
    # resize it actuates (actuation -> first fresh utilization at the
    # new world) and feeds the per-job EWMA into the policy instead, so
    # a faster resize path (p2p live migration) loosens the grow gate
    # without anyone re-tuning a constant
    downtime_s: float = field(1.5, env="EDL_TPU_ELASTIC_DOWNTIME_S")
    # optional measurement artifact (a JSON file) seeding the fallback:
    # extras.elastic_downtime_p2p_s preferred over elastic_downtime_s
    downtime_artifact: str | None = field(None,
                                          env="EDL_TPU_DOWNTIME_ARTIFACT")
    # utilization docs older than this are ignored (published_unix)
    staleness_s: float = field(15.0, env="EDL_TPU_SCALER_STALENESS")
    min_nodes: int = field(1, env="EDL_TPU_SCALER_MIN_NODES")
    max_nodes: int = field(8, env="EDL_TPU_SCALER_MAX_NODES")
    journal_keep: int = 512
    leader_ttl: float = field(10.0, env="EDL_TPU_SCALER_LEADER_TTL")


def journal_prefix(scope: str) -> str:
    return f"/{scope}/scaler/journal/"


def leader_key(scope: str) -> str:
    return f"/{scope}/scaler/leader"


def artifact_downtime(path: str) -> float | None:
    """Read a measured elastic downtime out of a JSON artifact
    (``extras.elastic_downtime_p2p_s`` preferred — the live-migration
    number — else ``elastic_downtime_s``). None when unreadable."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    extras = doc.get("extras", doc) or {}
    for key in ("elastic_downtime_p2p_s", "elastic_downtime_s"):
        val = extras.get(key)
        if val is not None:
            try:
                return float(val)
            except (TypeError, ValueError):
                continue
    return None


class DecisionJournal:
    """Append-only decision log: store-backed tail + local JSON lines.

    The store half is the handoff medium (a successor leader replays
    it); the file half is the operator's observability surface. Entries
    are sequence-numbered store keys so lexicographic prefix order IS
    replay order; retention keeps the newest `keep` entries.
    """

    def __init__(self, store: Store | None, scope: str, *,
                 path: str | None = None, keep: int = 512):
        self.store = store
        self.scope = scope
        self.path = path
        self.keep = keep
        self._fh = open(path, "a", encoding="utf-8") if path else None
        self._seq = self._last_seq() + 1

    def _last_seq(self) -> int:
        if self.store is None:
            return -1
        records, _ = self.store.get_prefix(journal_prefix(self.scope))
        if not records:
            return -1
        return int(records[-1].key.rsplit("/", 1)[-1])

    def append(self, entry: dict) -> dict:
        entry = dict(entry, seq=self._seq)
        line = json.dumps(entry, sort_keys=True)
        # File first: the local JSONL is the durable audit trail (the
        # demos' journal<->resize_log audits read it), so a
        # store outage between an actuated resize and its journal entry
        # must not lose the record. The store copy is the takeover
        # leader's replay source — best-effort; a missed entry costs a
        # cooldown resume at worst and heals on the next append.
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.store is not None:
            prefix = journal_prefix(self.scope)
            try:
                self.store.put(f"{prefix}{self._seq:010d}", line)
                drop = self._seq - self.keep
                if drop >= 0:
                    self.store.delete(f"{prefix}{drop:010d}")
            except EdlStoreError as exc:
                log.warning("journal entry %d not mirrored to the store "
                            "(%s) — file journal has it", self._seq, exc)
        self._seq += 1
        return entry

    def tail(self, n: int | None = None) -> list[dict]:
        if self.store is None:
            return []
        records, _ = self.store.get_prefix(journal_prefix(self.scope))
        if n is not None:
            records = records[-n:]
        out = []
        for rec in records:
            try:
                out.append(json.loads(rec.value))
            except json.JSONDecodeError:
                continue
        return out

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ScalerController:
    """Scrape -> decide -> actuate -> journal, while leader.

    Args:
      store: coordination store (same one the job runs on).
      jobs: job ids to scale.
      policy: a `ScalingPolicy`.
      job_server: JobServer endpoint ("host:port") for min/max/desired
        and `/resize` actuation; None = store-only (observe + journal).
      actuate: override actuation, e.g. a local `JobState.resize` when
        the controller runs inside the JobServer process. Signature
        ``(job_id, desired) -> snapshot dict``.
      dry_run: never actuate; decisions are journaled with action
        "dry-run".
      clock: injectable time source (tests); defaults to time.time so
        journal timestamps and `published_unix` share one scale.
    """

    def __init__(self, store: Store, jobs: list[str],
                 policy: ScalingPolicy, *,
                 config: ScalerConfig | None = None,
                 job_server: str | None = None,
                 actuate: Callable[[str, int], dict] | None = None,
                 dry_run: bool = False,
                 journal_path: str | None = None,
                 scope: str | None = None,
                 owner: str | None = None,
                 elect: bool = True,
                 services: list[str] | tuple[str, ...] = (),
                 serving_policy=None,
                 serving_actuate: Callable[[str, int], dict] | None = None,
                 serving_config=None,
                 registry_root: str = "edl_distill",
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.jobs = list(jobs)
        self.policy = policy
        self.config = config or ScalerConfig()
        if job_server is not None and len(self.jobs) > 1:
            # one JobServer holds ONE job's state: sharing it would read
            # the same min/max/desired for every job and land every
            # /resize on the same JobState (jobs overwriting each other)
            raise ValueError("job_server actuates a single job; run "
                             "store-only or one controller per job")
        self.job_server = job_server
        self._actuate_fn = actuate
        self.dry_run = dry_run
        # the serving plane, scaled side by side with the trainer jobs
        # under the SAME leader election and journal: either its own
        # ServingPolicy (serving_policy=...) or jointly with the
        # trainers by a budget policy exposing decide_mixed (FairShare)
        self.services = list(services)
        self.serving_policy = serving_policy
        self._serving_actuate = serving_actuate
        self.serving_config = serving_config
        self.registry_root = registry_root
        self._service_collector = None
        self._serving_desired: dict[str, int] = {}
        if self.services:
            if self.serving_policy is None \
                    and not hasattr(self.policy, "decide_mixed"):
                raise ValueError(
                    "services need a serving_policy (ServingPolicy) or "
                    "a budget policy with decide_mixed (FairSharePolicy)")
            if self.serving_config is None:
                from edl_tpu_torch.scaler.serving import ServingConfig
                from edl_tpu_torch.utils.config import from_env
                self.serving_config = from_env(ServingConfig)
            self._service_collector = Collector(
                store, services=tuple(self.services),
                registry_root=registry_root)
        self.scope = scope or (self.jobs[0] if len(self.jobs) == 1
                               else (self.services[0]
                                     if not self.jobs
                                     and len(self.services) == 1
                                     else "cluster"))
        self.owner = owner or f"{socket.gethostname()}-{os.getpid()}"
        self.clock = clock
        self.journal = DecisionJournal(store, self.scope,
                                       path=journal_path,
                                       keep=self.config.journal_keep)
        self._collectors = {j: Collector(store, job_id=j)
                            for j in self.jobs}
        # Measured-downtime feedback: resizes this controller actuated,
        # awaiting their first fresh utilization at the new world — the
        # close of a probe updates the per-job EWMA that replaces the
        # configured downtime constant in every subsequent JobView
        # (quantized to the tick interval, so it over- rather than
        # under-charges the amortization gate).
        self._downtime: dict[str, float] = {}
        # the per-ACTION ladder: a shrink the survivors adopt in place
        # is far cheaper than a grow's reform, so one blended EWMA
        # systematically over-charges shrinks. Keyed
        # (job, kind); the blended EWMA above stays the fallback for
        # kinds never yet measured.
        self._downtime_kind: dict[tuple[str, str], float] = {}
        self._resize_pending: dict[str, tuple[float, int, str]] = {}
        self._observed_downtime: dict[str, float] = {}  # this tick's
        self._observed_kind: dict[str, str] = {}        # this tick's
        # where each job's last measured downtime came from: "ack" (the
        # trainers' own gap) or "probe" (actuation -> first fresh util)
        self.downtime_source: dict[str, str] = {}
        self._default_downtime = self.config.downtime_s
        if self.config.downtime_artifact:
            seeded = artifact_downtime(self.config.downtime_artifact)
            if seeded is not None:
                self._default_downtime = seeded
                log.info("downtime fallback seeded from %s: %.2fs",
                         self.config.downtime_artifact, seeded)
        self.election = None
        if elect:
            from edl_tpu_torch.coord.lock import LeaderElection
            self.election = LeaderElection(
                store, leader_key(self.scope), self.owner,
                ttl=self.config.leader_ttl)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._restored = False
        # event-driven pacing: fresh utilization under /{job}/util/
        # kicks the next tick instead of waiting out the interval
        self._kick = threading.Event()
        self._util_watches: list = []
        # decision-plane counters; the journal stays the audit trail,
        # the obs registry serves the same tallies as gauges
        self._n_ticks = 0
        self._n_resizes = 0
        self._obs = obs_metrics.register_stats("scaler", self.stats)

    def stats(self) -> dict:
        """Controller counters as a dict view (obs registry source)."""
        return {"is_leader": self.is_leader(),
                "ticks": self._n_ticks,
                "resizes_actuated": self._n_resizes,
                "jobs": len(self.jobs),
                "services": len(self.services),
                "resize_pending": len(self._resize_pending),
                "journal_seq": self.journal._seq}

    # -- observation --------------------------------------------------------

    def _job_limits(self, job_id: str) -> tuple[int, int, int | None]:
        """(min, max, desired) from the JobServer, else config defaults."""
        if self.job_server is not None:
            from edl_tpu_torch.collective.job_server import get_job
            try:
                doc = get_job(self.job_server)
                return (int(doc["min_nodes"]), int(doc["max_nodes"]),
                        int(doc["desired_nodes"]))
            except (OSError, KeyError, ValueError) as exc:
                log.warning("job server unreachable (%s); using config "
                            "limits", exc)
        return self.config.min_nodes, self.config.max_nodes, None

    def observe(self, job_id: str, now: float | None = None) -> JobView:
        """Digest one Collector snapshot into the policy's JobView."""
        now = self.clock() if now is None else now
        snap = self._collectors[job_id].snapshot()
        job = snap.get("job") or {}
        world = int(job.get("world_size") or 0)
        lo, hi, desired = self._job_limits(job_id)
        throughput, fresh_pods = 0.0, 0
        for pod in job.get("pods") or []:
            util = pod.get("utilization")
            if not isinstance(util, dict):
                continue
            published = util.get("published_unix", util.get("ts"))
            if published is None \
                    or now - float(published) > self.config.staleness_s:
                continue  # stale: a dead pod's lease hasn't expired yet
            # both sides are POD counts: the publisher's world_size is
            # the elastic world (EDL_TPU_WORLD_SIZE), `world` is
            # Cluster.world_size — never the per-pod device count
            pod_world = util.get("world_size")
            if pod_world is not None and world and int(pod_world) != world:
                continue  # pre-resize record: wrong allocation's rate
            throughput += float(util.get("examples_per_sec", 0.0))
            fresh_pods += 1
        fresh = bool(fresh_pods) and world > 0
        self._note_downtime(job_id, world, fresh, now)
        # the view's downtime is the GROW price (a reform): that is the
        # action the amortization gate actually guards, and the most
        # expensive one — pricing shrinks with it only over-charges
        downtime = self._downtime_kind.get(
            (job_id, "reform"),
            self._downtime.get(job_id, self._default_downtime))
        return JobView(job_id, world, throughput, lo, hi,
                       downtime,
                       generation=job.get("generation"),
                       desired=desired,
                       fresh=fresh)

    def _note_downtime(self, job_id: str, world: int, fresh: bool,
                       now: float) -> None:
        """Close an open downtime probe: the first FRESH utilization at
        the resize's target world stamps the resize's measured downtime
        (the worst gap the trainers acked since the actuation, else
        `actuation -> now`) and folds it into the per-job EWMA the policy
        amortizes against."""
        pending = self._resize_pending.get(job_id)
        if pending is None or not fresh:
            return
        ts, target, kind = pending
        if world != target:
            return
        acked = self._acked_downtime(job_id, ts)
        measured = acked if acked is not None else max(0.0, now - ts)
        self.downtime_source[job_id] = "ack" if acked is not None \
            else "probe"
        prev = self._downtime.get(job_id)
        self._downtime[job_id] = (measured if prev is None
                                  else 0.5 * prev + 0.5 * measured)
        kprev = self._downtime_kind.get((job_id, kind))
        self._downtime_kind[(job_id, kind)] = (
            measured if kprev is None else 0.5 * kprev + 0.5 * measured)
        self._observed_downtime[job_id] = measured
        self._observed_kind[job_id] = kind
        del self._resize_pending[job_id]
        log.info("measured elastic downtime for %s: %.2fs (%s ema "
                 "%.2fs)", job_id, measured, kind,
                 self._downtime_kind[(job_id, kind)])

    def _acked_downtime(self, job_id: str, since: float) -> float | None:
        """The worst ``downtime_s`` a trainer of ``job_id`` acked into the
        migration plane after ``since`` (an adopted generation's gap from
        the adoption to its first step), or None when no ack carries
        one (a stop-resume resize, or no migration plane)."""
        from edl_tpu_torch.collective.migration import ack_prefix
        try:
            records, _ = self.store.get_prefix(ack_prefix(job_id))
        except EdlStoreError:
            return None
        gaps = []
        for rec in records:
            try:
                doc = json.loads(rec.value)
                if float(doc["ts"]) > since \
                        and doc.get("downtime_s") is not None:
                    gaps.append(float(doc["downtime_s"]))
            except (ValueError, TypeError, KeyError):
                continue
        return max(gaps) if gaps else None

    def observe_service(self, service: str):
        """Digest one `Collector.service_rollup` into the serving
        policy's ServingView. ``desired`` is the last actuated target
        (resize-in-flight detection: the actuator spawns/drains
        asynchronously, so the registry trails the decision)."""
        from edl_tpu_torch.scaler.serving import ServingView
        roll = self._service_collector.service_rollup(service)
        cfg = self.serving_config
        n = roll["n_teachers"]
        desired = self._serving_desired.get(service)
        if desired is not None and desired == n:
            # the pool caught up with the target: back to steady state
            del self._serving_desired[service]
            desired = None
        return ServingView(
            service, n,
            rows_per_sec=roll["rows_per_sec"],
            util=roll["util"] if roll["util"] is not None else 0.0,
            queue_depth=roll["queue_depth"],
            latency_ms_p50=roll["latency_ms_p50"],
            latency_ms_p95=roll["latency_ms_p95"],
            shed_per_sec=roll.get("shed_per_sec", 0.0),
            queue_depth_by_class=roll.get("queue_depth_by_class") or None,
            latency_ms_p95_by_class=(roll.get("latency_ms_p95_by_class")
                                     or None),
            draining=roll.get("draining", 0),
            slo_p95_ms=cfg.slo_p95_ms,
            min_teachers=cfg.min_teachers,
            max_teachers=cfg.max_teachers,
            desired=desired,
            fresh=bool(n and roll["reporting"]))

    # -- actuation ----------------------------------------------------------

    def _actuate(self, job_id: str, desired: int) -> dict:
        if self._actuate_fn is not None:
            return self._actuate_fn(job_id, desired)
        if self.job_server is None:
            raise RuntimeError("no actuation path (job_server/actuate)")
        from edl_tpu_torch.collective.job_server import request_resize
        return request_resize(self.job_server, desired)

    # -- the loop -----------------------------------------------------------

    def is_leader(self) -> bool:
        return self.election is None or self.election.is_leader()

    def _restore_from_journal(self) -> None:
        entries = self.journal.tail()
        if entries:
            self.policy.restore(entries)
            if self.serving_policy is not None:
                self.serving_policy.restore(entries)
            # replay measured downtimes too: a takeover leader must not
            # fall back to the configured constant when the journal
            # already recorded how fast this job really resizes
            for e in entries:
                job, m = e.get("job_id"), e.get("observed_downtime_s")
                if job and m is not None:
                    prev = self._downtime.get(job)
                    self._downtime[job] = (float(m) if prev is None
                                           else 0.5 * prev + 0.5 * float(m))
                    kind = e.get("downtime_kind")
                    if kind:
                        kprev = self._downtime_kind.get((job, kind))
                        self._downtime_kind[(job, kind)] = (
                            float(m) if kprev is None
                            else 0.5 * kprev + 0.5 * float(m))
            log.info("restored %d journal entries (scope %s)",
                     len(entries), self.scope)
        self._restored = True

    def tick(self, now: float | None = None) -> list[dict]:
        """One decision pass; returns the journal entries it wrote."""
        if not self.is_leader():
            return []
        if not self._restored:
            self._restore_from_journal()
        now = self.clock() if now is None else now
        self._n_ticks += 1
        views = [self.observe(j, now) for j in self.jobs]
        serving_views = [self.observe_service(s) for s in self.services]
        if serving_views and self.serving_policy is None:
            # one budget policy governs both planes (FairShare mixed)
            proposals, serving_props = self.policy.decide_mixed(
                views, serving_views, now)
        else:
            proposals = self.policy.decide(views, now) if views else []
            serving_props = (self.serving_policy.decide(serving_views, now)
                             if serving_views else [])
        entries = []
        for view, prop in zip(views, proposals):
            entries.append(self._apply(view, prop, now))
        for view, prop in zip(serving_views, serving_props):
            entries.append(self._apply_serving(view, prop, now))
        return entries

    def _apply(self, view: JobView, prop: Proposal, now: float) -> dict:
        action, reason = "hold", prop.reason
        applied = None
        if prop.is_resize:
            if self.dry_run:
                action = "dry-run"
            else:
                try:
                    # trace root of the resize: the /resize actuation,
                    # the epoch publication, the surviving trainers'
                    # adoptions and the peer restores all parent onto
                    # this span (obs/trace.py propagation contract)
                    with trace.span("scaler.decide",
                                    attrs={"job": view.job_id,
                                           "from": prop.current,
                                           "to": prop.desired,
                                           "reason": prop.reason}):
                        resp = self._actuate(view.job_id, prop.desired)
                    applied = int(resp.get("desired_nodes", prop.desired))
                    action = "resize"
                    self._n_resizes += 1
                    if resp.get("clamped"):
                        reason += "; clamped by job server"
                    self.policy.notify_resized(view.job_id, applied, now)
                    # arm the downtime probe (closed by _note_downtime
                    # on the first fresh record at the new world; a
                    # follow-up resize re-arms it at the newer target).
                    # The kind: a shrink is an in-place adopt, a grow a
                    # reform.
                    kind = ("adopt" if applied < prop.current
                            else "reform")
                    self._resize_pending[view.job_id] = (now, applied,
                                                         kind)
                    log.info("resize %s: %d -> %d (%s)", view.job_id,
                             prop.current, applied, prop.reason)
                except Exception as exc:  # noqa: BLE001 — journal it;
                    # a dead job server must not kill the control loop
                    action, reason = "error", f"{prop.reason}; {exc}"
        return self.journal.append({
            "ts": now, "job_id": view.job_id, "leader": self.owner,
            "world_size": view.world_size,
            "throughput": round(view.throughput, 3),
            "generation": view.generation, "fresh": view.fresh,
            "current": prop.current, "desired": prop.desired,
            "applied": applied, "action": action, "reason": reason,
            # the downtime charge this decision amortized against, and
            # (when a probe closed this tick) the freshly measured value
            "downtime_s": round(view.downtime_s, 3),
            "observed_downtime_s": (
                round(self._observed_downtime.pop(view.job_id), 3)
                if view.job_id in self._observed_downtime else None),
            "downtime_kind": self._observed_kind.pop(view.job_id, None),
            "predicted_gain": (round(prop.predicted_gain, 3)
                               if prop.predicted_gain is not None
                               else None)})

    def _apply_serving(self, view, prop: Proposal, now: float) -> dict:
        """Actuate + journal one serving-plane proposal. Entries carry
        ``kind: "serving"`` + ``service`` (no ``job_id``), so trainer
        policies skip them on replay and `ServingPolicy.restore` finds
        its own."""
        action, reason = "hold", prop.reason
        applied = None
        if prop.is_resize:
            if self.dry_run:
                action = "dry-run"
            elif self._serving_actuate is None:
                # observe-only deployments journal what they WOULD do
                action, reason = "error", (f"{prop.reason}; no serving "
                                           "actuation path")
            else:
                try:
                    resp = self._serving_actuate(view.service, prop.desired)
                    applied = int(resp.get("desired_teachers",
                                           prop.desired))
                    action = "resize"
                    if resp.get("clamped"):
                        reason += "; clamped by actuator"
                    self._serving_desired[view.service] = applied
                    pol = self.serving_policy or self.policy
                    pol.notify_resized(view.service, applied, now)
                    log.info("resize pool %s: %d -> %d (%s)", view.service,
                             prop.current, applied, prop.reason)
                except Exception as exc:  # noqa: BLE001 — journal it; a
                    # dead actuator must not kill the control loop
                    action, reason = "error", f"{prop.reason}; {exc}"
        return self.journal.append({
            "ts": now, "kind": "serving", "service": view.service,
            "leader": self.owner, "n_teachers": view.n_teachers,
            "rows_per_sec": round(view.rows_per_sec, 2),
            "util": round(view.util, 4),
            "queue_depth": view.queue_depth,
            "latency_ms_p95": view.latency_ms_p95,
            "shed_per_sec": round(view.shed_per_sec, 2),
            "slo_p95_ms": view.slo_p95_ms, "fresh": view.fresh,
            "current": prop.current, "desired": prop.desired,
            "applied": applied, "action": action, "reason": reason})

    # -- event-driven pacing -------------------------------------------------

    def _start_util_watches(self) -> None:
        """Subscribe to each job's utilization prefix: a fresh record
        kicks the next decision pass so reaction latency is event
        latency (floored at min_tick_s), with `interval` demoted to the
        no-traffic fallback. Unavailable/disabled watches leave the
        original fixed-interval loop untouched."""
        from edl_tpu_torch.coord.collector import util_prefix
        from edl_tpu_torch.coord.registry import ServiceRegistry
        from edl_tpu_torch.coord.store import try_watch
        prefixes = [(job, util_prefix(job)) for job in self.jobs]
        if self.services:
            # registrar stats updates land on the service registry
            # prefix: the serving plane ticks at event latency too
            registry = ServiceRegistry(self.store, root=self.registry_root)
            prefixes += [(svc, registry.service_prefix(svc))
                         for svc in self.services]
        for name, prefix in prefixes:
            watch = try_watch(self.store, prefix)
            if watch is None:
                continue
            thread = threading.Thread(target=self._pump_kicks, args=(watch,),
                                      daemon=True,
                                      name=f"edl-scaler-watch-{name}")
            thread.start()
            self._util_watches.append((watch, thread))
        if self._util_watches:
            log.info("scaler ticking on utilization events (%d watches; "
                     "fallback every %.1fs)", len(self._util_watches),
                     self.config.interval)

    def _pump_kicks(self, watch) -> None:
        while not self._stop.is_set():
            batch = watch.get(timeout=5.0)
            if batch is None:
                if watch.cancelled:
                    return
                continue
            if batch.events or batch.compacted:
                self._kick.set()

    def _stop_util_watches(self) -> None:
        for watch, _ in self._util_watches:
            watch.cancel()
        for _, thread in self._util_watches:
            thread.join(timeout=2.0)
        self._util_watches = []

    def run(self) -> None:
        """Campaign, then tick on fresh utilization (or every interval
        as the fallback) while leader (blocking)."""
        self._start_util_watches()
        try:
            while not self._stop.is_set():
                if self.election is not None \
                        and not self.election.is_leader():
                    try:
                        won = self.election.campaign(timeout=1.0)
                    except EdlStoreError as exc:
                        # store outage mid-campaign (leader failover,
                        # partition): the scaler must outlive it and
                        # re-campaign, not die silently
                        log.warning("scaler campaign failed: %s", exc)
                        if self._stop.wait(timeout=1.0):
                            break
                        continue
                    if not won:
                        continue
                    log.info("scaler leadership acquired (%s)", self.owner)
                    self._restored = False  # re-replay on every takeover
                self._kick.clear()
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — scrape failures are
                    log.exception("scaler tick failed")  # transient
                # kicks that landed during the tick are still set here
                if self._kick.wait(timeout=self.config.interval) \
                        and not self._stop.is_set():
                    self._stop.wait(self.config.min_tick_s)
        finally:
            self._stop_util_watches()

    def start(self) -> "ScalerController":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="edl-scaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()  # wake the fallback wait immediately
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.election is not None:
            self.election.resign()
        self.journal.close()
        obs_metrics.unregister(self._obs)
