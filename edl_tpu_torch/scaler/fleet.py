"""Fleet simulator: hundreds of jobs and pools under one node budget
(copy of ``edl_tpu.scaler.fleet``).

`SimCluster` proves a policy on a handful of clean curves; this module
scales the same deterministic substrate to fleet shape:

* hundreds of `SimJob` trainers AND `SimServingPool`s composed from
  seeded arrival/departure traces (`FleetTrace.generate`), each job
  with a priority tier (``prod`` / ``batch`` / ``best-effort``) and a
  GANG constraint: a job runs at multiples of its gang size between
  min and max nodes, or not at all;
* per-action downtime charged from a `DowntimeLadder` instead of one
  blended constant: shrinks adopt, grows reform, forced evictions
  stop-resume. The default ladder (``MEASURED``) carries the JAX
  package's default values unchanged, so a tournament's rows and its
  sha256 fingerprint equal that package's; a card's own resize
  downtimes enter through ``--ladder`` (``DowntimeLadder.from_artifact``).
  A LEGACY ladder (everything costs the disk stop-resume) is kept so
  policy tournaments can show that cheap reforms change which policies
  win;
* SPOT capacity: a seeded fraction of the fleet's nodes is revocable.
  Preemptions arrive as NOTICES (capacity drop + deadline, the cloud
  spot contract); a policy that shrinks the fleet under the post-
  deadline capacity before the deadline pays only cheap scheduled
  shrinks, while a notice-blind policy is force-evicted at the
  deadline: stop-resume downtime plus the UNSEALED progress since the
  job's last checkpoint seal, the price the chaos ``preempt`` fault
  audits (chaos/audit.py I7).

Everything is virtual-clock + `random.Random(seed)`: no wall clock, no
global RNG (the ``sim-determinism`` edl-lint row covers this file), so
a 200-job tournament is exactly reproducible and sha256-pinnable.

Pure stdlib, torch/numpy-free (scaler layer row in layers.toml; the
selftest asserts it). CLI: ``python -m edl_tpu_torch.scaler.fleet
selftest|tournament [--ladder F] [--jobs N] [--pools N] [--ticks N]``.
"""

from __future__ import annotations

import hashlib
import json
import random
import sys
from dataclasses import dataclass, field

from edl_tpu_torch.scaler.policy import JobView, Proposal
from edl_tpu_torch.scaler.simulator import (ArrivalTrace, ScalingCurve, SimJob,
                                            SimServingPool, burst, concave,
                                            knee, linear, steady, step)
from edl_tpu_torch.utils.config import env_float, env_int

TIERS = ("prod", "batch", "best-effort")
TIER_RANK = {t: i for i, t in enumerate(TIERS)}

# The JAX package's default ladder values, kept unchanged: the pinned
# tournament fingerprint depends on them. They are that package's
# defaults, not this port's measurements; an artifact (``--ladder``)
# overrides each field it carries.
MEASURED_ADOPT_S = 0.061
MEASURED_REFORM_S = 0.138
MEASURED_STOP_RESUME_S = 1.2


@dataclass(frozen=True)
class DowntimeLadder:
    """Seconds of zero progress per resize ACTION KIND.

    The classification mirrors the live stack: a shrink keeps every
    survivor's device set unchanged (p2p adoption), a grow re-forms the
    mesh in place with peer restore, and only a forced eviction — or a
    world that lost its state — pays the full disk stop-resume.
    """

    name: str = "measured"
    adopt_s: float = MEASURED_ADOPT_S
    reform_s: float = MEASURED_REFORM_S
    stop_resume_s: float = MEASURED_STOP_RESUME_S

    def cost(self, kind: str) -> float:
        return {"adopt": self.adopt_s, "reform": self.reform_s,
                "stop-resume": self.stop_resume_s}[kind]

    def classify(self, current: int, desired: int) -> str:
        """Action kind of a SCHEDULED resize (forced evictions are
        always ``stop-resume`` and never come through here)."""
        return "adopt" if desired < current else "reform"

    @classmethod
    def from_artifact(cls, path: str) -> "DowntimeLadder | None":
        """Build a ladder from an artifact's measured downtimes
        (``elastic_downtime_p2p_s`` -> adopt,
        ``elastic_downtime_multihost_s`` -> reform,
        ``elastic_downtime_s`` -> stop-resume; missing keys keep the
        defaults). None when the file is unreadable."""
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        extras = doc.get("extras", doc) or {}

        def _get(key: str, default: float) -> float:
            try:
                val = extras.get(key)
                return float(val) if val is not None else default
            except (TypeError, ValueError):
                return default

        return cls(name=f"artifact:{path}",
                   adopt_s=_get("elastic_downtime_p2p_s",
                                MEASURED_ADOPT_S),
                   reform_s=_get("elastic_downtime_multihost_s",
                                 MEASURED_REFORM_S),
                   stop_resume_s=_get("elastic_downtime_s",
                                      MEASURED_STOP_RESUME_S))


# The default ladder (its name, "measured", is the JAX package's and is
# in every row, so in the fingerprint).
MEASURED = DowntimeLadder("measured")
# Every resize a disk stop-resume. Tournaments run both ladders because
# the POLICY ranking depends on the ladder: preemptive revocation only
# pays when a scheduled shrink is cheap.
LEGACY = DowntimeLadder("legacy", MEASURED_STOP_RESUME_S,
                        MEASURED_STOP_RESUME_S, MEASURED_STOP_RESUME_S)


@dataclass
class FleetJobView(JobView):
    """JobView + the fleet-scheduling facts a preemptive policy needs.

    ``downtime_s`` carries the ladder's GROW charge (reform) — grows
    are what the amortization gate prices; shrinks ride the cheaper
    adopt path and revocation decisions read the ladder directly."""

    tier: str = "batch"
    gang: int = 1


@dataclass(frozen=True)
class FleetJobSpec:
    job_id: str
    curve: ScalingCurve
    tier: str = "batch"
    gang: int = 1
    min_nodes: int = 1
    max_nodes: int = 8
    arrive_tick: int = 0
    depart_tick: int | None = None
    noise: float = 0.01


@dataclass(frozen=True)
class FleetPoolSpec:
    service: str
    trace: ArrivalTrace
    tenant: str = "default"
    slo_p95_ms: float = 250.0
    teacher_rate: float = 250.0
    teachers: int = 1
    min_teachers: int = 1
    max_teachers: int = 8
    arrive_tick: int = 0


@dataclass(frozen=True)
class Preemption:
    """One spot revocation: ``nodes`` leave capacity at
    ``deadline_tick``; the notice is visible from ``notice_tick``; a
    replacement grant restores the capacity at ``restore_tick``."""

    notice_tick: int
    deadline_tick: int
    nodes: int
    restore_tick: int


@dataclass
class FleetTrace:
    """A seeded fleet scenario: who arrives when, on what capacity."""

    name: str
    seed: int
    ticks: int
    jobs: list[FleetJobSpec]
    pools: list[FleetPoolSpec]
    reserved_nodes: int
    spot_nodes: int
    preemptions: list[Preemption] = field(default_factory=list)

    @property
    def total_nodes(self) -> int:
        return self.reserved_nodes + self.spot_nodes

    @property
    def spot_fraction(self) -> float:
        total = self.total_nodes
        return self.spot_nodes / total if total else 0.0

    @classmethod
    def generate(cls, name: str, seed: int, *, n_jobs: int = 180,
                 n_pools: int = 24, ticks: int = 240,
                 spot_fraction: float = 0.0, churn: float = 0.0,
                 noise: float = 0.01, pool_surge: bool = True,
                 preempt_every: int = 40,
                 notice_ticks: int = 2) -> "FleetTrace":
        """Seeded fleet scenario. ``churn`` is the fraction of jobs
        that arrive late / depart early; ``noise`` is the per-job
        multiplicative sigma on observed rates; ``spot_fraction`` of
        the node budget is revocable with a seeded preemption every
        ``preempt_every`` ticks (notice ``notice_ticks`` ahead of the
        deadline, replacement grant 4 ticks after it)."""
        rng = random.Random(seed)
        jobs: list[FleetJobSpec] = []
        for i in range(n_jobs):
            kind = rng.choice(("concave", "knee", "linear", "flat-ish"))
            r1 = rng.uniform(40.0, 160.0)
            if kind == "concave":
                curve = concave(r1, rng.uniform(0.35, 0.8))
            elif kind == "knee":
                curve = knee(r1, rng.randint(2, 6))
            elif kind == "linear":
                curve = linear(r1)
            else:
                curve = concave(r1, 0.15)  # near-flat
            tier = rng.choices(TIERS, weights=(1, 5, 3))[0]
            gang = rng.choice((1, 1, 2, 2, 4))
            min_nodes = gang
            max_nodes = gang * rng.randint(2, max(2, 8 // gang))
            arrive, depart = 0, None
            if rng.random() < churn:
                arrive = rng.randint(1, max(1, ticks // 3))
                if rng.random() < 0.5:
                    depart = rng.randint(arrive + ticks // 4, ticks)
            jobs.append(FleetJobSpec(f"j{i:03d}", curve, tier, gang,
                                     min_nodes, max_nodes, arrive,
                                     depart, noise=noise))
        pools: list[FleetPoolSpec] = []
        for i in range(n_pools):
            lam = rng.uniform(120.0, 260.0)
            if pool_surge and rng.random() < 0.5:
                at = rng.randint(ticks // 4, 3 * ticks // 4)
                trace = (step(lam, rng.uniform(2.5, 4.0), at)
                         if rng.random() < 0.5 else
                         burst(lam, rng.uniform(2.5, 4.0), at,
                               rng.randint(20, 40)))
            else:
                trace = steady(lam)
            pools.append(FleetPoolSpec(
                f"svc{i:02d}", trace, tenant=f"tenant{i % 6}",
                teachers=1, max_teachers=8,
                arrive_tick=0 if i < n_pools - n_pools // 4
                else rng.randint(1, ticks // 4)))
        # size the budget so the fleet is genuinely contended: roughly
        # half of the summed max demand
        demand = (sum(j.max_nodes for j in jobs)
                  + sum(p.max_teachers for p in pools))
        total = max(8, int(demand * 0.45))
        spot = int(total * spot_fraction)
        preemptions: list[Preemption] = []
        if spot:
            t = preempt_every
            while t + notice_ticks < ticks - 8:
                k = max(1, int(spot * rng.uniform(0.2, 0.5)))
                preemptions.append(Preemption(
                    notice_tick=t, deadline_tick=t + notice_ticks,
                    nodes=k, restore_tick=t + notice_ticks + 4))
                t += preempt_every + rng.randint(-4, 4)
        return cls(name, seed, ticks, jobs, pools,
                   reserved_nodes=total - spot, spot_nodes=spot,
                   preemptions=preemptions)


def trace_menu(*, n_jobs: int = 180, n_pools: int = 24,
               ticks: int = 240,
               spot_fraction: float = 0.5) -> list[FleetTrace]:
    """The tournament's trace grid — four fleet regimes, each at
    >= ``n_jobs + n_pools`` concurrent workloads; ``spot_fraction`` of
    ``spot-heavy``'s node budget is revocable spot capacity (the CLI
    reads it from EDL_TPU_FLEET_SPOT_FRACTION). ``noisy`` sits at
    the rebalance-profitability boundary: raw-observation chasing
    (GreedyRebalancePolicy) wins it under the default ladder's cheap
    reform and loses it under legacy stop-resume pricing — the cell where
    cheap reforms change which policy wins."""
    return [
        FleetTrace.generate("steady-surge", 11, n_jobs=n_jobs,
                            n_pools=n_pools, ticks=ticks),
        FleetTrace.generate("churn", 12, n_jobs=n_jobs, n_pools=n_pools,
                            ticks=ticks, churn=0.35),
        FleetTrace.generate("spot-heavy", 13, n_jobs=n_jobs,
                            n_pools=n_pools, ticks=ticks,
                            spot_fraction=spot_fraction, churn=0.15),
        FleetTrace.generate("noisy", 16, n_jobs=n_jobs,
                            n_pools=n_pools, ticks=ticks,
                            noise=0.04, pool_surge=False),
    ]


class _LiveJob:
    """Runtime state of one admitted trainer."""

    __slots__ = ("spec", "sim", "sealed_rows", "unsealed_rows",
                 "alive_ticks", "node_ticks", "forced_evictions",
                 "suspended_ticks")

    def __init__(self, spec: FleetJobSpec, nodes: int):
        self.spec = spec
        self.sim = SimJob(spec.job_id, spec.curve, spec.min_nodes,
                          spec.max_nodes, nodes=nodes, noise=spec.noise)
        self.sealed_rows = 0.0
        self.unsealed_rows = 0.0
        self.alive_ticks = 0
        self.node_ticks = 0
        self.forced_evictions = 0
        self.suspended_ticks = 0

    def legal_sizes(self) -> list[int]:
        g = self.spec.gang
        return [n for n in range(self.spec.min_nodes,
                                 self.spec.max_nodes + 1)
                if n % g == 0]

    def snap(self, desired: int) -> int:
        """Largest gang-legal size <= desired (0 = suspended: the gang
        either runs whole or not at all)."""
        legal = [n for n in self.legal_sizes() if n <= desired]
        return legal[-1] if legal else 0


class _LivePool:
    __slots__ = ("spec", "sim", "ok_ticks", "alive_ticks", "served_rows",
                 "ok_rows")

    def __init__(self, spec: FleetPoolSpec, seed: int, tick_s: float):
        self.spec = spec
        self.sim = SimServingPool(
            spec.service, spec.trace, teacher_rate=spec.teacher_rate,
            slo_p95_ms=spec.slo_p95_ms, teachers=spec.teachers,
            min_teachers=spec.min_teachers,
            max_teachers=spec.max_teachers, seed=seed, tick_s=tick_s)
        self.ok_ticks = 0
        self.alive_ticks = 0
        self.served_rows = 0.0   # throughput: everything served
        self.ok_rows = 0.0       # goodput: served within the SLO


@dataclass
class FleetObs:
    """One tick's observation bundle for the scheduling policy."""

    now: float
    tick: int
    trainer_views: list[FleetJobView]
    serving_views: list
    capacity: int
    notices: list[dict]


class FleetSim:
    """Seeded fleet: arrivals, departures, gangs, spot, per-action
    downtime. Deterministic under (trace.seed, seed, ladder)."""

    def __init__(self, trace: FleetTrace, *,
                 ladder: DowntimeLadder = MEASURED, tick_s: float = 5.0,
                 seed: int = 0, seal_every_ticks: int = 6):
        self.trace = trace
        self.ladder = ladder
        self.tick_s = tick_s
        self.seal_every_ticks = max(1, seal_every_ticks)
        self.now = 0.0
        self.ticks = 0
        self._rng = random.Random((trace.seed << 8) ^ seed)
        self.jobs: dict[str, _LiveJob] = {}
        self.pools: dict[str, _LivePool] = {}
        # tick counts from 1, so tick-0 arrivals are queued up front
        self._waiting: list[FleetJobSpec] = [
            s for s in trace.jobs if s.arrive_tick == 0]
        self._departed: list[_LiveJob] = []
        self._capacity = trace.total_nodes
        self._pending_notices: list[Preemption] = []
        self.downtime_paid_s = 0.0
        self.forced_evictions = 0
        self.notices_issued = 0
        self.notices_ridden = 0
        self.lost_rows = 0.0
        self.resizes_by_kind: dict[str, int] = {
            "adopt": 0, "reform": 0, "stop-resume": 0}

    # -- capacity ----------------------------------------------------------

    def capacity(self) -> int:
        return self._capacity

    def allocated(self) -> int:
        return (sum(j.sim.nodes for j in self.jobs.values())
                + sum(p.sim.desired for p in self.pools.values()))

    def notices(self) -> list[dict]:
        """Pending preemption notices (issued, deadline not reached)."""
        return [{"nodes": p.nodes, "deadline_tick": p.deadline_tick,
                 "notice_tick": p.notice_tick}
                for p in self._pending_notices]

    # -- the tick ----------------------------------------------------------

    def tick(self) -> FleetObs:
        self.ticks += 1
        self.now += self.tick_s
        t = self.ticks
        # 1. spot lifecycle: issue notices, enforce deadlines, restore
        for p in self.trace.preemptions:
            if p.notice_tick == t:
                self._pending_notices.append(p)
                self.notices_issued += 1
            if p.restore_tick == t:
                self._capacity += p.nodes
        expired = [p for p in self._pending_notices
                   if p.deadline_tick <= t]
        self._pending_notices = [p for p in self._pending_notices
                                 if p.deadline_tick > t]
        for p in expired:
            self._capacity -= p.nodes
            if self.allocated() <= self._capacity:
                # the fleet shrank under the post-deadline capacity in
                # time: the preemption was RIDDEN, nothing is killed
                self.notices_ridden += 1
        self._force_evict()
        # 2. arrivals / departures (gang-whole admission)
        for spec in self.trace.jobs:
            if spec.arrive_tick == t:
                self._waiting.append(spec)
        for spec in list(self._waiting):
            job = _LiveJob(spec, nodes=spec.min_nodes)
            if self.allocated() + spec.min_nodes <= self._capacity:
                self.jobs[spec.job_id] = job
                self._waiting.remove(spec)
        for job_id, job in list(self.jobs.items()):
            if job.spec.depart_tick is not None \
                    and job.spec.depart_tick <= t:
                job.sealed_rows += job.unsealed_rows
                job.unsealed_rows = 0.0
                self._departed.append(self.jobs.pop(job_id))
        for spec in self.trace.pools:
            if spec.arrive_tick == t or (spec.arrive_tick == 0
                                         and t == 1):
                if spec.service not in self.pools:
                    self.pools[spec.service] = _LivePool(
                        spec, seed=self.trace.seed * 1000 + len(self.pools),
                        tick_s=self.tick_s)
        # 3. advance trainers (downtime accounting like SimCluster.tick)
        trainer_views: list[FleetJobView] = []
        for job in self.jobs.values():
            job.alive_ticks += 1
            job.node_ticks += job.sim.nodes
            sim = job.sim
            if sim.nodes == 0:
                # a suspended gang's stats ARE fresh — it is
                # definitively producing zero; fresh=True lets the
                # policy propose a resume instead of holding forever
                # on "no-fresh-utilization"
                job.suspended_ticks += 1
                trainer_views.append(self._view(job, 0.0, fresh=True))
                continue
            if sim.downtime_left > 0:
                paid = min(sim.downtime_left, self.tick_s)
                sim.downtime_left = max(0.0,
                                        sim.downtime_left - self.tick_s)
                # partial tick: the remainder of the interval produces
                rate = sim.curve(sim.nodes) * (1.0 - paid / self.tick_s)
                rate *= max(0.0, 1.0 + self._rng.gauss(0.0, sim.noise))
                job.unsealed_rows += rate * self.tick_s
                trainer_views.append(self._view(job, 0.0, fresh=False))
            else:
                rate = sim.curve(sim.nodes)
                rate *= max(0.0, 1.0 + self._rng.gauss(0.0, sim.noise))
                job.unsealed_rows += rate * self.tick_s
                trainer_views.append(self._view(job, rate, fresh=True))
            if t % self.seal_every_ticks == 0:
                job.sealed_rows += job.unsealed_rows
                job.unsealed_rows = 0.0
        # 4. advance pools
        serving_views = []
        for pool in self.pools.values():
            pool.alive_ticks += 1
            view = pool.sim.tick()
            served = view.rows_per_sec * pool.sim.tick_s
            pool.served_rows += served
            if view.latency_ms_p95 <= view.slo_p95_ms:
                pool.ok_ticks += 1
                pool.ok_rows += served
            serving_views.append(view)
        return FleetObs(self.now, t, trainer_views, serving_views,
                        self._capacity, self.notices())

    def _view(self, job: _LiveJob, rate: float,
              fresh: bool) -> FleetJobView:
        return FleetJobView(job.spec.job_id, job.sim.nodes, rate,
                            job.spec.min_nodes, job.spec.max_nodes,
                            downtime_s=self.ladder.reform_s,
                            fresh=fresh, tier=job.spec.tier,
                            gang=job.spec.gang)

    # -- actuation ---------------------------------------------------------

    def resize(self, job_id: str, desired: int) -> int:
        """Scheduled resize through the reform ladder: gang-snapped,
        charged by action kind. Returns the actual new size."""
        job = self.jobs.get(job_id)
        if job is None:
            return 0
        sim = job.sim
        target = job.snap(max(0, desired))
        if target == sim.nodes:
            return sim.nodes
        kind = self.ladder.classify(sim.nodes, target)
        if sim.nodes == 0:
            kind = "stop-resume"  # un-suspending restarts from disk
        cost = self.ladder.cost(kind)
        if target == 0:
            # scheduled suspend = quiesce-seal-donate: progress seals
            job.sealed_rows += job.unsealed_rows
            job.unsealed_rows = 0.0
        sim.nodes = target
        sim.downtime_left = cost
        sim.downtime_paid += cost
        sim.resizes += 1
        sim.resize_ticks.append(self.ticks)
        self.downtime_paid_s += cost
        self.resizes_by_kind[kind] += 1
        return target

    def resize_pool(self, service: str, desired: int) -> int:
        pool = self.pools.get(service)
        return pool.sim.resize(desired) if pool is not None else 0

    def _force_evict(self) -> None:
        """Capacity dropped under the live allocation (a preemption
        deadline the policy did not ride): evict gang-whole from the
        lowest tier up. Each eviction is a HARD stop — stop-resume
        downtime plus every unsealed row since the last seal."""
        while self.allocated() > self._capacity:
            victims = sorted(
                (j for j in self.jobs.values() if j.sim.nodes > 0),
                key=lambda j: (-TIER_RANK.get(j.spec.tier, 1),
                               -j.sim.nodes, j.spec.job_id))
            if not victims:
                break
            job = victims[0]
            sim = job.sim
            legal = [n for n in job.legal_sizes() if n < sim.nodes]
            over = self.allocated() - self._capacity
            target = 0
            for n in reversed(legal):
                if sim.nodes - n >= over:
                    target = n
                    break
            cost = self.ladder.stop_resume_s
            sim.nodes = target
            sim.downtime_left = cost
            sim.downtime_paid += cost
            sim.resizes += 1
            sim.resize_ticks.append(self.ticks)
            self.downtime_paid_s += cost
            self.resizes_by_kind["stop-resume"] += 1
            self.lost_rows += job.unsealed_rows
            job.unsealed_rows = 0.0
            job.forced_evictions += 1
            self.forced_evictions += 1

    # -- scoring -----------------------------------------------------------

    def metrics(self) -> dict:
        """Tournament scores: goodput (sealed trainer rows + served
        pool rows per second of sim time), Jain fairness over
        entitlement-normalized node occupancy, SLO attainment over
        pool-ticks, and the downtime/eviction bill."""
        jobs = list(self.jobs.values()) + self._departed
        horizon = max(self.now, self.tick_s)
        trainer_rows = sum(j.sealed_rows + j.unsealed_rows for j in jobs)
        # serving GOODPUT counts only rows served within the SLO — a
        # row served during a breach is throughput, not goodput (the
        # caller already timed out on it); total served is reported
        # separately so the distinction stays auditable
        pool_rows = sum(p.ok_rows for p in self.pools.values())
        pool_served = sum(p.served_rows for p in self.pools.values())
        shares = [j.node_ticks / (j.alive_ticks * j.spec.max_nodes)
                  for j in jobs if j.alive_ticks > 0]
        jain = (sum(shares) ** 2 / (len(shares) * sum(s * s
                                                      for s in shares))
                if shares and sum(shares) > 0 else 1.0)
        pool_ticks = sum(p.alive_ticks for p in self.pools.values())
        ok_ticks = sum(p.ok_ticks for p in self.pools.values())
        return {
            "trace": self.trace.name,
            "ladder": self.ladder.name,
            "jobs": len(jobs),
            "pools": len(self.pools),
            "ticks": self.ticks,
            "goodput_rows_per_s": round(
                (trainer_rows + pool_rows) / horizon, 2),
            "trainer_rows_per_s": round(trainer_rows / horizon, 2),
            "pool_rows_per_s": round(pool_rows / horizon, 2),
            "pool_served_rows_per_s": round(pool_served / horizon, 2),
            "jain_fairness": round(jain, 4),
            "slo_attainment": round(ok_ticks / pool_ticks, 4)
            if pool_ticks else 1.0,
            "downtime_paid_s": round(self.downtime_paid_s, 2),
            "resizes_by_kind": dict(self.resizes_by_kind),
            "forced_evictions": self.forced_evictions,
            "notices_issued": self.notices_issued,
            "notices_ridden": self.notices_ridden,
            "lost_rows": round(self.lost_rows, 1),
            "spot_fraction": round(self.trace.spot_fraction, 3),
        }


def run_fleet(sim: FleetSim, policy, *, decide_every: int = 2) -> dict:
    """Drive one policy over one fleet. Policies exposing
    ``decide_fleet`` (fleet_policy.PreemptiveFairSharePolicy) see the
    capacity + pending notices; plain mixed policies get the current
    capacity as their budget and stay notice-blind — exactly the
    baseline the tournament compares against."""
    for _ in range(sim.trace.ticks):
        obs = sim.tick()
        if sim.ticks % decide_every:
            continue
        if hasattr(policy, "decide_fleet"):
            t_props, s_props = policy.decide_fleet(
                obs.trainer_views, obs.serving_views, obs.now,
                notices=obs.notices, capacity=obs.capacity)
        else:
            policy.budget = obs.capacity
            t_props, s_props = policy.decide_mixed(
                obs.trainer_views, obs.serving_views, obs.now)
        for prop in t_props:
            if prop.is_resize:
                actual = sim.resize(prop.job_id, prop.desired)
                if actual != prop.current:  # gang-snap can no-op
                    policy.notify_resized(prop.job_id, actual, obs.now)
        for prop in s_props:
            if prop.is_resize:
                actual = sim.resize_pool(prop.job_id, prop.desired)
                if actual != prop.current:
                    policy.notify_resized(prop.job_id, actual, obs.now)
    out = sim.metrics()
    out["policy"] = type(policy).__name__
    return out


def tournament(*, traces: list[FleetTrace] | None = None,
               ladders: list[DowntimeLadder] | None = None,
               policies: dict | None = None,
               decide_every: int = 2, tick_s: float = 5.0) -> dict:
    """Seeded policy tournament over the policy x trace x ladder grid.
    ``policies`` maps name -> zero-arg factory (a fresh policy per
    cell — models must not leak between runs). Returns
    ``{"rows": [...], "fingerprint": sha256-of-rows}``."""
    from edl_tpu_torch.scaler.fleet_policy import default_policies
    traces = trace_menu() if traces is None else traces
    ladders = [MEASURED, LEGACY] if ladders is None else ladders
    policies = default_policies() if policies is None else policies
    rows = []
    for trace in traces:
        for ladder in ladders:
            for pname, factory in policies.items():
                sim = FleetSim(trace, ladder=ladder, tick_s=tick_s)
                row = run_fleet(sim, factory(), decide_every=decide_every)
                row["policy"] = pname
                rows.append(row)
    blob = json.dumps(rows, sort_keys=True).encode()
    return {"rows": rows,
            "fingerprint": hashlib.sha256(blob).hexdigest()}


# -- the torch-free CI smoke ---------------------------------------------------


def selftest(verbose: bool = True) -> int:
    """Small-fleet correctness gate (runs before dependency install in
    CI, so it doubles as the stdlib-only proof)."""
    assert "torch" not in sys.modules and "numpy" not in sys.modules, \
        "fleet selftest must run torch/numpy-free"
    from edl_tpu_torch.scaler.fleet_policy import PreemptiveFairSharePolicy
    from edl_tpu_torch.scaler.policy import FairSharePolicy
    failures: list[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        if verbose:
            print(f"  {'ok  ' if ok else 'FAIL'} {name} {detail}")
        if not ok:
            failures.append(name)

    kw = dict(cooldown_s=15.0, horizon_s=60.0)
    small = dict(n_jobs=28, n_pools=6, ticks=120)

    # 1. determinism: identical seeds => identical tournament rows
    t1 = tournament(traces=[FleetTrace.generate("t", 3, **small)],
                    ladders=[MEASURED],
                    policies={"fair": lambda: FairSharePolicy(64, **kw)})
    t2 = tournament(traces=[FleetTrace.generate("t", 3, **small)],
                    ladders=[MEASURED],
                    policies={"fair": lambda: FairSharePolicy(64, **kw)})
    check("deterministic-tournament",
          t1["fingerprint"] == t2["fingerprint"], t1["fingerprint"][:12])

    # 2. gang constraint: every live allocation is gang-legal
    trace = FleetTrace.generate("gang", 5, **small)
    sim = FleetSim(trace)
    run_fleet(sim, PreemptiveFairSharePolicy(sim.capacity(), **kw))
    gang_ok = all(j.sim.nodes == 0 or (j.sim.nodes % j.spec.gang == 0
                                       and j.sim.nodes >= j.spec.min_nodes)
                  for j in sim.jobs.values())
    check("gang-legal-allocations", gang_ok)

    # 3. preemptive vs plain fair-share: better SLO attainment at
    # equal-or-better goodput on a surging fleet (small-scale version
    # of the tournament acceptance bar)
    trace = FleetTrace.generate("surge", 7, **small)
    base = run_fleet(FleetSim(trace),
                     FairSharePolicy(1, **kw))
    pre = run_fleet(FleetSim(trace),
                    PreemptiveFairSharePolicy(1, **kw))
    check("preemptive-wins-slo",
          pre["slo_attainment"] >= base["slo_attainment"],
          f"{pre['slo_attainment']} vs {base['slo_attainment']}")
    check("preemptive-holds-goodput",
          pre["goodput_rows_per_s"] >= 0.98 * base["goodput_rows_per_s"],
          f"{pre['goodput_rows_per_s']} vs {base['goodput_rows_per_s']}")

    # 4. spot riding: the notice-aware policy shrinks ahead of the
    # deadline (zero forced evictions); the notice-blind baseline pays
    spot = FleetTrace.generate("spot", 9, spot_fraction=0.5, **small)
    blind = run_fleet(FleetSim(spot), FairSharePolicy(1, **kw))
    aware = run_fleet(FleetSim(spot),
                      PreemptiveFairSharePolicy(1, **kw))
    check("notice-blind-pays-evictions", blind["forced_evictions"] > 0,
          str(blind["forced_evictions"]))
    check("notice-aware-rides",
          aware["forced_evictions"] < blind["forced_evictions"]
          and aware["notices_ridden"] > blind["notices_ridden"],
          f"evict {aware['forced_evictions']} vs "
          f"{blind['forced_evictions']}, rode "
          f"{aware['notices_ridden']} vs {blind['notices_ridden']}")

    # 5. the ladder changes the bill: the same policy on the same trace
    # pays visibly more downtime under the legacy (all-stop-resume)
    # ladder than under the default ladder (a cheap reform)
    m = run_fleet(FleetSim(trace, ladder=MEASURED),
                  PreemptiveFairSharePolicy(1, **kw))
    lg = run_fleet(FleetSim(trace, ladder=LEGACY),
                   PreemptiveFairSharePolicy(1, **kw))
    check("ladder-prices-differ",
          lg["downtime_paid_s"] > 2.0 * m["downtime_paid_s"],
          f"{lg['downtime_paid_s']} vs {m['downtime_paid_s']}")

    # 6. artifact ladder parsing falls back field-by-field
    check("artifact-ladder-defaults",
          DowntimeLadder.from_artifact("/nonexistent") is None)

    if failures:
        print(f"fleet selftest: {len(failures)} FAILED: {failures}")
        return 1
    if verbose:
        print("fleet selftest: all checks passed")
    return 0


def _fleet_env_defaults() -> dict:
    """The EDL_TPU_FLEET_* knobs (registered in utils/config.ENV_VARS;
    the CLI reads them as defaults so tournaments are tunable without
    flag soup)."""
    return {
        "n_jobs": env_int("EDL_TPU_FLEET_JOBS", 180),
        "n_pools": env_int("EDL_TPU_FLEET_POOLS", 24),
        "ticks": env_int("EDL_TPU_FLEET_TICKS", 240),
        "spot_fraction": env_float("EDL_TPU_FLEET_SPOT_FRACTION", 0.5),
    }


def main(argv: list[str] | None = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.scaler.fleet",
        description="fleet simulator: selftest / seeded tournament")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("selftest", help="deterministic small-fleet gate")
    tour = sub.add_parser("tournament",
                          help="policy x trace x ladder grid (JSON)")
    tour.add_argument("--jobs", type=int, default=None)
    tour.add_argument("--pools", type=int, default=None)
    tour.add_argument("--ticks", type=int, default=None)
    tour.add_argument("--ladder", default=None,
                      help="artifact JSON of measured downtimes")
    args = parser.parse_args(argv)
    if args.cmd == "selftest":
        return selftest()
    env = _fleet_env_defaults()
    traces = trace_menu(
        n_jobs=args.jobs if args.jobs is not None else env["n_jobs"],
        n_pools=args.pools if args.pools is not None else env["n_pools"],
        ticks=args.ticks if args.ticks is not None else env["ticks"],
        spot_fraction=env["spot_fraction"])
    ladders = None
    if args.ladder:
        measured = DowntimeLadder.from_artifact(args.ladder)
        if measured is None:
            print(f"unreadable ladder artifact: {args.ladder}",
                  file=sys.stderr)
            return 2
        ladders = [measured, LEGACY]
    out = tournament(traces=traces, ladders=ladders)
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
