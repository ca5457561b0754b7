"""Deterministic cluster simulator: policies testable without training
(port of ``edl_tpu.scaler.simulator``).

`SimCluster` replays the elastic control loop against synthetic scaling
curves (concave, flat, knee, linear) with seeded multiplicative noise and
a modeled resize downtime during which the job produces nothing. Time is
virtual: `tick()` advances it by `tick_s`; nothing reads the wall clock,
so every run is exactly reproducible and a thousand-tick sweep costs
milliseconds. `SimServingPool` does the same for a teacher pool under an
open-loop arrival trace (`steady`, `step`, `burst`).

`run_policy` drives a policy over N ticks, actuates its proposals on the
SimCluster, and reports convergence (last-resize tick, post-convergence
resize count, allocation gap vs the oracle computed from the true
noise-free curve) plus the downtime the policy paid;
`run_serving_policy` is its serving counterpart.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable

from edl_tpu_torch.scaler.policy import JobView, ScalingPolicy


@dataclass(frozen=True)
class ScalingCurve:
    """True throughput as a function of world size."""

    name: str
    rate: Callable[[int], float]

    def __call__(self, n: int) -> float:
        return 0.0 if n < 1 else float(self.rate(n))


def concave(r1: float = 100.0, alpha: float = 0.6) -> ScalingCurve:
    """Diminishing returns: T(n) = r1 * n^alpha."""
    return ScalingCurve(f"concave(a={alpha})", lambda n: r1 * n ** alpha)


def flat(r: float = 100.0) -> ScalingCurve:
    """More nodes buy nothing: T(n) = r."""
    return ScalingCurve("flat", lambda n: r)


def knee(r1: float = 100.0, knee_n: int = 4) -> ScalingCurve:
    """Linear to the knee, flat past it: T(n) = r1 * min(n, knee_n)."""
    return ScalingCurve(f"knee(k={knee_n})",
                        lambda n: r1 * min(n, knee_n))


def linear(r1: float = 100.0) -> ScalingCurve:
    """Perfect scaling: T(n) = r1 * n."""
    return ScalingCurve("linear", lambda n: r1 * n)


@dataclass
class SimJob:
    """One elastic job: a curve, an allocation, a resize in flight."""

    job_id: str
    curve: ScalingCurve
    min_nodes: int = 1
    max_nodes: int = 8
    nodes: int = 1
    noise: float = 0.01           # multiplicative sigma on observed rate
    downtime_left: float = 0.0    # seconds of the current resize stall
    resizes: int = 0
    downtime_paid: float = 0.0
    resize_ticks: list[int] = field(default_factory=list)


class SimCluster:
    """Seeded, wall-clock-free cluster the decision plane runs against."""

    def __init__(self, jobs: list[SimJob], *, tick_s: float = 5.0,
                 downtime_s: float = 1.5, seed: int = 0):
        self.jobs = {j.job_id: j for j in jobs}
        self.tick_s = tick_s
        self.downtime_s = downtime_s
        self.now = 0.0
        self.ticks = 0
        self._rng = random.Random(seed)

    def tick(self) -> list[JobView]:
        """Advance virtual time one interval; emit Collector-like views.

        A job inside its resize downtime reports nothing trustworthy
        (``fresh=False``, zero rate) — exactly what the live controller
        sees while a world re-forms."""
        self.now += self.tick_s
        self.ticks += 1
        views = []
        for job in self.jobs.values():
            if job.downtime_left > 0:
                job.downtime_left = max(0.0,
                                        job.downtime_left - self.tick_s)
                views.append(JobView(job.job_id, job.nodes, 0.0,
                                     job.min_nodes, job.max_nodes,
                                     self.downtime_s, fresh=False))
                continue
            rate = job.curve(job.nodes)
            rate *= max(0.0, 1.0 + self._rng.gauss(0.0, job.noise))
            views.append(JobView(job.job_id, job.nodes, rate,
                                 job.min_nodes, job.max_nodes,
                                 self.downtime_s))
        return views

    def resize(self, job_id: str, desired: int) -> int:
        """Actuate: clamp, pay the downtime, count it. Returns the new
        allocation."""
        job = self.jobs[job_id]
        desired = max(job.min_nodes, min(job.max_nodes, desired))
        if desired != job.nodes:
            job.nodes = desired
            job.downtime_left = self.downtime_s
            job.downtime_paid += self.downtime_s
            job.resizes += 1
            job.resize_ticks.append(self.ticks)
        return job.nodes

    # -- oracles (computed from the TRUE curve, noise-free) ----------------

    def oracle_alloc(self, job_id: str, epsilon: float) -> int:
        """Largest n in [min, max] whose last node still gains >= epsilon
        relative throughput — the marginal-gain-positive allocation the
        ThroughputPolicy converges to."""
        job = self.jobs[job_id]
        best = job.min_nodes
        for n in range(job.min_nodes + 1, job.max_nodes + 1):
            t0, t1 = job.curve(n - 1), job.curve(n)
            if t0 <= 0 or (t1 - t0) / t0 < epsilon:
                break
            best = n
        return best

    def oracle_fair_share(self, budget: int) -> dict[str, int]:
        """Greedy water-fill on the true curves (optimal for concave)."""
        alloc = {j.job_id: j.min_nodes for j in self.jobs.values()}
        left = budget - sum(alloc.values())
        while left > 0:
            best_job, best_gain = None, 0.0
            for job in self.jobs.values():
                n = alloc[job.job_id]
                if n >= job.max_nodes:
                    continue
                gain = job.curve(n + 1) - job.curve(n)
                if best_job is None or gain > best_gain:
                    best_job, best_gain = job.job_id, gain
            if best_job is None:
                break
            alloc[best_job] += 1
            left -= 1
        return alloc


# -- the serving pool (SLO-driven elasticity; scaler/serving.py) -------------


@dataclass(frozen=True)
class ArrivalTrace:
    """Open-loop arrival rate (rows/sec) as a function of the tick."""

    name: str
    rate: Callable[[int], float]

    def __call__(self, tick: int) -> float:
        return max(0.0, float(self.rate(tick)))


def steady(lam: float = 200.0) -> ArrivalTrace:
    """Constant demand: the no-thrash baseline."""
    return ArrivalTrace(f"steady({lam:g})", lambda t: lam)


def step(lam: float = 100.0, factor: float = 4.0,
         at: int = 40) -> ArrivalTrace:
    """Demand jumps ``factor``x at tick ``at`` and stays: the SLO
    recovery case."""
    return ArrivalTrace(f"step({lam:g}x{factor:g}@{at})",
                        lambda t: lam * factor if t >= at else lam)


def burst(lam: float = 100.0, factor: float = 4.0, at: int = 40,
          length: int = 20) -> ArrivalTrace:
    """Demand spikes ``factor``x for ``length`` ticks then returns:
    grow in, drain out."""
    return ArrivalTrace(f"burst({lam:g}x{factor:g}@{at}+{length})",
                        lambda t: lam * factor if at <= t < at + length
                        else lam)


class SimServingPool:
    """Deterministic open-loop serving pool the `ServingPolicy` runs
    against: arrivals from a trace, capacity = ready teachers x
    ``teacher_rate`` rows/sec, explicit backlog dynamics.

    The latency model is queueing-naive but directionally honest:
    p95 = ``base_ms / (1 - rho)`` (service-time inflation as load
    approaches capacity, rho clamped at 0.95) plus the time the current
    backlog takes to drain at full capacity. Seeded multiplicative
    noise on top. A grow takes ``spawn_delay_ticks`` before the new
    teacher counts (the view's ``desired`` stays ahead of
    ``n_teachers`` meanwhile — exactly the live resize-in-flight
    signal); a shrink drains within the tick, so — unlike trainer
    resizes — serving NEVER pays a fresh=False downtime window. That
    asymmetry is the whole point of keep-then-fill.
    """

    def __init__(self, service: str, trace: ArrivalTrace, *,
                 teacher_rate: float = 250.0, base_ms: float = 20.0,
                 slo_p95_ms: float = 250.0, teachers: int = 1,
                 min_teachers: int = 1, max_teachers: int = 16,
                 spawn_delay_ticks: int = 2, tick_s: float = 1.0,
                 request_rows: int = 16, noise: float = 0.0,
                 seed: int = 0):
        from edl_tpu_torch.scaler.serving import ServingView
        self._view_cls = ServingView
        self.service = service
        self.trace = trace
        self.teacher_rate = teacher_rate
        self.base_ms = base_ms
        self.slo_p95_ms = slo_p95_ms
        self.min_teachers = min_teachers
        self.max_teachers = max_teachers
        self.spawn_delay_ticks = spawn_delay_ticks
        self.tick_s = tick_s
        self.request_rows = request_rows
        self.noise = noise
        self._rng = random.Random(seed)
        self.ready = teachers
        self.desired = teachers
        self._pending_spawns: list[int] = []  # tick each becomes ready
        self.backlog_rows = 0.0
        self.now = 0.0
        self.ticks = 0
        self.resizes = 0
        self.resize_ticks: list[int] = []

    def tick(self):
        """Advance one interval; emit the rollup-shaped ServingView."""
        self.ticks += 1
        self.now += self.tick_s
        ready_now = sum(1 for t in self._pending_spawns if t <= self.ticks)
        self.ready += ready_now
        self._pending_spawns = [t for t in self._pending_spawns
                                if t > self.ticks]
        lam = self.trace(self.ticks)
        cap = self.ready * self.teacher_rate
        arrived = lam * self.tick_s
        served = min(self.backlog_rows + arrived, cap * self.tick_s)
        self.backlog_rows = max(0.0,
                                self.backlog_rows + arrived - served)
        rho = lam / cap if cap > 0 else float("inf")
        wait_ms = (self.backlog_rows / cap) * 1e3 if cap > 0 else 0.0
        p95 = self.base_ms / max(1.0 - min(rho, 0.95), 0.05) + wait_ms
        p95 *= max(0.0, 1.0 + self._rng.gauss(0.0, self.noise))
        p50 = self.base_ms + wait_ms
        return self._view_cls(
            self.service, self.ready,
            rows_per_sec=round(served / self.tick_s, 2),
            util=min(1.0, rho),
            queue_depth=int(self.backlog_rows // self.request_rows),
            latency_ms_p50=round(p50, 2), latency_ms_p95=round(p95, 2),
            slo_p95_ms=self.slo_p95_ms, min_teachers=self.min_teachers,
            max_teachers=self.max_teachers, desired=self.desired)

    def resize(self, desired: int) -> int:
        """Actuate: spawn after a delay, drain within the tick."""
        desired = max(self.min_teachers, min(self.max_teachers, desired))
        total = self.ready + len(self._pending_spawns)
        if desired > total:
            for _ in range(desired - total):
                self._pending_spawns.append(self.ticks
                                            + self.spawn_delay_ticks)
        elif desired < total:
            drop = total - desired
            while drop and self._pending_spawns:  # cancel unspawned first
                self._pending_spawns.pop()
                drop -= 1
            self.ready -= drop
        if desired != total:
            self.resizes += 1
            self.resize_ticks.append(self.ticks)
        self.desired = desired
        return desired

    def oracle_teachers(self, lam: float) -> int:
        """Smallest pool whose steady-state p95 meets the SLO at
        arrival rate ``lam`` (from the true noise-free model):
        base/(1-rho) <= slo  =>  n >= lam / (rate * (1 - base/slo))."""
        headroom = 1.0 - self.base_ms / self.slo_p95_ms
        if headroom <= 0:
            return self.max_teachers
        need = math.ceil(lam / (self.teacher_rate * headroom))
        return max(self.min_teachers,
                   min(self.max_teachers, max(1, need)))


def run_serving_policy(pool: SimServingPool, policy, *,
                       ticks: int = 120, settle_ticks: int = 40) -> dict:
    """Drive a `ServingPolicy` over the pool; summarize SLO attainment
    and convergence. ``last_violation_tick`` is the recovery anchor:
    for a step trace, reaction = last_violation_tick - step tick."""
    ok: list[bool] = []
    for _ in range(ticks):
        view = pool.tick()
        ok.append(view.latency_ms_p95 <= view.slo_p95_ms)
        (prop,) = policy.decide([view], pool.now)
        if prop.is_resize:
            actual = pool.resize(prop.desired)
            policy.notify_resized(view.service, actual, pool.now)
    post = sum(1 for t in pool.resize_ticks if t > ticks - settle_ticks)
    return {"ticks": ticks, "trace": pool.trace.name,
            "slo_attainment": round(sum(ok) / len(ok), 4),
            "last_violation_tick": max(
                (i + 1 for i, good in enumerate(ok) if not good),
                default=0),
            "final_teachers": pool.ready,
            "resizes": pool.resizes,
            "post_convergence_resizes": post,
            "resize_ticks": list(pool.resize_ticks)}


def run_policy(cluster: SimCluster, policy: ScalingPolicy, *,
               ticks: int = 120, settle_ticks: int = 50) -> dict:
    """Drive `policy` over the cluster; summarize convergence.

    Convergence = no resize in the trailing `settle_ticks` window; the
    acceptance bar is gap <= 1 node vs the oracle AND zero resizes in
    that window (post-convergence stability)."""
    epsilon = getattr(policy, "gain_threshold", 0.05)
    decisions = 0
    for _ in range(ticks):
        views = cluster.tick()
        for prop in policy.decide(views, cluster.now):
            decisions += 1
            if prop.is_resize:
                actual = cluster.resize(prop.job_id, prop.desired)
                policy.notify_resized(prop.job_id, actual, cluster.now)
    out: dict = {"ticks": ticks, "decisions": decisions, "jobs": {}}
    last_resize_tick = 0
    for job in cluster.jobs.values():
        oracle = cluster.oracle_alloc(job.job_id, epsilon)
        post = sum(1 for t in job.resize_ticks
                   if t > ticks - settle_ticks)
        out["jobs"][job.job_id] = {
            "curve": job.curve.name,
            "final_nodes": job.nodes,
            "oracle_nodes": oracle,
            "gap_nodes": abs(job.nodes - oracle),
            "resizes": job.resizes,
            "downtime_paid_s": round(job.downtime_paid, 2),
            "post_convergence_resizes": post,
            "decisions_to_converge": (job.resize_ticks[-1]
                                      if job.resize_ticks else 0),
        }
        last_resize_tick = max(last_resize_tick,
                               out["jobs"][job.job_id]
                               ["decisions_to_converge"])
    out["decisions_to_converge"] = last_resize_tick
    out["downtime_paid_s"] = round(
        sum(j.downtime_paid for j in cluster.jobs.values()), 2)
    out["gap_nodes"] = max(j["gap_nodes"] for j in out["jobs"].values())
    out["post_convergence_resizes"] = sum(
        j["post_convergence_resizes"] for j in out["jobs"].values())
    return out
