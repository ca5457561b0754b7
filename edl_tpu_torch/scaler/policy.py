"""Scaling policies: utilization in, resize proposals out (port of
``edl_tpu.scaler.policy``).

Policies are pure state machines over (world_size, throughput)
observations: no store, no HTTP, no wall clock. The caller supplies
``now``, so the live controller (`scaler/controller.py`) and the
deterministic simulator (`scaler/simulator.py`) drive them alike, and
the same observations give the JAX package's proposals exactly.

- `ThroughputPolicy`: single-job autoscaling. Fits a throughput-vs-
  world-size curve from observed rates, probes unexplored sizes while
  the measured marginal gain clears a threshold, and settles on the
  smallest allocation within the hysteresis band of the best known
  rate. Every grow must amortize: the extra samples predicted before
  the next decision must exceed the samples lost to the resize
  downtime, so a resize that cannot pay for itself is never proposed.
- `FairSharePolicy`: multi-job. Water-fills a fixed node budget by
  marginal throughput (each next node goes to the job whose curve says
  it gains most), honoring per-job min/max, shrink-before-grow so the
  budget is never transiently exceeded.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Protocol, runtime_checkable


@dataclass
class JobView:
    """One job's state at one decision instant (a Collector digest)."""

    job_id: str
    world_size: int            # current allocation (live cluster world)
    throughput: float          # aggregate fresh examples/sec across pods
    min_nodes: int = 1
    max_nodes: int = 8
    # The price of one resize that every grow must amortize. The live
    # controller feeds the MEASURED per-job EWMA here (actuation ->
    # first fresh utilization at the new world, journal-replayed across
    # leader takeovers); the configured constant / a measured artifact is
    # only the fallback before the first observation — so a faster
    # resize path (p2p live migration) loosens the grow gate on its own.
    downtime_s: float = 1.5
    generation: int | None = None
    desired: int | None = None  # job-server desired (None = world_size)
    fresh: bool = True         # False: stale/reforming — do not learn

    @property
    def effective_desired(self) -> int:
        return self.world_size if self.desired is None else self.desired


@dataclass
class Proposal:
    """Policy output for one job: resize to `desired`, or hold + why."""

    job_id: str
    current: int
    desired: int
    reason: str
    predicted_gain: float | None = None  # examples/sec delta (grows)

    @property
    def is_resize(self) -> bool:
        return self.desired != self.current


@runtime_checkable
class ScalingPolicy(Protocol):
    """The policy contract the controller and simulator drive."""

    def decide(self, views: list[JobView], now: float) -> list[Proposal]:
        """One decision pass; returns a Proposal per view, same order."""
        ...

    def notify_resized(self, job_id: str, desired: int, now: float) -> None:
        """Actuation feedback: starts the job's cooldown clock."""
        ...

    def restore(self, entries: list[dict]) -> None:
        """Warm-start from journal entries (leader takeover)."""
        ...


class ThroughputModel:
    """EWMA throughput per observed world size + curve extrapolation.

    Known sizes answer with their smoothed mean; unknown sizes get a
    power-law fit ``T = c * n^a`` (log-log least squares, ``a`` clamped
    to [0, 1.2]) once two distinct sizes exist, else an optimistic
    linear extension of the single known point — optimism is what makes
    an unexplored size worth probing.
    """

    def __init__(self, ema: float = 0.3):
        self.ema = ema
        self._mean: dict[int, float] = {}
        self._count: dict[int, int] = {}
        # cached log-log fit (c, a); None = stale. Fleet-scale planning
        # calls predict O(budget * jobs) times per
        # decision, so the fit must not be recomputed per call.
        self._fit: tuple[float, float] | None = None

    def observe(self, n: int, rate: float) -> None:
        if n < 1 or rate < 0:
            return
        if n in self._mean:
            self._mean[n] += self.ema * (rate - self._mean[n])
        else:
            self._mean[n] = float(rate)
        self._count[n] = self._count.get(n, 0) + 1
        self._fit = None

    def known(self) -> list[int]:
        return sorted(self._mean)

    def observed(self, n: int) -> float | None:
        return self._mean.get(n)

    def predict(self, n: int) -> float | None:
        if n in self._mean:
            return self._mean[n]
        pts = [(k, v) for k, v in self._mean.items() if v > 0]
        if len(pts) >= 2:
            if self._fit is None:
                xs = [math.log(k) for k, _ in pts]
                ys = [math.log(v) for _, v in pts]
                mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
                denom = sum((x - mx) ** 2 for x in xs)
                a = (sum((x - mx) * (y - my)
                         for x, y in zip(xs, ys)) / denom
                     if denom > 0 else 0.0)
                a = max(0.0, min(a, 1.2))
                self._fit = (math.exp(my - a * mx), a)
            c, a = self._fit
            return c * n ** a
        if len(pts) == 1:
            k, v = pts[0]
            return v * n / k
        return None

    def marginal(self, n1: int, n2: int) -> float | None:
        """Relative per-node gain going n1 -> n2 from OBSERVED means."""
        t1, t2 = self.observed(n1), self.observed(n2)
        if t1 is None or t2 is None or t1 <= 0 or n2 <= n1:
            return None
        return (t2 - t1) / (t1 * (n2 - n1))


class _PolicyBase:
    """Shared observation intake, cooldown clocks, journal restore."""

    def __init__(self, *, gain_threshold: float = 0.05,
                 cooldown_s: float = 30.0, horizon_s: float | None = None,
                 ema: float = 0.3):
        self.gain_threshold = gain_threshold
        self.cooldown_s = cooldown_s
        # Amortization horizon: how long a new allocation runs before
        # the next decision can change it — the window a resize must
        # pay for itself within. Cooldown is that window's floor.
        self.horizon_s = cooldown_s if horizon_s is None else horizon_s
        self.ema = ema
        self._models: dict[str, ThroughputModel] = {}
        self._resized_at: dict[str, float] = {}

    def model(self, job_id: str) -> ThroughputModel:
        return self._models.setdefault(job_id, ThroughputModel(self.ema))

    def _intake(self, view: JobView, now: float) -> str | None:
        """Record the observation when trustworthy; else return the
        hold reason that makes this tick a no-op for the job."""
        resized_at = self._resized_at.get(view.job_id)
        settling = (resized_at is not None
                    and now - resized_at < view.downtime_s)
        if view.fresh and not settling and view.world_size >= 1 \
                and view.effective_desired == view.world_size:
            self.model(view.job_id).observe(view.world_size,
                                            view.throughput)
        if not view.fresh:
            return "no-fresh-utilization"
        if view.effective_desired != view.world_size:
            return "resize-in-flight"
        if settling:
            return "settling-after-resize"
        if resized_at is not None and now - resized_at < self.cooldown_s:
            return "cooldown"
        return None

    def _amortizes(self, gain_per_sec: float, view: JobView) -> bool:
        """True when the predicted gain repays the downtime before the
        next decision: gain * (horizon - downtime) > downtime * T_now."""
        usable = self.horizon_s - view.downtime_s
        if usable <= 0:
            return False
        return gain_per_sec * usable > view.downtime_s * view.throughput

    def notify_resized(self, job_id: str, desired: int, now: float) -> None:
        self._resized_at[job_id] = now

    def restore(self, entries: list[dict]) -> None:
        """Replay journal entries (seq order): re-learn the models from
        the recorded observations and resume the cooldown clocks, so a
        takeover leader neither forgets the curve nor double-resizes."""
        for e in entries:
            job = e.get("job_id")
            if not job:
                continue
            if e.get("fresh") and e.get("world_size", 0) >= 1 \
                    and e.get("throughput") is not None:
                self.model(job).observe(int(e["world_size"]),
                                        float(e["throughput"]))
            if e.get("action") == "resize":
                self._resized_at[job] = float(e.get("ts", 0.0))


class ThroughputPolicy(_PolicyBase):
    """Marginal-gain-positive autoscaling for independent jobs.

    Per decision (after cooldown/freshness gates):

    1. *recover* — if the current size runs > 2x the hysteresis band
       below the best known rate (we shrank past the knee), grow back
       to the settle size (amortization-gated).
    2. *probe-up* — while sitting at the largest explored size and the
       top observed marginal still clears `gain_threshold` (or fewer
       than two sizes are known), try one node more. Gated by the
       optimistic amortization bound (one node's perfect-scaling
       contribution must repay the downtime).
    3. *probe-down* — while sitting at the smallest explored size and
       the bottom marginal is below threshold (flat down here), try one
       node less: frees capacity at no predicted cost.
    4. *settle* — shrink to the smallest known size within the
       hysteresis band of the best known rate.
    5. otherwise hold (*converged*).

    The asymmetric bands (shrink within `gain_threshold`, grow back
    only past `2 * gain_threshold`) are the anti-oscillation margin: a
    noisy flat curve cannot alternate proposals, because the rates that
    would trigger a shrink and the rates that would trigger the
    corresponding grow-back are separated by a dead zone wider than the
    smoothed noise.
    """

    def decide(self, views: list[JobView], now: float) -> list[Proposal]:
        return [self._decide_one(v, now) for v in views]

    def _decide_one(self, view: JobView, now: float) -> Proposal:
        job, cur = view.job_id, view.world_size
        hold = self._intake(view, now)
        if hold is not None:
            return Proposal(job, cur, cur, hold)
        model = self.model(job)
        known = model.known()
        if not known:
            return Proposal(job, cur, cur, "no-observations")
        eps = self.gain_threshold
        best = max(model.observed(n) for n in known)
        settle_n = min(n for n in known
                       if model.observed(n) >= (1.0 - eps) * best)
        t_cur = model.observed(cur)

        # 1. recover: we sit measurably below the best known rate.
        if t_cur is not None and best > 0 and settle_n > cur \
                and t_cur < (1.0 - 2.0 * eps) * best:
            gain = model.observed(settle_n) - t_cur
            if self._amortizes(gain, view):
                return Proposal(job, cur, settle_n,
                                "recover-to-best-known", gain)
            return Proposal(job, cur, cur, "recover-unamortized", gain)

        top, bottom = known[-1], known[0]
        # 2. probe up: unexplored room above and the curve still climbs.
        if cur == top and top < view.max_nodes:
            top_marginal = (model.marginal(known[-2], top)
                            if len(known) >= 2 else None)
            if top_marginal is None or top_marginal >= eps:
                optimistic = (t_cur / cur) if t_cur and cur else 0.0
                if t_cur is None or t_cur == 0 \
                        or self._amortizes(optimistic, view):
                    return Proposal(job, cur, cur + 1, "probe-up",
                                    optimistic or None)
                return Proposal(job, cur, cur, "probe-up-unamortized",
                                optimistic)
        # 3. probe down: flat at the bottom of the explored range.
        if cur == bottom and bottom > view.min_nodes and len(known) >= 2:
            if (model.marginal(bottom, known[1]) or 0.0) < eps:
                return Proposal(job, cur, cur - 1, "probe-down")
        # 4. settle: smallest allocation within the hysteresis band.
        if settle_n < cur:
            return Proposal(job, cur, settle_n,
                            "settle-to-marginal-gain-positive")
        return Proposal(job, cur, cur, "converged")


class FairSharePolicy(_PolicyBase):
    """Split a fixed node budget across jobs by marginal throughput.

    Water-filling: every job starts at its `min_nodes`; each remaining
    budget node goes to the job whose model predicts the largest gain
    from one more node (unexplored jobs bid the best observed per-node
    rate across jobs — optimistic on the measured scale, so they
    attract exploration instead of being starved by explored jobs'
    absolute marginals). Proposals then reconcile the plan against the
    live allocations shrink-before-grow: grows are admitted only while
    the post-shrink total stays within budget, so the cluster never
    transiently exceeds it even when cooldowns stagger the actuations.
    """

    def __init__(self, budget: int, **kw):
        super().__init__(**kw)
        self.budget = budget

    def plan(self, views: list[JobView],
             budget: int | None = None) -> dict[str, int]:
        """The budget split this tick's models recommend."""
        alloc: dict[str, int] = {}
        left = self.budget if budget is None else budget
        for v in views:  # mins first, in view order, never past budget
            grant = min(v.min_nodes, max(left, 0))
            alloc[v.job_id] = grant
            left -= grant
        # Exploration bonus for jobs with NO observations yet, in the
        # same absolute examples/sec unit as explored jobs' marginal
        # gains: the best observed per-node rate across all jobs (a
        # constant like 1.0 would starve unexplored jobs whenever the
        # measured curves live at ~100 ex/s). No observations anywhere
        # -> every job is unexplored and any positive constant ties.
        rates = [self.model(v.job_id).observed(n) / n
                 for v in views for n in self.model(v.job_id).known()]
        explore = max([r for r in rates if r > 0], default=1.0)
        while left > 0:
            best_job, best_gain = None, 0.0
            for v in views:
                n = alloc[v.job_id]
                if n >= v.max_nodes:
                    continue
                model = self.model(v.job_id)
                t0, t1 = model.predict(n), model.predict(n + 1)
                # unexplored job: optimistic per-node-rate bonus, decayed
                # by the tentative allocation so several unexplored jobs
                # round-robin probe nodes instead of the first in view
                # order absorbing the whole remaining budget
                gain = (t1 - t0) if t0 is not None and t1 is not None \
                    else explore / (n + 1.0)
                if best_job is None or gain > best_gain:
                    best_job, best_gain = v.job_id, gain
            if best_job is None:
                break
            alloc[best_job] += 1
            left -= 1
        # clamp to each job's range (budget < sum(min) leaves a job
        # under its min; it must still be a legal allocation)
        for v in views:
            alloc[v.job_id] = max(min(alloc[v.job_id], v.max_nodes),
                                  0 if alloc[v.job_id] < v.min_nodes
                                  else v.min_nodes)
        return alloc

    def decide(self, views: list[JobView], now: float) -> list[Proposal]:
        holds = {v.job_id: self._intake(v, now) for v in views}
        alloc = self.plan(views)
        proposals: dict[str, Proposal] = {}
        # shrink-before-grow: shrinks free budget grows then consume
        total = sum(v.effective_desired for v in views)
        for v in sorted(views, key=lambda v: alloc[v.job_id]
                        - v.effective_desired):
            job, cur = v.job_id, v.world_size
            desired = alloc[job]
            if holds[job] is not None:
                proposals[job] = Proposal(job, cur, cur, holds[job])
                continue
            if desired == cur:
                proposals[job] = Proposal(job, cur, cur, "converged")
                continue
            delta = desired - v.effective_desired
            if delta > 0:
                gain = None
                if cur >= 1:  # a suspended world predicts nothing
                    model = self.model(job)
                    t0, t1 = model.predict(cur), model.predict(desired)
                    gain = (t1 - t0) if t0 is not None and t1 is not None \
                        else None
                if gain is not None and gain <= 0:
                    proposals[job] = Proposal(job, cur, cur,
                                              "no-marginal-gain", gain)
                    continue
                if gain is not None and not self._amortizes(gain, v):
                    proposals[job] = Proposal(job, cur, cur,
                                              "grow-unamortized", gain)
                    continue
                if total + delta > self.budget:
                    proposals[job] = Proposal(job, cur, cur,
                                              "awaiting-budget", gain)
                    continue
                proposals[job] = Proposal(job, cur, desired,
                                          "fair-share-grow", gain)
            else:
                proposals[job] = Proposal(job, cur, desired,
                                          "fair-share-shrink")
            total += desired - v.effective_desired
        return [proposals[v.job_id] for v in views]

    # -- teacher pools in the same budget ------------------------------------
    # (`scaler/serving.ServingView`, duck-typed: policy.py stays free of
    # the serving plane's imports)

    @staticmethod
    def pool_demand(view) -> int:
        """Teachers this pool's SLO predicts it needs — the serving
        plane's bid in the water-fill. Capacity scales latency ~ 1/m
        (the pool serves an open-loop arrival stream), so hold the
        predicted p95 at 75% of the SLO; when there is no latency
        signal yet, bound utilization at 0.75 instead. The max of the
        two is the demand: latency is the contract, utilization the
        early warning."""
        n = max(1, view.n_teachers)
        need = view.min_teachers
        if view.latency_ms_p95 and view.slo_p95_ms:
            need = max(need, math.ceil(
                n * view.latency_ms_p95 / (0.75 * view.slo_p95_ms)))
        if view.util:
            need = max(need, math.ceil(n * view.util / 0.75))
        return max(view.min_teachers, min(view.max_teachers, need))

    def plan_mixed(self, trainer_views: list[JobView], serving_views
                   ) -> tuple[dict[str, int], dict[str, int]]:
        """One node budget across trainer worlds AND teacher pools.
        Pools are granted their predicted SLO demand FIRST — serving is
        user-facing, so SLO headroom outranks batch throughput — and
        trainers water-fill the remainder by predicted marginal
        throughput. Returns ``(trainer_alloc, pool_alloc)``."""
        pool_alloc: dict[str, int] = {}
        left = self.budget
        for v in serving_views:
            grant = min(self.pool_demand(v), max(left, 0))
            pool_alloc[v.service] = grant
            left -= grant
        trainer_alloc = self.plan(trainer_views, budget=max(left, 0))
        return trainer_alloc, pool_alloc

    def decide_mixed(self, trainer_views: list[JobView], serving_views,
                     now: float) -> tuple[list[Proposal], list[Proposal]]:
        """`decide` with teacher pools in the budget: one joint
        shrink-before-grow reconcile across BOTH planes, so a pool's
        SLO grow can be funded by a trainer shrink within the same
        tick's accounting and the live total never transiently exceeds
        the budget. Returns proposals per plane, each in view order.
        (Cooldown state is keyed by id: a job and a service sharing a
        name would share a cooldown clock — don't do that.)"""
        trainer_alloc, pool_alloc = self.plan_mixed(trainer_views,
                                                    serving_views)
        # (kind, id, view, target, hold-reason)
        rows: list[tuple[str, str, object, int, str | None]] = []
        for v in trainer_views:
            rows.append(("trainer", v.job_id, v, trainer_alloc[v.job_id],
                         self._intake(v, now)))
        for v in serving_views:
            hold = None
            if not v.fresh or v.n_teachers < 1:
                hold = "no-fresh-serving-stats"
            elif v.effective_desired != v.n_teachers:
                hold = "resize-in-flight"
            else:
                resized_at = self._resized_at.get(v.service)
                if resized_at is not None \
                        and now - resized_at < self.cooldown_s:
                    hold = "cooldown"
            rows.append(("serving", v.service, v, pool_alloc[v.service],
                         hold))
        proposals: dict[str, Proposal] = {}
        total = sum(v.effective_desired for _, _, v, _, _ in rows)
        for kind, rid, v, desired, hold in sorted(
                rows, key=lambda r: r[3] - r[2].effective_desired):
            cur = v.world_size if kind == "trainer" else v.n_teachers
            if hold is not None:
                proposals[rid] = Proposal(rid, cur, cur, hold)
                continue
            if desired == cur:
                proposals[rid] = Proposal(rid, cur, cur, "converged")
                continue
            delta = desired - v.effective_desired
            if delta > 0:
                gain = None
                if kind == "trainer" and cur >= 1:
                    model = self.model(rid)
                    t0, t1 = model.predict(cur), model.predict(desired)
                    gain = (t1 - t0) if t0 is not None and t1 is not None \
                        else None
                    if gain is not None and gain <= 0:
                        proposals[rid] = Proposal(rid, cur, cur,
                                                  "no-marginal-gain", gain)
                        continue
                    if gain is not None and not self._amortizes(gain, v):
                        proposals[rid] = Proposal(rid, cur, cur,
                                                  "grow-unamortized", gain)
                        continue
                if total + delta > self.budget:
                    proposals[rid] = Proposal(rid, cur, cur,
                                              "awaiting-budget", gain)
                    continue
                reason = ("fair-share-grow" if kind == "trainer"
                          else "slo-fair-share-grow")
                proposals[rid] = Proposal(rid, cur, desired, reason, gain)
            else:
                reason = ("fair-share-shrink" if kind == "trainer"
                          else "slo-fair-share-shrink")
                proposals[rid] = Proposal(rid, cur, desired, reason)
            total += desired - v.effective_desired
        return ([proposals[v.job_id] for v in trainer_views],
                [proposals[v.service] for v in serving_views])
