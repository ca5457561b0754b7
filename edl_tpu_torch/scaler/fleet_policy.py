"""Preemptive gang fair-share: revoke batch nodes when serving hurts
(copy of ``edl_tpu.scaler.fleet_policy``).

`FairSharePolicy.decide_mixed` already funds pool grows from trainer
shrinks inside one tick's accounting — but only from trainers that
happen to be actionable. At fleet scale that is the gap: the pool
breaching its SLO waits behind cooldown clocks on trainers that just
resized, and a spot preemption deadline does not wait for anyone.

`PreemptiveFairSharePolicy` closes it with an explicit REVOCATION pass
on top of the base decision:

* when the live plan exceeds the budget (a spot notice just shrank the
  effective capacity), it revokes nodes from the lowest tier up until
  the fleet fits — uncapped, because the alternative at the deadline is
  a forced eviction (stop-resume + unsealed progress lost);
* when an SLO-breached pool's grow was held on "awaiting-budget", it
  revokes up to `revocation_budget` nodes per pass from batch /
  best-effort trainers and hands the freed headroom to the worst
  breaches ("slo-preempt-grow");
* every revocation is a SCHEDULED shrink through the reform ladder —
  gang-legal target sizes, never below a batch job's min (best-effort
  gangs may suspend to zero), never from `prod` — not a kill. The
  cooldown/settling holds that protect steady-state convergence are
  deliberately overridden for victims: revocation is the emergency
  path. Jobs with stale stats or a resize already in flight stay
  untouchable.

Like the rest of the scaler decision plane this is pure stdlib, wall-
clock-free, and seed-deterministic (covered by the ``sim-determinism``
edl-lint row); `decide_fleet` is the fleet-simulator entry point that
also folds pending preemption notices into the budget.
"""

from __future__ import annotations

from edl_tpu_torch.scaler.policy import FairSharePolicy, Proposal

TIER_RANK = {"prod": 0, "batch": 1, "best-effort": 2}


def _tier(view) -> str:
    return getattr(view, "tier", "batch")


def _gang(view) -> int:
    return max(1, int(getattr(view, "gang", 1)))


class PreemptiveFairSharePolicy(FairSharePolicy):
    """Fair share + tiered revocation + spot-notice riding."""

    def __init__(self, budget: int, *, revocation_budget: int = 16,
                 **kw):
        super().__init__(budget, **kw)
        # max nodes revoked per pass for SLO relief; capacity
        # enforcement (spot deadlines) is never capped
        self.revocation_budget = revocation_budget
        self.revocations: list[dict] = []

    # -- fleet entry point -------------------------------------------------

    def decide_fleet(self, trainer_views, serving_views, now, *,
                     notices=(), capacity: int | None = None):
        """`decide_mixed` with the budget set to the capacity the fleet
        will have AFTER every pending preemption notice lands — riding
        a notice means being small enough before the deadline, so the
        post-deadline capacity is the only honest budget."""
        if capacity is not None:
            drop = sum(int(n.get("nodes", 0)) for n in notices)
            self.budget = max(0, capacity - drop)
        return self.decide_mixed(trainer_views, serving_views, now)

    # -- the revocation pass -----------------------------------------------

    def decide_mixed(self, trainer_views, serving_views, now):
        t_props, s_props = super().decide_mixed(trainer_views,
                                                serving_views, now)
        return self._revoke(t_props, s_props, trainer_views,
                            serving_views, now)

    def _revoke(self, t_props, s_props, trainer_views, serving_views,
                now):
        tmap = {p.job_id: p for p in t_props}
        smap = {p.job_id: p for p in s_props}
        # post-actuation totals the base decision implies
        planned: dict[str, int] = {}
        for p, v in zip(t_props, trainer_views):
            planned[v.job_id] = (p.desired if p.is_resize
                                 else v.effective_desired)
        pool_planned: dict[str, int] = {}
        for p, v in zip(s_props, serving_views):
            pool_planned[v.service] = (p.desired if p.is_resize
                                       else v.effective_desired)
        total = sum(planned.values()) + sum(pool_planned.values())
        hard_need = max(0, total - self.budget)
        # SLO-breached pools whose grow the base pass could not fund
        blocked = []
        for p, v in zip(s_props, serving_views):
            if p.reason == "awaiting-budget" \
                    and v.latency_ms_p95 > v.slo_p95_ms:
                delta = self.pool_demand(v) - v.effective_desired
                if delta > 0:
                    blocked.append((v, delta))
        soft_need = sum(d for _, d in blocked)
        soft_cap = self.revocation_budget
        if hard_need == 0 and (soft_need == 0 or soft_cap == 0):
            return t_props, s_props

        # victims: lowest tier first, then cheapest goodput per node.
        # Cooldown/settling holds are overridden (emergency path);
        # stale stats or an in-flight resize stay untouchable.
        def actionable(v):
            return (v.fresh and _tier(v) != "prod"
                    and v.effective_desired == v.world_size
                    and planned[v.job_id] > 0)

        victims = sorted(
            (v for v in trainer_views if actionable(v)),
            key=lambda v: (-TIER_RANK.get(_tier(v), 1),
                           v.throughput / v.world_size
                           if v.world_size else 0.0,
                           v.job_id))
        for v in victims:
            want = hard_need + min(soft_need, soft_cap)
            if want <= 0:
                break
            cur = planned[v.job_id]
            gang = _gang(v)
            floor = 0 if _tier(v) == "best-effort" else v.min_nodes
            legal = [n for n in range(floor, cur)
                     if n == 0 or (n % gang == 0 and n >= v.min_nodes)]
            if not legal:
                continue
            # smallest step that covers the remaining need. Gang
            # granularity may force overshooting toward the floor —
            # acceptable for capacity enforcement (the alternative is
            # a forced eviction), pure waste for SLO relief.
            fits = [n for n in legal if n >= cur - want]
            if fits:
                target = min(fits)
            elif hard_need > 0:
                target = legal[0]
            else:
                continue
            yielded = cur - target
            h = min(yielded, hard_need)
            s = min(yielded - h, soft_need, soft_cap)
            if h + s == 0:
                continue
            hard_need -= h
            soft_need -= s
            soft_cap -= s
            planned[v.job_id] = target
            total -= yielded
            tmap[v.job_id] = Proposal(v.job_id, v.world_size, target,
                                      "preempt-revoke")
            self.revocations.append({
                "ts": now, "job": v.job_id, "tier": _tier(v),
                "from": cur, "to": target,
                "for": "capacity" if h else "slo"})
        # hand the freed headroom to the worst breaches first
        avail = max(0, self.budget - total)
        for v, delta in sorted(
                blocked, key=lambda t: (-t[0].latency_ms_p95
                                        / t[0].slo_p95_ms,
                                        t[0].service)):
            grant = min(delta, avail, v.max_teachers
                        - v.effective_desired)
            if grant <= 0:
                continue
            smap[v.service] = Proposal(
                v.service, v.n_teachers,
                v.effective_desired + grant, "slo-preempt-grow")
            pool_planned[v.service] += grant
            avail -= grant
        return ([tmap[v.job_id] for v in trainer_views],
                [smap[v.service] for v in serving_views])

    def stats(self) -> dict:
        by_cause: dict[str, int] = {"capacity": 0, "slo": 0}
        for r in self.revocations:
            by_cause[r["for"]] = by_cause.get(r["for"], 0) + 1
        return {"revocations": len(self.revocations),
                "revocations_by_cause": by_cause}


class GreedyRebalancePolicy(FairSharePolicy):
    """Chase the water-fill plan on RAW observations: no cooldown, no
    EWMA smoothing (``ema=1.0``), and the amortization gate bypassed.

    This is the policy cheap reforms unlock: it re-packs the fleet
    toward the instantaneous optimum every pass and pays a resize for
    every wiggle the observations make. Under the default ladder (a
    cheap in-place reform) that tax is negligible and the constant
    re-packing wins noisy regimes; under the legacy ladder (a disk
    stop-resume per action) the same behavior bleeds goodput and plain
    fair-share beats it — the ``noisy`` tournament trace is pinned at
    exactly that crossover. It deliberately does NOT read
    ``view.downtime_s``: a ladder-blind contestant is what makes the
    ladder's effect visible in the table."""

    def __init__(self, budget: int, **kw):
        kw.setdefault("cooldown_s", 0.0)
        kw.setdefault("horizon_s", 60.0)
        kw.setdefault("ema", 1.0)
        super().__init__(budget, **kw)

    def _amortizes(self, gain_per_sec: float, view) -> bool:
        return True


def default_policies() -> dict:
    """The tournament's default contestant list: name -> factory (a
    fresh policy per cell so learned curves never leak between runs).
    The placeholder budget is overwritten every decision from the
    fleet's live capacity."""
    kw = dict(cooldown_s=15.0, horizon_s=60.0)
    return {
        "fair-share": lambda: FairSharePolicy(1, **kw),
        "preemptive-fair-share":
            lambda: PreemptiveFairSharePolicy(1, **kw),
        "greedy-rebalance": lambda: GreedyRebalancePolicy(1),
    }
