"""SLO-driven serving elasticity: autoscale the distill teacher pool
(port of ``edl_tpu.scaler.serving``).

Teachers publish ``busy_s``/``queue_depth``/``latency_ms_p95`` through
`TeacherRegistrar` -> `Collector.service_rollup`, and the balancer's
keep-then-fill already handles an endpoint's departure, so a pool can
grow and shrink under live traffic without a client seeing a hard error.

Two halves, mirroring `policy.py`/`controller.py` for trainers:

- `ServingPolicy`, the decision plane. A pure state machine over
  `ServingView` observations (no store, no wall clock: the caller
  supplies ``now``), targeting a latency / queue-depth / shed-rate SLO
  with asymmetric hysteresis: grow fast on a sustained breach
  (``breach_ticks`` consecutive observations over the p95 target, the
  queue high-water mark, or the shed-rate ceiling; a multiplicative step
  bounded by ``grow_max_factor``), shrink slowly on sustained idleness
  (``idle_ticks`` consecutive observations under the utilization
  low-water mark with an empty queue and p95 well inside the SLO), one
  teacher at a time. A breach whose backlog is already paying down under
  the existing capacity holds (``backlog-draining``).

- `TeacherPoolActuator`, the actuation plane. Owns the teacher handles
  of one service on one host: grows by spawning (in-process
  `TeacherServer`s, `LocalTeacher`, or real processes,
  `spawn_process_teacher`), shrinks by draining: deregister from
  discovery first, wait until the server's own stats report an empty
  intake queue and zero in-flight groups, and only then stop it. A
  teacher that never quiets is hard-killed at ``drain_deadline_s`` and
  the kill is counted: the fallback, never the path.

`ScalerController` runs this policy beside the trainer policies under
one leader election. ``python -m edl_tpu_torch.scaler.serving selftest``
drives the policy over `simulator.SimServingPool`'s traces (torch-free),
and ``elastic_demo --serve-scaler`` runs the whole loop live on one host.
For the same observations the decisions are the JAX package's.
"""

from __future__ import annotations

import argparse
import math
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Protocol, runtime_checkable

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import recorder as flight
from edl_tpu_torch.obs import trace
from edl_tpu_torch.scaler.policy import Proposal
from edl_tpu_torch.utils.config import field
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.scaler.serving")


@dataclass
class ServingView:
    """One teacher pool's state at one decision instant (a
    `Collector.service_rollup` digest)."""

    service: str
    n_teachers: int            # live registered teachers
    rows_per_sec: float = 0.0  # aggregate serving rate across the pool
    util: float = 0.0          # mean busy fraction across teachers
    queue_depth: int = 0       # total intake backlog (requests)
    latency_ms_p50: float | None = None
    latency_ms_p95: float | None = None   # worst reporting teacher
    # admission-control signals (zero/empty from registrars that do not
    # publish them). Shedding is the policy's anti-blindness input: a
    # pool under admission control holds its p95 in-SLO by REJECTING,
    # so sustained shed_per_sec must count as a breach even while the
    # latency numbers look healthy.
    shed_per_sec: float = 0.0
    queue_depth_by_class: dict | None = None   # {"high": 3, ...}
    latency_ms_p95_by_class: dict | None = None
    draining: int = 0          # teachers mid-drain (not real capacity)
    slo_p95_ms: float = 250.0  # the SLO contract travels with the view
    min_teachers: int = 1
    max_teachers: int = 8
    desired: int | None = None  # actuator target (None = n_teachers)
    fresh: bool = True         # False: pool up but no reporting teacher

    @property
    def effective_desired(self) -> int:
        return self.n_teachers if self.desired is None else self.desired


@dataclass
class ServingConfig:
    """The SLO contract + hysteresis knobs (`EDL_TPU_SERVE_*`)."""

    # the target: pool p95 request latency (submit -> results ready)
    slo_p95_ms: float = field(250.0, env="EDL_TPU_SERVE_SLO_P95_MS")
    # breach also when the backlog exceeds this many queued requests
    # PER teacher — queue growth leads the latency it will become
    queue_high: float = field(4.0, env="EDL_TPU_SERVE_QUEUE_HIGH")
    # breach also when the pool sheds more than this many requests/sec:
    # admission control keeps p95 in-SLO by rejecting, so a latency-only
    # breach test goes blind exactly when the pool is most overloaded
    shed_high: float = field(0.5, env="EDL_TPU_SERVE_SHED_HIGH")
    # shrink only under this mean busy fraction (low-water mark) ...
    util_low: float = field(0.3, env="EDL_TPU_SERVE_UTIL_LOW")
    # ... and only while p95 sits under this fraction of the SLO: the
    # asymmetric dead zone between shrink and grow conditions
    shrink_headroom: float = field(0.5, env="EDL_TPU_SERVE_SHRINK_HEADROOM")
    # sustained-signal filters: consecutive observations required
    breach_ticks: int = field(2, env="EDL_TPU_SERVE_BREACH_TICKS")
    idle_ticks: int = field(5, env="EDL_TPU_SERVE_IDLE_TICKS")
    # per-pool seconds between actuated resizes
    cooldown_s: float = field(15.0, env="EDL_TPU_SERVE_COOLDOWN")
    # a grow multiplies the pool by at most this per decision (and by
    # at least +1 teacher): a 4x load step recovers in ~2 grows without
    # a single bad sample quadrupling the pool
    grow_max_factor: float = field(2.0, env="EDL_TPU_SERVE_GROW_FACTOR")
    min_teachers: int = field(1, env="EDL_TPU_SERVE_MIN_TEACHERS")
    max_teachers: int = field(8, env="EDL_TPU_SERVE_MAX_TEACHERS")
    # graceful-drain budget before the hard-kill fallback
    drain_deadline_s: float = field(30.0, env="EDL_TPU_SERVE_DRAIN_DEADLINE")


class ServingPolicy:
    """Latency/queue-SLO autoscaling for teacher pools.

    Per decision (per pool): freshness and resize-in-flight gates, then
    classify the observation (breach / idle / in-band), run the streak
    counters, and act only outside the cooldown — streaks keep
    accumulating *during* cooldown, so the first post-cooldown decision
    reacts immediately instead of re-waiting ``breach_ticks``.

    Same protocol shape as `ScalingPolicy` (decide / notify_resized /
    restore), so the controller and simulator drive both identically;
    the id field of a `Proposal` carries the service name.
    """

    def __init__(self, config: ServingConfig | None = None):
        self.config = config or ServingConfig()
        self._breach: dict[str, int] = {}
        self._idle: dict[str, int] = {}
        self._prev_queue: dict[str, int] = {}
        self._resized_at: dict[str, float] = {}

    def decide(self, views: list[ServingView], now: float) -> list[Proposal]:
        return [self._decide_one(v, now) for v in views]

    def _classify(self, view: ServingView) -> tuple[bool, bool, bool]:
        """(breach, draining, idle) for one observation."""
        cfg = self.config
        slo = view.slo_p95_ms or cfg.slo_p95_ms
        n = max(1, view.n_teachers)
        breach = ((view.latency_ms_p95 is not None
                   and view.latency_ms_p95 > slo)
                  or view.queue_depth > cfg.queue_high * n
                  # shed-blinded breach: under admission control the
                  # pool REJECTS its way back into the latency SLO, so
                  # sustained shedding is overload even at healthy p95
                  or view.shed_per_sec > cfg.shed_high)
        # Backlog already paying down under existing capacity: arrivals
        # run below service rate (util off the ceiling) and the queue
        # shrank since the last look — growing now would buy teachers
        # for a deficit that no longer exists.
        prev = self._prev_queue.get(view.service)
        draining = (breach and view.queue_depth > 0 and prev is not None
                    and view.queue_depth < prev and view.util < 0.95)
        idle = (not breach and view.util < cfg.util_low
                and view.queue_depth == 0
                and (view.latency_ms_p95 is None
                     or view.latency_ms_p95 < cfg.shrink_headroom * slo))
        return breach, draining, idle

    def _decide_one(self, view: ServingView, now: float) -> Proposal:
        svc, cur = view.service, view.n_teachers
        cfg = self.config
        if not view.fresh or cur < 1:
            return Proposal(svc, cur, cur, "no-fresh-serving-stats")
        if view.effective_desired != cur:
            return Proposal(svc, cur, cur, "resize-in-flight")
        breach, draining, idle = self._classify(view)
        self._prev_queue[svc] = view.queue_depth
        self._breach[svc] = (self._breach.get(svc, 0) + 1
                             if breach and not draining else 0)
        self._idle[svc] = self._idle.get(svc, 0) + 1 if idle else 0
        resized_at = self._resized_at.get(svc)
        if resized_at is not None and now - resized_at < cfg.cooldown_s:
            return Proposal(svc, cur, cur, "cooldown")
        if draining:
            return Proposal(svc, cur, cur, "backlog-draining")
        if self._breach[svc] >= cfg.breach_ticks:
            if cur >= view.max_teachers:
                return Proposal(svc, cur, cur, "slo-breach-at-max")
            slo = view.slo_p95_ms or cfg.slo_p95_ms
            factor = 1.0
            if view.latency_ms_p95 is not None and slo > 0:
                factor = view.latency_ms_p95 / slo
            if cfg.queue_high > 0:
                factor = max(factor,
                             view.queue_depth / (cfg.queue_high * cur))
            if view.shed_per_sec > cfg.shed_high:
                # offered / served: capacity for the load the pool is
                # turning away, not just the load it admitted (shed is
                # requests/s vs rows/s — an UNDER-estimate of pressure
                # when requests batch rows, safe under the max())
                factor = max(factor,
                             (view.rows_per_sec + view.shed_per_sec)
                             / max(view.rows_per_sec, 1.0))
            desired = min(view.max_teachers,
                          max(cur + 1,
                              math.ceil(cur * min(factor,
                                                  cfg.grow_max_factor))))
            return Proposal(svc, cur, desired, "slo-breach-grow")
        if self._idle[svc] >= cfg.idle_ticks and cur > view.min_teachers:
            return Proposal(svc, cur, cur - 1, "idle-shrink")
        return Proposal(svc, cur, cur, "in-band")

    def notify_resized(self, service: str, desired: int,
                       now: float) -> None:
        self._resized_at[service] = now
        self._breach[service] = 0
        self._idle[service] = 0
        self._prev_queue.pop(service, None)

    def restore(self, entries: list[dict]) -> None:
        """Journal replay (leader takeover): resume the cooldown clocks
        of serving-kind resize entries. Streaks restart from zero — a
        sustained condition re-proves itself within ``breach_ticks``
        observations, which is exactly the filter's job."""
        for e in entries:
            if e.get("kind") != "serving" or not e.get("service"):
                continue
            if e.get("action") == "resize":
                self._resized_at[e["service"]] = float(e.get("ts", 0.0))


# -- actuation ---------------------------------------------------------------


@runtime_checkable
class TeacherHandle(Protocol):
    """What the actuator needs from one live teacher."""

    endpoint: str

    def stats(self) -> dict | None:
        """Live serving counters, or None when the server is gone."""
        ...

    def deregister(self) -> None:
        """Leave discovery NOW (the drain's first step)."""
        ...

    def stop(self) -> None:
        """Graceful stop after a completed drain."""
        ...

    def kill(self) -> None:
        """Hard stop (the drain-deadline fallback)."""
        ...


class LocalTeacher:
    """In-process `TeacherServer` + registrar — the one-host pool unit
    (tests, `elastic_demo --serve-scaler`)."""

    def __init__(self, server, registrar):
        self.server = server
        self.registrar = registrar
        self.endpoint = registrar.server

    def stats(self) -> dict | None:
        try:
            return self.server.batcher.stats()
        except Exception:  # noqa: BLE001 — torn down under us
            return None

    def deregister(self) -> None:
        self.registrar.stop(deregister=True)

    def drain(self) -> None:
        """Stop admitting: pinned clients get reject-with-retry-after
        (and re-resolve via discovery) instead of queueing forever."""
        self.server.drain()

    def stop(self) -> None:
        self.server.stop()

    def kill(self) -> None:
        self.server.stop()  # in-process: same teardown path

    def close(self) -> None:
        self.registrar.stop(deregister=True)
        self.server.stop()


class ProcessTeacher:
    """Subprocess teacher (spawned via `collective/process.py`) with
    the registrar run actuator-side — the same sidecar split as the
    production CLI pair (`teacher_server` + `registrar`)."""

    def __init__(self, proc, registrar, endpoint: str):
        self.proc = proc           # collective.process.TrainerProc
        self.registrar = registrar
        self.endpoint = endpoint

    def stats(self) -> dict | None:
        from edl_tpu_torch.distill.teacher_server import TeacherClient
        try:
            client = TeacherClient(self.endpoint, timeout=2.0)
        except OSError:
            return None
        try:
            return client.stats()
        except Exception:  # noqa: BLE001 — dying server: treat as gone
            return None
        finally:
            client.close()

    def deregister(self) -> None:
        self.registrar.stop(deregister=True)

    def drain(self) -> None:
        """Flip the remote server into drain mode over the wire."""
        from edl_tpu_torch.distill.teacher_server import TeacherClient
        client = TeacherClient(self.endpoint, timeout=2.0)
        try:
            client.drain()
        finally:
            client.close()

    def stop(self) -> None:
        from edl_tpu_torch.collective.process import terminate_trainer
        terminate_trainer(self.proc, grace=5.0)

    def kill(self) -> None:
        from edl_tpu_torch.collective.process import terminate_trainer
        terminate_trainer(self.proc, grace=0.0)


def spawn_process_teacher(store, service: str, cmd: list[str],
                          endpoint: str, log_dir: str, index: int, *,
                          env: dict | None = None, ttl: float = 10.0,
                          stats_interval: float = 1.0,
                          probe_timeout: float = 60.0) -> ProcessTeacher:
    """Spawn ``cmd`` as a real teacher process (own process group,
    ``workerlog.N`` redirect — `collective/process.py`) and register
    ``endpoint`` once it answers TCP. The returned handle plugs into
    `TeacherPoolActuator`."""
    import os

    from edl_tpu_torch.collective.process import start_trainer
    from edl_tpu_torch.distill.registrar import TeacherRegistrar
    proc = start_trainer(cmd, dict(env or os.environ), log_dir, rank=index)
    registrar = TeacherRegistrar(store, service, endpoint, ttl=ttl,
                                 stats_interval=stats_interval,
                                 probe_timeout=probe_timeout)
    try:
        registrar.start()
    except Exception:
        from edl_tpu_torch.collective.process import terminate_trainer
        terminate_trainer(proc, grace=2.0)
        raise
    return ProcessTeacher(proc, registrar, endpoint)


class TeacherPoolActuator:
    """Grow by spawning, shrink by draining — never hard-kill a busy
    teacher.

    ``spawn(index) -> TeacherHandle`` is the only pool-specific piece;
    everything else (victim choice, the drain protocol, the resize and
    drain audit logs) is shared between in-process pools and real
    process pools.

    Drain protocol (per retired teacher, in a background thread so the
    control loop never blocks on it):

      1. **deregister** from discovery — the balancer's keep-then-fill
         reassigns the teacher's readers on its next tick, so new work
         stops arriving — and, when the handle supports it (duck-typed
         ``drain()``), flip the server itself into drain mode: further
         submits get reject-with-retry-after, so a client pinned past
         the deregistration re-resolves instead of re-arming the queue
         forever;
      2. **wait for in-flight work** via the server's own stats: the
         intake queue empty AND zero in-flight groups for
         ``drain_quiet_polls`` consecutive polls;
      3. **stop** gracefully — or, when the deadline expires first
         (a client pinned past the deregistration), **hard-kill** and
         record it (``drain_log[i]["hard_killed"]``).
    """

    def __init__(self, spawn: Callable[[int], TeacherHandle], *,
                 min_teachers: int = 1, max_teachers: int = 8,
                 drain_deadline_s: float = 30.0,
                 drain_poll_s: float = 0.1, drain_quiet_polls: int = 2,
                 service: str = "teacher"):
        self.spawn = spawn
        self.min_teachers = min_teachers
        self.max_teachers = max_teachers
        self.drain_deadline_s = drain_deadline_s
        self.drain_poll_s = drain_poll_s
        self.drain_quiet_polls = drain_quiet_polls
        self.service = service
        # control loop, drain threads, and test scrapes all touch the
        # pool state
        self._lock = threading.Lock()
        self._teachers: list[TeacherHandle] = []  # guarded-by: _lock
        self._spawned = 0                         # guarded-by: _lock
        self._drains: list[threading.Thread] = []  # guarded-by: _lock
        self.desired = 0                          # guarded-by: _lock
        self.resize_log: list[dict] = []          # guarded-by: _lock
        self.drain_log: list[dict] = []           # guarded-by: _lock
        # the logs stay the audit API; the obs registry serves the
        # same tallies as scrapeable gauges (unregistered on close)
        self._obs = obs_metrics.register_stats("pool", self.stats)

    def stats(self) -> dict:
        """Pool counters as a dict view (obs registry source)."""
        with self._lock:
            return {"teachers": len(self._teachers),
                    "desired": self.desired,
                    "spawned_total": self._spawned,
                    "resizes": len(self.resize_log),
                    "drains": len(self.drain_log),
                    "hard_kills": sum(1 for d in self.drain_log
                                      if d.get("hard_killed"))}

    def pool_size(self) -> int:
        with self._lock:
            return len(self._teachers)

    def endpoints(self) -> list[str]:
        with self._lock:
            return [t.endpoint for t in self._teachers]

    def actuate(self, service: str, desired: int) -> dict:
        """`ScalerController.serving_actuate` signature."""
        del service  # one actuator owns one service's pool
        return self.resize(desired)

    def resize(self, desired: int) -> dict:
        # a real span (not instant): it parents onto scaler.decide when
        # the controller drove it, and its [t0, t0+dur) window is what a
        # merged trace intersects the per-request serve.admit spans with
        # to attribute shed (tenant, class) traffic to THIS resize
        with trace.span("serve.resize", attrs={"service": self.service,
                                               "requested": desired}):
            return self._resize_locked_protocol(desired)

    def _resize_locked_protocol(self, desired: int) -> dict:
        requested = desired
        with self._lock:
            desired = max(self.min_teachers,
                          min(self.max_teachers, desired))
            self.desired = desired
            cur = len(self._teachers)
            self.resize_log.append({"from": cur, "to": desired,
                                    "ts": time.time()})
            victims: list[TeacherHandle] = []
            while len(self._teachers) > desired:
                # LIFO: the newest teacher retires first — the seniors
                # keep their warmed caches and long-lived client links
                victims.append(self._teachers.pop())
            to_spawn = desired - len(self._teachers)
        flight.record("resize", plane="serving", service=self.service,
                      frm=cur, to=desired)
        for handle in victims:
            self._begin_drain(handle)
        for _ in range(to_spawn):
            with self._lock:
                index = self._spawned
                self._spawned += 1
            handle = self.spawn(index)
            with self._lock:
                self._teachers.append(handle)
            log.info("pool %s: spawned teacher %s (-> %d)", self.service,
                     getattr(handle, "endpoint", "?"), desired)
        return {"desired_teachers": desired, "requested": requested,
                "clamped": desired != requested}

    def _begin_drain(self, handle: TeacherHandle) -> None:
        thread = threading.Thread(target=self._drain, args=(handle,),
                                  daemon=True,
                                  name=f"teacher-drain-{self.service}")
        thread.start()
        with self._lock:
            self._drains.append(thread)

    def _drain(self, handle: TeacherHandle) -> None:
        t0 = time.monotonic()
        entry = {"endpoint": getattr(handle, "endpoint", "?"),
                 "drained": False, "hard_killed": False, "wait_s": 0.0}
        try:
            handle.deregister()
        except Exception as exc:  # noqa: BLE001 — registry outage must
            # not leave the teacher serving forever; keep draining
            log.warning("deregister %s failed: %s", entry["endpoint"], exc)
        # duck-typed (getattr, not the Protocol): this module must stay
        # importable without the distill plane, and handles without
        # drain() keep the deregister-only behavior
        drain_fn = getattr(handle, "drain", None)
        if callable(drain_fn):
            try:
                drain_fn()
            except Exception as exc:  # noqa: BLE001 — a dying server
                # refusing the drain op still drains via deregistration
                log.warning("drain op on %s failed: %s",
                            entry["endpoint"], exc)
        deadline = t0 + self.drain_deadline_s
        quiet = 0
        while time.monotonic() < deadline:
            stats = handle.stats()
            if stats is None:
                entry["drained"] = True  # server already gone
                break
            if (stats.get("queue_depth", 0) == 0
                    and stats.get("inflight_groups", 0) == 0):
                quiet += 1
                if quiet >= self.drain_quiet_polls:
                    entry["drained"] = True
                    break
            else:
                quiet = 0
            time.sleep(self.drain_poll_s)
        entry["wait_s"] = round(time.monotonic() - t0, 3)
        try:
            if entry["drained"]:
                handle.stop()
                log.info("pool %s: drained %s in %.2fs", self.service,
                         entry["endpoint"], entry["wait_s"])
            else:
                entry["hard_killed"] = True
                handle.kill()
                log.warning("pool %s: drain of %s exceeded %.1fs; "
                            "hard-killed", self.service, entry["endpoint"],
                            self.drain_deadline_s)
        except Exception as exc:  # noqa: BLE001 — teardown
            log.warning("stopping %s failed: %s", entry["endpoint"], exc)
        with self._lock:
            self.drain_log.append(entry)
        flight.record("drain", plane="serving", service=self.service,
                      **entry)

    def wait_drains(self, timeout: float = 30.0) -> bool:
        """Join outstanding drain threads (tests, orderly shutdown)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            drains = list(self._drains)
        for thread in drains:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        return all(not t.is_alive() for t in drains)

    def close(self) -> None:
        """Tear the pool down (shutdown path, not a drain)."""
        with self._lock:
            teachers, self._teachers = self._teachers, []
        for handle in teachers:
            try:
                handle.deregister()
            except Exception:  # noqa: BLE001 — teardown
                pass
            try:
                handle.stop()
            except Exception:  # noqa: BLE001 — teardown
                pass
        self.wait_drains(timeout=5.0)
        obs_metrics.unregister(self._obs)


# -- the torch-free smoke ----------------------------------------------------


def selftest(verbose: bool = True) -> int:
    """Drive `ServingPolicy` over the deterministic `SimServingPool`
    traces and fail loudly unless the closed loop behaves:

      - steady load: zero resizes, 100% SLO attainment (no thrash);
      - 4x load step: the SLO is restored within a bounded number of
        ticks and the pool converges to the oracle size with zero
        post-convergence resizes;
      - burst: grows into the burst, drains back down after it.

    numpy- and torch-free: runnable on a scheduler node.
    """
    from edl_tpu_torch.scaler.simulator import (SimServingPool, burst,
                                                run_serving_policy, steady,
                                                step)

    def fresh_policy():
        return ServingPolicy(ServingConfig(
            slo_p95_ms=250.0, breach_ticks=2, idle_ticks=5,
            cooldown_s=15.0, max_teachers=16))

    failures: list[str] = []

    def check(cond: bool, what: str) -> None:
        if verbose:
            print(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    pool = SimServingPool("svc", steady(200.0), teachers=1,
                          max_teachers=16, tick_s=1.0, seed=0)
    out = run_serving_policy(pool, fresh_policy(), ticks=120)
    check(out["resizes"] == 0,
          f"steady: zero resizes (got {out['resizes']})")
    check(out["slo_attainment"] == 1.0,
          f"steady: 100% SLO attainment (got {out['slo_attainment']:.2%})")

    at = 40
    pool = SimServingPool("svc", step(100.0, 4.0, at=at), teachers=1,
                          max_teachers=16, tick_s=1.0, seed=0)
    out = run_serving_policy(pool, fresh_policy(), ticks=160)
    oracle = pool.oracle_teachers(400.0)
    check(out["last_violation_tick"] - at <= 25,
          f"step: SLO restored within 25 ticks (took "
          f"{out['last_violation_tick'] - at})")
    check(out["final_teachers"] == oracle,
          f"step: converged to oracle {oracle} "
          f"(got {out['final_teachers']})")
    check(out["post_convergence_resizes"] == 0,
          f"step: zero post-convergence resizes "
          f"(got {out['post_convergence_resizes']})")

    pool = SimServingPool("svc", burst(100.0, 4.0, at=30, length=25),
                          teachers=1, max_teachers=16, tick_s=1.0, seed=0)
    out = run_serving_policy(pool, fresh_policy(), ticks=200)
    check(out["resizes"] >= 2,
          f"burst: grew into and shrank out of the burst "
          f"(got {out['resizes']} resizes)")
    check(out["final_teachers"] == pool.oracle_teachers(100.0),
          f"burst: drained back to the steady oracle "
          f"(got {out['final_teachers']})")
    check(out["post_convergence_resizes"] == 0,
          f"burst: zero post-convergence resizes "
          f"(got {out['post_convergence_resizes']})")

    if verbose:
        print(f"serving selftest: {len(failures)} failure(s)")
    return 1 if failures else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.scaler.serving",
        description="Serving-elasticity plane (SLO-driven teacher pools)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("selftest",
                   help="torch-free sim smoke: ServingPolicy vs the "
                        "steady/step/burst traces (the CI gate)")
    args = parser.parse_args(argv)
    if args.cmd == "selftest":
        return selftest()
    return 2


if __name__ == "__main__":
    sys.exit(main())
