"""Admission control for the teacher serving tier (copy of
``edl_tpu.distill.admission``: the same WFQ, typed rejects and
``EDL_TPU_SERVE_*`` knobs).

Sits between the wire handlers and the Batcher's device pipeline: every
predict request passes ``AdmissionQueue.submit`` before it may occupy
intake. Three verdicts:

  * admitted — enqueued on the (priority class, tenant) flow; the
    batcher pops flows by weighted fair queueing (strict FIFO within a
    flow, virtual-time WFQ across flows, flow weight = its class
    weight), so one chatty tenant cannot starve the others and the high
    class drains ahead of low under contention;
  * rejected (queue-full) — the flow already holds ``queue_cap``
    requests. Bounded per-tenant queues are the memory/latency
    protection: past the cap the request is answered immediately with a
    typed retry-after instead of joining a collapsing backlog;
  * rejected (overload shed) — the class's estimated queue wait
    (backlog rows / measured service rate, scaled by the class's WFQ
    share) exceeds its delay budget. Budgets scale with class weight
    (``shed_ms`` is the NORMAL class budget), so under sustained
    overload the low class sheds first and the high class keeps its
    SLO — degradation per class, never global.

A rejection is a normal wire response ``{"ok": false, "rejected": true,
"retry_after_ms": R}`` — the connection stays open; `TeacherClient`
raises the typed `TeacherRejected` and the reader retries elsewhere
after a jittered backoff (reader.py).

Draining (`begin_drain`) flips every subsequent submit to a rejection
while already-admitted work drains normally — the piece that lets a
scale-down complete every in-flight request with zero hard kills
(scaler/serving.py drain protocol).

Pure stdlib + threading. doc/design_distill.md ("Continuous batching +
admission control") is the design note.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from edl_tpu_torch.utils.config import field, from_env

# Priority classes, highest first. Unknown class names degrade to
# "normal" instead of failing the request — an old client never breaks
# against a new server.
PRIORITIES = ("high", "normal", "low")
DEFAULT_CLASS_WEIGHTS = "high=4,normal=2,low=1"

# retry_after bounds (ms): never tell a client "come back in 0 ms"
# (thundering retry) nor park it for longer than a drain/resize takes.
RETRY_AFTER_MIN_MS = 25.0
RETRY_AFTER_MAX_MS = 2000.0

# service-rate estimation window; the overload rule stays disarmed until
# at least this many rows were served (a cold server never sheds on a
# garbage rate estimate).
RATE_WINDOW_S = 5.0
RATE_MIN_ROWS = 32


def parse_class_weights(spec: str) -> dict[str, float]:
    """``"high=4,normal=2,low=1"`` -> weight map (missing classes get
    weight 1; junk entries are ignored rather than fatal — this rides
    an env knob)."""
    weights = {c: 1.0 for c in PRIORITIES}
    for part in (spec or "").split(","):
        if "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            w = float(val)
        except ValueError:
            continue
        if name.strip() in weights and w > 0:
            weights[name.strip()] = w
    return weights


def normalize_priority(priority: str | None) -> str:
    p = (priority or "normal").strip().lower()
    return p if p in PRIORITIES else "normal"


@dataclass
class AdmissionConfig:
    """Knobs for the serving admission plane (env-overridable)."""
    # continuous: admit new requests into the forming device batch each
    # step; window: the r6 coalesce-window behavior (kept for A/B).
    batching: str = field("continuous", env="EDL_TPU_SERVE_BATCHING")
    # bounded per-(tenant, class) queue; past it submits reject.
    queue_cap: int = field(512, env="EDL_TPU_SERVE_ADMIT_CAP")
    # WFQ flow weights per priority class (also scales shed budgets).
    class_weights: str = field(DEFAULT_CLASS_WEIGHTS,
                               env="EDL_TPU_SERVE_CLASS_WEIGHTS")
    # delay budget of the NORMAL class in ms; other classes scale by
    # weight ratio (high waits longest before shedding). <= 0 disables
    # the overload-shed rule (the queue cap still bounds admission).
    shed_ms: float = field(0.0, env="EDL_TPU_SERVE_SHED_MS")

    @classmethod
    def from_env(cls, **overrides) -> "AdmissionConfig":
        return from_env(cls, **overrides)


class AdmissionReject(Exception):
    """Typed admission rejection: carries the retry-after hint that goes
    out on the wire verbatim."""

    def __init__(self, reason: str, retry_after_ms: float,
                 tenant: str = "default", priority: str = "normal"):
        super().__init__(f"admission rejected ({reason}): "
                         f"tenant={tenant} class={priority} "
                         f"retry_after_ms={retry_after_ms:.0f}")
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)
        self.tenant = tenant
        self.priority = priority


def _clamp_retry(ms: float) -> float:
    return min(max(ms, RETRY_AFTER_MIN_MS), RETRY_AFTER_MAX_MS)


class _Flow:
    """One (class, tenant) FIFO with its WFQ virtual finish time."""

    __slots__ = ("items", "vtime", "weight")

    def __init__(self, weight: float, vtime: float):
        self.items: deque = deque()
        self.vtime = vtime
        self.weight = weight


class AdmissionQueue:
    """Bounded multi-tenant intake replacing the Batcher's plain Queue.

    All state lives under one lock + condition; pops are O(#active
    flows) — flows are (class, tenant) pairs, a handful in practice.
    Items are opaque (the Batcher's _Request objects); this module knows
    only their row counts.
    """

    def __init__(self, config: AdmissionConfig | None = None, *,
                 clock=time.monotonic):
        self.config = config or AdmissionConfig()
        self._weights = parse_class_weights(self.config.class_weights)
        self._clock = clock
        self._cv = threading.Condition()
        self._flows: dict[tuple[str, str], _Flow] = {}  # guarded-by: _cv
        self._vclock = 0.0               # guarded-by: _cv
        self._rows_queued: dict[str, int] = {
            c: 0 for c in PRIORITIES}    # guarded-by: _cv
        self._n_queued = 0               # guarded-by: _cv
        self._admitted = 0               # guarded-by: _cv
        self._rejected = 0               # guarded-by: _cv
        self._rejected_by_class: dict[str, int] = {
            c: 0 for c in PRIORITIES}    # guarded-by: _cv
        self._rejected_by_reason: dict[str, int] = {}  # guarded-by: _cv
        self._served_window: deque = deque()  # (t, rows)  guarded-by: _cv
        self._draining = False           # guarded-by: _cv
        self._closed = False             # guarded-by: _cv

    # -- service-rate estimate (fed by the batcher's complete stage) ----

    def note_served(self, rows: int) -> None:
        now = self._clock()
        with self._cv:
            self._served_window.append((now, rows))
            self._trim_window(now)

    def _trim_window(self, now: float) -> None:
        w = self._served_window
        while w and now - w[0][0] > RATE_WINDOW_S:
            w.popleft()

    def _service_rate(self, now: float) -> float | None:
        """rows/s over the recent window; None until warmed up."""
        self._trim_window(now)
        if not self._served_window:
            return None
        rows = sum(r for _, r in self._served_window)
        if rows < RATE_MIN_ROWS:
            return None
        elapsed = max(now - self._served_window[0][0], 0.05)
        return rows / elapsed

    # -- admission ------------------------------------------------------

    def _budget_ms(self, cls: str) -> float:
        base = self.config.shed_ms
        return base * self._weights[cls] / self._weights["normal"]

    def _est_wait_ms(self, cls: str, rate: float) -> float:
        """Expected queue wait of a NEW arrival in ``cls``: the class's
        backlog divided by its WFQ share of the service rate. Classes
        with no backlog take no share (WFQ is work-conserving)."""
        active = [c for c in PRIORITIES if self._rows_queued[c] > 0
                  or c == cls]
        share = self._weights[cls] / sum(self._weights[c] for c in active)
        return self._rows_queued[cls] / max(rate * share, 1e-6) * 1e3

    def submit(self, item, rows: int, tenant: str = "default",
               priority: str = "normal") -> None:
        """Admit ``item`` or raise `AdmissionReject`. Never blocks."""
        cls = normalize_priority(priority)
        tenant = tenant or "default"
        now = self._clock()
        with self._cv:
            if self._closed or self._draining:
                self._count_reject(cls, "draining")
                raise AdmissionReject("draining", _clamp_retry(250.0),
                                      tenant, cls)
            key = (cls, tenant)
            flow = self._flows.get(key)
            if flow is not None and len(flow.items) >= self.config.queue_cap:
                rate = self._service_rate(now)
                hint = (self._est_wait_ms(cls, rate) if rate
                        else RETRY_AFTER_MAX_MS / 4)
                self._count_reject(cls, "queue-full")
                raise AdmissionReject("queue-full", _clamp_retry(hint),
                                      tenant, cls)
            if self.config.shed_ms > 0:
                rate = self._service_rate(now)
                if rate is not None:
                    wait_ms = self._est_wait_ms(cls, rate)
                    budget = self._budget_ms(cls)
                    if wait_ms > budget:
                        self._count_reject(cls, "overload")
                        raise AdmissionReject(
                            "overload", _clamp_retry(wait_ms - budget),
                            tenant, cls)
            if flow is None:
                # a newly-active flow starts at the current virtual
                # time, not its stale history — an idle flow must not
                # bank credit and then monopolize the scheduler
                flow = _Flow(self._weights[cls], self._vclock)
                self._flows[key] = flow
            flow.items.append((item, rows))
            self._rows_queued[cls] += rows
            self._n_queued += 1
            self._admitted += 1
            self._cv.notify()

    def _count_reject(self, cls: str, reason: str) -> None:  # holds-lock: _cv
        self._rejected += 1
        self._rejected_by_class[cls] += 1
        self._rejected_by_reason[reason] = (
            self._rejected_by_reason.get(reason, 0) + 1)

    # -- WFQ pop --------------------------------------------------------

    def _pop_locked(self):  # holds-lock: _cv
        best_key, best = None, None
        for key, flow in self._flows.items():
            if not flow.items:
                continue
            if best is None or flow.vtime < best.vtime:
                best_key, best = key, flow
        if best is None:
            return None
        item, rows = best.items.popleft()
        best.vtime += rows / best.weight
        self._vclock = max(self._vclock, best.vtime)
        cls = best_key[0]
        self._rows_queued[cls] -= rows
        self._n_queued -= 1
        if not best.items:
            # drop idle flows so the by-tenant stats dict stays bounded
            del self._flows[best_key]
        return item

    def get(self, timeout: float | None = None):
        """Next item by WFQ order; None on timeout or once closed."""
        deadline = (self._clock() + timeout) if timeout is not None else None
        with self._cv:
            while True:
                item = self._pop_locked()
                if item is not None:
                    return item
                if self._closed:
                    return None
                if deadline is None:
                    self._cv.wait()
                    continue
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def get_nowait(self):
        with self._cv:
            return self._pop_locked()

    # -- lifecycle / introspection --------------------------------------

    def begin_drain(self) -> None:
        with self._cv:
            self._draining = True

    @property
    def draining(self) -> bool:
        with self._cv:
            return self._draining

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def qsize(self) -> int:
        with self._cv:
            return self._n_queued

    def stats(self) -> dict:
        """Counters merged into Batcher.stats() (flat + one-level dicts
        so the obs plane renders them as labeled gauges)."""
        with self._cv:
            by_class = {c: 0 for c in PRIORITIES}
            by_tenant: dict[str, int] = {}
            for (cls, tenant), flow in self._flows.items():
                n = len(flow.items)
                by_class[cls] += n
                by_tenant[tenant] = by_tenant.get(tenant, 0) + n
            return {
                "admitted_total": self._admitted,
                "rejected_total": self._rejected,
                "rejected_by_class": dict(self._rejected_by_class),
                "rejected_by_reason": dict(self._rejected_by_reason),
                "queue_depth_by_class": by_class,
                "queue_depth_by_tenant": by_tenant,
                "draining": int(self._draining),
            }
