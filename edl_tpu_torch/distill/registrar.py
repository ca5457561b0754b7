"""Teacher registrar: put a serving endpoint into the distill registry
(copy of ``edl_tpu.distill.registrar``; the store through the port's
``redis_store.connect_store``).

Capability of the reference's ServerRegister CLIs
(discovery/register.py:29-143 and distill/redis/server_register.py:20-136):
wait until the teacher server answers TCP, then register it under the
service name with a TTL lease; the Registration keeps the lease alive and
re-registers after expiry (bounded retries). Deregistration on stop.

With ``stats_interval > 0`` the registrar also polls the teacher's
``stats`` op and publishes rows/s + utilization into the registry ``info``
field — the "report job performance to the scheduler" data path the
reference reserves the field for (discovery/register.py:36-40,
doc/edl_collective_design_doc.md:28-31). Consumers read it from the
registry (ServerMeta.info) or the discovery server's ``stats`` op.

CLI (run next to each teacher server):
    python -m edl_tpu_torch.distill.registrar --store 127.0.0.1:2379 \
        --service resnet_teacher --server 10.0.0.7:23900
"""

from __future__ import annotations

import argparse
import json
import threading
import time

from edl_tpu_torch.coord.redis_store import connect_store
from edl_tpu_torch.coord.registry import Registration, ServiceRegistry
from edl_tpu_torch.coord.store import Store
from edl_tpu_torch.utils import net
from edl_tpu_torch.utils.backoff import Backoff
from edl_tpu_torch.utils.exceptions import EdlRegisterError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.distill.registrar")

DISTILL_ROOT = "edl_distill"


class TeacherRegistrar:
    """Probe-then-register lifecycle for one teacher endpoint."""

    def __init__(self, store: Store, service: str, server: str, *,
                 info: str = "", ttl: float = 10.0, root: str = DISTILL_ROOT,
                 probe_timeout: float = 60.0, probe_interval: float = 0.5,
                 stats_interval: float = 0.0):
        self.registry = ServiceRegistry(store, root=root)
        self.service = service
        self.server = server
        self.info = info
        self.ttl = ttl
        self.probe_timeout = probe_timeout
        self.probe_interval = probe_interval
        self.stats_interval = stats_interval
        self._registration: Registration | None = None
        self._stats_stop = threading.Event()
        self._stats_thread: threading.Thread | None = None
        self._last_stats: dict | None = None

    def wait_alive(self) -> None:
        # jittered-exponential probing (utils/backoff.py): a pool of
        # registrars waiting out one slow teacher must not re-probe in
        # lockstep, and the deadline keeps a never-up server a typed
        # error instead of a forever-wedge
        backoff = Backoff(base=self.probe_interval,
                          max_delay=max(self.probe_interval, 2.0))
        deadline = time.monotonic() + self.probe_timeout
        while time.monotonic() < deadline:
            if net.is_endpoint_alive(self.server):
                return
            backoff.sleep()
        raise EdlRegisterError(
            f"teacher {self.server} not answering after {self.probe_timeout}s")

    def start(self) -> "TeacherRegistrar":
        self.wait_alive()
        self._registration = self.registry.register(
            self.service, self.server, info=self.info, ttl=self.ttl)
        log.info("registered teacher %s under %s", self.server, self.service)
        if self.stats_interval > 0:
            self._stats_thread = threading.Thread(
                target=self._stats_loop, daemon=True,
                name=f"teacher-stats-{self.server}")
            self._stats_thread.start()
        return self

    # -- utilization publishing ---------------------------------------------

    def _poll_stats(self) -> dict | None:
        from edl_tpu_torch.distill.teacher_server import TeacherClient
        try:
            client = TeacherClient(self.server, timeout=5.0)
        except OSError:
            return None
        try:
            return client.stats()
        except Exception:
            return None
        finally:
            client.close()

    def _utilization_info(self, cur: dict, prev: dict | None,
                          dt: float) -> str:
        from edl_tpu_torch.distill.teacher_server import latency_quantile
        from edl_tpu_torch.obs.metrics import Histogram
        d_rows = cur["served_rows"] - (prev or {}).get("served_rows", 0)
        d_busy = cur["busy_s"] - (prev or {}).get("busy_s", 0.0)
        # coalescing effectiveness over THIS window (mean device-batch
        # rows): a windowed delta like its siblings — a lifetime mean
        # would hide a teacher degrading to degenerate 1-request batches
        d_groups = (sum(cur.get("batch_rows_hist", {}).values())
                    - sum((prev or {}).get("batch_rows_hist", {}).values()))
        # latency over THIS window: difference the cumulative fixed-bucket
        # histograms (exact — the buckets line up by construction), so a
        # teacher going slow shows up within one stats interval instead
        # of being averaged away by its fast past. The SLO signal the
        # serving scaler consumes; null when the window served nothing.
        # The differencing is the shared obs Histogram primitive — the
        # same windowed-vs-cumulative contract the regression tests pin.
        d_lat = Histogram.window(cur.get("latency_hist_ms", {}),
                                 (prev or {}).get("latency_hist_ms", {}))
        # per-priority-class split of the same windowed signal (r23):
        # graceful degradation must be visible PER CLASS — a pool
        # shedding low while holding high's p95 looks healthy globally
        prev_by_cls = (prev or {}).get("latency_hist_ms_by_class", {})
        p95_by_class = {}
        for cls, hist in (cur.get("latency_hist_ms_by_class") or {}).items():
            p95 = latency_quantile(
                Histogram.window(hist, prev_by_cls.get(cls, {})), 0.95)
            if p95 is not None:
                p95_by_class[cls] = p95
        d_shed = (cur.get("rejected_total", 0)
                  - (prev or {}).get("rejected_total", 0))
        prev_rej = (prev or {}).get("rejected_by_class", {})
        shed_by_class = {
            cls: n - prev_rej.get(cls, 0)
            for cls, n in (cur.get("rejected_by_class") or {}).items()
            if n - prev_rej.get(cls, 0) > 0}
        return json.dumps({
            "rows_per_sec": round(d_rows / max(dt, 1e-9), 1),
            "util": round(min(1.0, d_busy / max(dt, 1e-9)), 3),
            "queue_depth": cur.get("queue_depth", 0),
            "inflight_groups": cur.get("inflight_groups", 0),
            "batch_rows_mean": round(d_rows / d_groups, 2) if d_groups
            else 0.0,
            "latency_ms_p50": latency_quantile(d_lat, 0.5),
            "latency_ms_p95": latency_quantile(d_lat, 0.95),
            "queue_depth_by_class": cur.get("queue_depth_by_class") or {},
            "latency_ms_p95_by_class": p95_by_class,
            "shed_per_sec": round(d_shed / max(dt, 1e-9), 2),
            "shed_by_class": shed_by_class,
            "draining": int(cur.get("draining", 0)),
        }, sort_keys=True)

    def _stats_loop(self) -> None:
        last_t = time.monotonic()
        while not self._stats_stop.wait(self.stats_interval):
            cur = self._poll_stats()
            now = time.monotonic()
            if cur is None or self._registration is None:
                continue
            try:
                info = self._utilization_info(cur, self._last_stats,
                                              now - last_t)
                self._registration.update_info(info)
            except Exception as exc:
                log.warning("utilization publish failed: %s", exc)
            self._last_stats, last_t = cur, now

    def stop(self, deregister: bool = True) -> None:
        self._stats_stop.set()
        if self._stats_thread is not None:
            self._stats_thread.join(timeout=2.0)
            self._stats_thread = None
        if self._registration is not None:
            self._registration.stop()
            self._registration = None
        if deregister:
            try:
                self.registry.deregister(self.service, self.server)
            except Exception as exc:
                log.warning("deregister failed: %s", exc)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.distill.registrar",
        description="Register a teacher inference server for discovery")
    parser.add_argument("--store", default="127.0.0.1:2379")
    parser.add_argument("--service", required=True)
    parser.add_argument("--server", required=True, help="host:port to expose")
    parser.add_argument("--info", default="",
                        help="opaque utilization/meta string")
    parser.add_argument("--ttl", type=float, default=10.0)
    parser.add_argument("--root", default=DISTILL_ROOT)
    parser.add_argument("--probe-timeout", type=float, default=60.0)
    parser.add_argument("--stats-interval", type=float, default=5.0,
                        help="seconds between utilization publishes "
                             "(0 disables)")
    args = parser.parse_args(argv)
    registrar = TeacherRegistrar(
        connect_store(args.store), args.service, args.server, info=args.info,
        ttl=args.ttl, root=args.root, probe_timeout=args.probe_timeout,
        stats_interval=args.stats_interval)
    registrar.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        registrar.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
