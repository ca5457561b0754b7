"""JobServer/JobClient: the desired node count of one job, over HTTP/JSON
(port of ``edl_tpu.collective.job_server``).

A small control server publishes the job's *desired node count*
(``GET /job``) and takes resizes (``POST /resize {"desired": n}``, the
scaler's actuation path, with its trace context in the ``X-EDL-Trace``
header); a client keeps that many launcher processes running on this
host, so a served resize becomes a membership change the launchers act
on. ``--time-interval-to-change S`` injects a random resize every S
seconds (the timed-resize fault). With a store attached, every served
resize publishes a monotonic migration epoch and the donor roster alive
at the decision (``collective/migration.publish_resize_epoch``). The
wire is the JAX package's: either package's client talks to either
package's server.

  python -m edl_tpu_torch.collective.job_server --port 8180 \
      --nodes-range 2:4 --time-interval-to-change 900
  python -m edl_tpu_torch.collective.job_server client --server :8180 -- \
      python -m edl_tpu_torch.collective.launch ... -- python -m ...
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from edl_tpu_torch.obs import recorder as flight
from edl_tpu_torch.obs import trace
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.collective.job_server")


class JobState:
    def __init__(self, job_id: str, min_nodes: int, max_nodes: int,
                 desired: int | None = None, seed: int = 0,
                 store=None):
        self.job_id = job_id
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        if desired is None:
            desired = max_nodes
        self.desired = max(min_nodes, min(max_nodes, desired))
        self._rng = random.Random(seed)
        # every desired_nodes change this server actually served, in
        # order — the audit trail demos/tests cross-check against the
        # scaler's decision journal (a resize NOT in the journal is a
        # scaler acting outside its own observability surface)
        self.resize_log: list[dict] = []
        # RLock: resize()/random_resize() return snapshot() while holding it.
        self._lock = threading.RLock()
        # Migration plane: with a coordination store attached, every
        # served resize publishes a monotonic migration epoch + the
        # donor roster alive at the decision instant (the fencing/audit
        # record peers and the --resize-p2p demo key on).
        self.store = store
        self._migration_epoch = 0

    def attach_store(self, store) -> None:
        with self._lock:
            self.store = store

    def _publish_migration_epoch(self, prev: int) -> None:
        # caller holds self._lock (epoch ordering must match resize_log)
        if self.store is None:
            return
        from edl_tpu_torch.collective import migration as mig
        self._migration_epoch += 1
        try:
            mig.publish_resize_epoch(self.store, self.job_id,
                                     epoch=self._migration_epoch,
                                     desired=self.desired, prev=prev)
        except Exception as exc:  # noqa: BLE001 — best-effort: the
            # resize itself must be served even if the store hiccups
            log.warning("migration epoch publish failed: %s", exc)

    def snapshot(self) -> dict:
        with self._lock:
            return {"job_id": self.job_id, "desired_nodes": self.desired,
                    "min_nodes": self.min_nodes,
                    "max_nodes": self.max_nodes}

    def resize(self, desired: int) -> dict:
        with self._lock:
            clamped = not (self.min_nodes <= desired <= self.max_nodes)
            prev = self.desired
            self.desired = max(self.min_nodes,
                               min(self.max_nodes, desired))
            self.resize_log.append({"from": prev, "to": self.desired,
                                    "requested": desired,
                                    "clamped": clamped,
                                    "source": "resize"})
            # flight-recorder witness: one event per SERVED resize, in
            # log order, beside resize_log and the scaler journal
            flight.record("resize", plane="job", job_id=self.job_id,
                          frm=prev, to=self.desired, source="resize",
                          epoch=self._migration_epoch
                          + (1 if self.desired != prev else 0))
            if self.desired != prev:
                self._publish_migration_epoch(prev)
            if clamped:
                # loud, not silent: the scaler journals the response, so
                # a clamp must be visible there and in this log
                log.warning("resize request %d clamped to %d "
                            "(range [%d, %d])", desired, self.desired,
                            self.min_nodes, self.max_nodes)
            else:
                log.info("desired_nodes -> %d", self.desired)
            snap = self.snapshot()
            snap["clamped"] = clamped
            if clamped:
                snap["requested"] = desired
            return snap

    def random_resize(self) -> dict:
        """Fault injection: pick a different node count in [min, max]."""
        with self._lock:
            choices = [n for n in range(self.min_nodes, self.max_nodes + 1)
                       if n != self.desired] or [self.desired]
            prev = self.desired
            self.desired = self._rng.choice(choices)
            self.resize_log.append({"from": prev, "to": self.desired,
                                    "requested": self.desired,
                                    "clamped": False, "source": "fault"})
            flight.record("resize", plane="job", job_id=self.job_id,
                          frm=prev, to=self.desired, source="fault",
                          epoch=self._migration_epoch
                          + (1 if self.desired != prev else 0))
            if self.desired != prev:
                self._publish_migration_epoch(prev)
            log.info("fault injection: desired_nodes -> %d", self.desired)
            return self.snapshot()


def _make_handler(state: JobState):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, obj: dict, code: int = 200) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/job"):
                self._reply(state.snapshot())
            else:
                self._reply({"error": "not found"}, 404)

        def do_POST(self):
            if self.path.rstrip("/") != "/resize":
                self._reply({"error": "not found"}, 404)
                return
            # Validate the payload explicitly: every malformed request —
            # bad JSON, non-object body, missing/non-integer `desired` —
            # is a 400 with an error body, never a handler 500.
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except (json.JSONDecodeError, UnicodeDecodeError) as exc:
                self._reply({"error": f"malformed JSON: {exc}"}, 400)
                return
            if not isinstance(payload, dict):
                self._reply({"error": "payload must be a JSON object"},
                            400)
                return
            if "desired" not in payload:
                self._reply({"error": "missing field 'desired'"}, 400)
                return
            desired = payload["desired"]
            if isinstance(desired, bool) \
                    or isinstance(desired, float) \
                    and not desired.is_integer():
                self._reply({"error": f"'desired' must be an integer, "
                                      f"got {desired!r}"}, 400)
                return
            try:
                desired = int(desired)
            except (TypeError, ValueError):
                self._reply({"error": f"'desired' must be an integer, "
                                      f"got {desired!r}"}, 400)
                return
            # Trace seam (HTTP hop): a caller's span context arrives in
            # the X-EDL-Trace header; the served resize — including the
            # epoch publication inside it, which embeds the context for
            # the trainers — becomes a child span of the decision.
            ctx = trace.parse_context(
                (self.headers.get("X-EDL-Trace") or "").split(":")
                if self.headers.get("X-EDL-Trace") else None)
            with trace.adopt(ctx):
                with trace.span("resize.actuate",
                                attrs={"job": state.job_id,
                                       "desired": desired}):
                    self._reply(state.resize(desired))

        def log_message(self, fmt, *args):  # route into our logger
            log.debug("http: " + fmt, *args)

    return Handler


class JobServer:
    def __init__(self, state: JobState, port: int = 8180,
                 host: str = "127.0.0.1",
                 time_interval_to_change: float = 0.0):
        # /resize is unauthenticated, so external binding ("0.0.0.0") is an
        # explicit operator opt-in (--host), never the default.
        self.state = state
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(state))
        self.port = self.httpd.server_address[1]
        self.interval = time_interval_to_change
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> "JobServer":
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="job-server-http")
        t.start()
        self._threads.append(t)
        if self.interval > 0:
            f = threading.Thread(target=self._fault_loop, daemon=True,
                                 name="job-server-faults")
            f.start()
            self._threads.append(f)
        log.info("JobServer on :%d desired=%d", self.port,
                 self.state.desired)
        return self

    def _fault_loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.state.random_resize()

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()


def get_job(server: str, timeout: float = 5.0) -> dict:
    if server.startswith(":"):
        server = "127.0.0.1" + server
    if not server.startswith("http"):
        server = "http://" + server
    with urllib.request.urlopen(server + "/job", timeout=timeout) as r:
        return json.loads(r.read())


def request_resize(server: str, desired: int, timeout: float = 5.0) -> dict:
    if server.startswith(":"):
        server = "127.0.0.1" + server
    if not server.startswith("http"):
        server = "http://" + server
    # Trace root of a resize (unless the caller — e.g. the scaler's
    # decide span — already has one): the context rides the HTTP hop as
    # X-EDL-Trace, so actuation/adoption/restore all join this trace.
    with trace.span("resize.request", attrs={"desired": desired}):
        headers = {"Content-Type": "application/json"}
        ctx = trace.inject()
        if ctx is not None:
            headers["X-EDL-Trace"] = ":".join(ctx)
        req = urllib.request.Request(
            server + "/resize", method="POST",
            data=json.dumps({"desired": desired}).encode(),
            headers=headers)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())


class JobClient:
    """Keeps `desired_nodes` launcher processes running on this host.

    The single-host topology: each launcher it spawns is one elastic pod;
    shrinking terminates the newest launchers and the survivors carry on
    in the smaller world (in place under live migration, else by
    stop-resume).
    """

    def __init__(self, server: str, launcher_cmd: list[str],
                 poll: float = 2.0):
        self.server = server
        self.launcher_cmd = launcher_cmd
        self.poll = poll
        self.procs: list[subprocess.Popen] = []
        self._stop = threading.Event()

    def _reap(self) -> None:
        self.procs = [p for p in self.procs if p.poll() is None]

    def reconcile(self, desired: int) -> None:
        self._reap()
        while len(self.procs) < desired:
            p = subprocess.Popen(self.launcher_cmd,
                                 start_new_session=True)
            log.info("spawned launcher pid=%d (%d/%d)", p.pid,
                     len(self.procs) + 1, desired)
            self.procs.append(p)
        while len(self.procs) > desired:
            p = self.procs.pop()
            log.info("stopping launcher pid=%d", p.pid)
            p.terminate()

    def run(self) -> int:
        try:
            while not self._stop.is_set():
                try:
                    job = get_job(self.server)
                except OSError as exc:
                    log.warning("job server unreachable: %s", exc)
                    time.sleep(self.poll)
                    continue
                self.reconcile(int(job["desired_nodes"]))
                self._reap()
                if not self.procs and int(job["desired_nodes"]) == 0:
                    return 0
                time.sleep(self.poll)
        finally:
            for p in self.procs:
                p.terminate()
        return 0

    def stop(self) -> None:
        self._stop.set()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "client":
        parser = argparse.ArgumentParser(
            prog="edl_tpu_torch job_server client")
        parser.add_argument("--server", default=":8180")
        parser.add_argument("--poll", type=float, default=2.0)
        parser.add_argument("cmd", nargs=argparse.REMAINDER)
        args = parser.parse_args(argv[1:])
        cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
        if not cmd:
            parser.error("missing launcher command (after --)")
        return JobClient(args.server, cmd, poll=args.poll).run()

    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.collective.job_server")
    parser.add_argument("--job-id", default="default_job")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (0.0.0.0 exposes the "
                             "unauthenticated /resize endpoint)")
    parser.add_argument("--port", type=int, default=8180)
    parser.add_argument("--nodes-range", default="1:4")
    parser.add_argument("--desired", type=int, default=None)
    parser.add_argument("--time-interval-to-change", type=float, default=0.0,
                        help="fault injection: random resize every S seconds")
    parser.add_argument("--seed", type=int, default=0)
    # scaler-driven mode: resizes come from the utilization-driven
    # decision plane (edl_tpu_torch/scaler) instead of the fault injector
    parser.add_argument("--scaler", action="store_true",
                        help="drive desired_nodes from the autoscaler "
                             "(requires --store)")
    parser.add_argument("--store", default=None,
                        help="coordination store endpoint (required by "
                             "--scaler; with or without it, /resize "
                             "publishes migration epochs + donor "
                             "rosters for p2p state migration)")
    parser.add_argument("--scaler-interval", type=float, default=None,
                        help="decision interval s "
                             "(EDL_TPU_SCALER_INTERVAL)")
    parser.add_argument("--scaler-journal", default=None,
                        help="JSON-lines decision journal file")
    parser.add_argument("--dry-run", action="store_true",
                        help="scaler journals decisions without resizing")
    args = parser.parse_args(argv)
    if args.scaler and not args.store:
        parser.error("--scaler requires --store")
    lo, hi = (int(x) for x in args.nodes_range.split(":"))
    state = JobState(args.job_id, lo, hi, desired=args.desired,
                     seed=args.seed)
    server = JobServer(state, port=args.port, host=args.host,
                       time_interval_to_change=args.time_interval_to_change)
    server.start()
    controller = store = None
    if args.store:
        from edl_tpu_torch.coord.redis_store import connect_store
        store = connect_store(args.store)
        state.attach_store(store)
    if args.scaler:
        from edl_tpu_torch.scaler.controller import (ScalerConfig,
                                                     ScalerController)
        from edl_tpu_torch.scaler.policy import ThroughputPolicy
        from edl_tpu_torch.utils.config import from_env
        overrides = ({"interval": args.scaler_interval}
                     if args.scaler_interval is not None else {})
        config = from_env(ScalerConfig, **overrides)
        config.min_nodes, config.max_nodes = lo, hi
        # in-process actuation: no HTTP hop for limits or /resize
        controller = ScalerController(
            store, [args.job_id],
            ThroughputPolicy(gain_threshold=config.gain_threshold,
                             cooldown_s=config.cooldown_s),
            config=config, dry_run=args.dry_run,
            journal_path=args.scaler_journal,
            actuate=lambda _job, desired: state.resize(desired)).start()
        log.info("scaler-driven mode: decisions every %.1fs",
                 config.interval)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if controller is not None:
            controller.stop()
        if store is not None:
            store.close()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
