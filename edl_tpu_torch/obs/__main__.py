"""CLI for the observability plane (port of ``edl_tpu.obs.__main__``).

    python -m edl_tpu_torch.obs trace <dir> [--chrome out.json] [--json]
        Merge every process's span file into per-trace trees; print
        them (or a machine-readable phase summary with --json) and
        optionally export Chrome-trace/Perfetto JSON.

    python -m edl_tpu_torch.obs selftest
        Exercises the metrics, trace and recorder legs end to end and
        asserts the plane imported neither torch nor numpy.

Both commands print what the JAX package's CLI prints for the same span
files.
"""

from __future__ import annotations

import argparse
import json
import sys


def _fmt_dur(s: float) -> str:
    return f"{s * 1e3:.1f}ms" if s < 1.0 else f"{s:.3f}s"


def run_trace(args) -> int:
    from edl_tpu_torch.obs import trace

    spans = trace.load_spans(args.dir)
    if not spans:
        print(f"no spans under {args.dir}", file=sys.stderr)
        return 1
    traces = trace.group_traces(spans)
    summary = trace.resize_phase_summary(spans)
    if args.chrome:
        with open(args.chrome, "w") as fh:
            json.dump(trace.to_chrome(spans), fh)
        print(f"chrome trace -> {args.chrome} ({len(spans)} spans, "
              f"{len(traces)} traces)", file=sys.stderr)
    if args.json:
        print(json.dumps({"traces": len(traces), "spans": len(spans),
                          "resizes": summary}, sort_keys=True))
        return 0
    for tid, tspans in sorted(traces.items(),
                              key=lambda kv: kv[1][0].get("t0", 0.0)):
        t0 = min(s.get("t0", 0.0) for s in tspans)
        total = max(s.get("t0", 0.0) + s.get("dur", 0.0)
                    for s in tspans) - t0
        print(f"trace {tid}  spans={len(tspans)} "
              f"span={_fmt_dur(total)}")
        for s, depth in trace.span_tree(tspans):
            offset = s.get("t0", 0.0) - t0
            attrs = s.get("attrs") or {}
            extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            print(f"  {'  ' * depth}{s['name']} "
                  f"+{_fmt_dur(offset)} {_fmt_dur(s.get('dur', 0.0))} "
                  f"[pid {s.get('pid')}]" + (f" {extra}" if extra else ""))
    if summary:
        print("resize phase breakdown:")
        for r in summary:
            phases = " ".join(f"{k}={_fmt_dur(v)}"
                              for k, v in r["phases"].items())
            print(f"  {r['trace_id']}: downtime={_fmt_dur(r['downtime_s'])}"
                  f" {phases}")
    return 0


def selftest(verbose: bool = True) -> int:
    import os
    import tempfile
    import urllib.request

    # the plane must not pull torch or numpy in: from the CLI nothing is
    # preloaded, so this is absolute; an in-process caller (pytest) may
    # already carry them, so the check is "we did not ADD them"
    pre = {m: m in sys.modules for m in ("torch", "numpy")}

    from edl_tpu_torch.obs import metrics, recorder, trace
    from edl_tpu_torch.utils import config

    def check(name: str, ok: bool) -> bool:
        if verbose:
            print(f"  {'ok' if ok else 'FAIL'}  {name}")
        return ok

    ok = True

    # -- metrics leg -------------------------------------------------------
    reg = metrics.Registry()
    c = reg.counter("selftest_ops", "ops")
    c.inc()
    c.inc(2)
    ok &= check("counter accumulates", c.value == 3.0
                and reg.counter("selftest_ops") is c)
    g = reg.gauge("selftest_depth")
    g.set(7)
    h = reg.histogram("selftest_latency_ms", metrics.LOG_BUCKETS_MS)
    for v in (0.5, 3.0, 3.0, 40.0, 99999.0):
        h.observe(v)
    snap1 = h.snapshot()
    h.observe(3.0)
    win = metrics.Histogram.window(h.snapshot(), snap1)
    ok &= check("histogram windows difference exactly", win == {5.0: 1})
    ok &= check("conservative quantile answers the upper edge",
                metrics.Histogram.quantile(snap1, 0.5) == 5.0
                and metrics.Histogram.quantile({}, 0.5) is None)
    handle = reg.register_stats("selftest_src", lambda: {"queue_depth": 3,
                                                         "hist": {"8": 2}})
    reg.register_stats("selftest_bad", lambda: 1 / 0)
    snap = reg.snapshot()
    ok &= check("stats sources snapshot, a throwing one skipped",
                snap["sources"] == {"selftest_src/0": {"queue_depth": 3,
                                                       "hist": {"8": 2}}})
    text = reg.render()
    ok &= check("prometheus text: counter/gauge lines",
                "edl_selftest_ops 3" in text
                and "edl_selftest_depth 7" in text)
    ok &= check("prometheus text: cumulative buckets + +Inf",
                'edl_selftest_latency_ms_bucket{le="+Inf"} 6' in text
                and "edl_selftest_latency_ms_count 6" in text)
    ok &= check("stats dict rendered as gauges",
                'edl_selftest_src_queue_depth{iid="0"} 3' in text
                and 'bucket="8"' in text)
    srv = metrics.MetricsServer(reg, port=0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read()
        ok &= check("scrape endpoint serves the same text",
                    b"edl_selftest_ops 3" in body)
        scraped = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/snapshot", timeout=5).read())
        ok &= check("snapshot endpoint carries sources",
                    scraped["sources"]["selftest_src/0"]["queue_depth"]
                    == 3)
    finally:
        srv.close()
    reg.unregister(handle)
    ok &= check("unregister drops the source",
                "selftest_src/0" not in reg.snapshot()["sources"])

    # -- trace leg ---------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="edl-obs-selftest-") as tmp:
        prev = config.env_str("EDL_TPU_TRACE")
        os.environ["EDL_TPU_TRACE"] = tmp
        trace.reconfigure()
        try:
            with trace.span("resize.request", attrs={"desired": 2}) as root:
                msg = trace.attach({"op": "put"})
                ctx = trace.extract(dict(msg))
                with trace.adopt(ctx):
                    with trace.span("resize.actuate"):
                        pass
                root.attrs["note"] = "selftest"
            spans = trace.load_spans(tmp)
            ok &= check("wire attach/extract keeps one trace",
                        len({s["tid"] for s in spans}) == 1
                        and len(spans) == 2)
            tree = trace.span_tree(spans)
            ok &= check("child parents onto the propagated span",
                        [(s["name"], d) for s, d in tree]
                        == [("resize.request", 0), ("resize.actuate", 1)])
            ok &= check("garbled context degrades to None",
                        trace.parse_context(["x"]) is None
                        and trace.parse_context("junk") is None
                        and trace.parse_context([1, 2]) is None)
            chrome = trace.to_chrome(spans)
            ok &= check("chrome export shape",
                        len(chrome["traceEvents"]) == 2
                        and all(e["ph"] == "X"
                                for e in chrome["traceEvents"]))
            summary = trace.resize_phase_summary(spans)
            ok &= check("resize phase summary sees the trace",
                        len(summary) == 1
                        and "actuation" in summary[0]["phases"])
        finally:
            if prev is None:
                os.environ.pop("EDL_TPU_TRACE", None)
            else:
                os.environ["EDL_TPU_TRACE"] = prev
            trace.reconfigure()

    # -- recorder leg ------------------------------------------------------
    rec = recorder.FlightRecorder(capacity=8)
    for i in range(20):
        rec.record("resize", to=i)
    ok &= check("ring bounded with dropped accounting",
                len(rec.events()) == 8 and rec.dropped == 12
                and rec.events("resize")[-1]["to"] == 19)
    with tempfile.TemporaryDirectory(prefix="edl-obs-selftest-") as tmp:
        path = rec.dump(os.path.join(tmp, "flight.json"))
        with open(path) as fh:
            doc = json.load(fh)
        ok &= check("dump round-trips the ring",
                    len(doc["events"]) == 8 and doc["dropped"] == 12)
    off = recorder.FlightRecorder(capacity=0)
    off.record("resize", to=1)
    ok &= check("capacity 0 disables recording", off.events() == [])

    ok &= check("no torch or numpy import crept in",
                all((m in sys.modules) == was for m, was in pre.items()))
    print("obs selftest:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m edl_tpu_torch.obs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_trace = sub.add_parser("trace", help="merge + view span files")
    p_trace.add_argument("dir", nargs="?", default="edl_trace",
                         help="span sink directory (EDL_TPU_TRACE)")
    p_trace.add_argument("--chrome", help="write Chrome-trace JSON here")
    p_trace.add_argument("--json", action="store_true",
                         help="machine-readable phase summary")
    sub.add_parser("selftest", help="torch-free self-check")
    args = parser.parse_args(argv)
    if args.cmd == "trace":
        return run_trace(args)
    return selftest()


if __name__ == "__main__":
    raise SystemExit(main())
