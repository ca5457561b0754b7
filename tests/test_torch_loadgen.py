"""The port's open-loop load generator (distill/loadgen.py) against the
JAX package's: ``LoadStats`` under an injected clock gives the same
summary and oracles for one event script; ``run_open_loop`` drives two
of the port's TeacherServers on the CPU, never leaves a request without
an outcome, fails over when one teacher is stopped unannounced, and
carries a caller's feed."""

import threading
import time

import numpy as np
import pytest

from edl_tpu.distill import loadgen as jax_lg
from edl_tpu_torch.distill import loadgen as pt_lg


def script_stats(mod, seed: int):
    """Replay a seeded event script into ``mod.LoadStats`` on a fake
    clock; returns the summary (with and without SLOs) and the oracles."""
    rng = np.random.default_rng(seed)
    now = [100.0]
    stats = mod.LoadStats(clock=lambda: now[0])
    for _ in range(300):
        now[0] += float(rng.exponential(0.01))
        cls = str(rng.choice(["high", "normal", "low"]))
        stats.note_offered(cls)
        outcome = str(rng.choice(["ok", "ok", "ok", "shed", "error"]))
        lat = float(rng.uniform(1.0, 400.0)) if outcome == "ok" else None
        stats.note_done(cls, outcome, lat)
    now[0] += 0.5
    first_shed = stats.first_event("shed")
    return (stats.summary(), stats.summary(slo_ms=120.0),
            stats.summary(slo_ms={"high": 50.0, "low": 300.0}),
            first_shed, stats.first_event("nope"),
            stats.ok_after(first_shed), stats.ok_after(0.5, "high"),
            list(stats.events))


@pytest.mark.parametrize("seed", [0, 1])
def test_load_stats_summarize_like_the_jax_package(seed):
    ref = script_stats(jax_lg, seed)
    assert script_stats(pt_lg, seed) == ref
    summary = ref[0]
    assert summary["offered"] == 300 == (summary["ok"] + summary["shed"]
                                         + summary["error"])
    assert ref[2]["by_class"]["normal"]["attainment"] is None
    assert pt_lg.percentile([], 0.5) is None
    assert pt_lg.percentile([3.0, 1.0, 2.0], 0.95) \
        == jax_lg.percentile([3.0, 1.0, 2.0], 0.95)


def teacher(predict_s: float, seen: list | None = None):
    from edl_tpu_torch.distill.admission import AdmissionConfig
    from edl_tpu_torch.distill.teacher_server import TeacherServer

    def predict(feeds):
        x = next(iter(feeds.values()))
        if seen is not None:
            seen.append(x.shape)
        time.sleep(predict_s)
        out = {"logits": np.zeros((x.shape[0], 4), np.float32)}
        return lambda: out
    return TeacherServer(predict, port=0, host="127.0.0.1", max_batch=16,
                         admission=AdmissionConfig(batching="continuous")
                         ).start()


def test_open_loop_fails_over_when_a_teacher_dies_unannounced():
    servers = [teacher(0.002), teacher(0.002)]
    live = [f"127.0.0.1:{s.port}" for s in servers]
    by_ep = dict(zip(live, servers))
    killed: dict = {}

    def kill_one(i, t):
        del i
        if t >= 0.6 and not killed:
            ep = live.pop()
            killed["ep"], killed["t"] = ep, t
            threading.Thread(target=by_ep[ep].stop, daemon=True).start()

    stats = pt_lg.LoadStats()
    try:
        pt_lg.run_open_loop(lambda: list(live), duration_s=1.5, rps=80.0,
                            rows=2, seed=4, stats=stats,
                            on_arrival=kill_one)
    finally:
        for s in servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 — one already stopped
                pass
    s = stats.summary(slo_ms=1000.0)
    assert killed
    assert s["offered"] == s["ok"] + s["shed"] + s["error"] > 60
    assert stats.ok_after(killed["t"]) > 0          # failover
    assert s["error"] <= 0.1 * s["offered"]
    assert set(stats.first_ok) == set(by_ep)
    assert stats.first_ok[killed["ep"]] < killed["t"]


def test_a_callers_feed_reaches_the_teacher():
    seen: list = []
    server = teacher(0.0, seen)
    try:
        feed = {"image": np.zeros((3, 8, 8, 3), np.float16)}
        stats = pt_lg.run_open_loop([f"127.0.0.1:{server.port}"],
                                    duration_s=0.3, rps=40.0, seed=1,
                                    poisson=False, feed=feed)
    finally:
        server.stop()
    s = stats.summary()
    assert s["ok"] == s["offered"] > 0 and s["error"] == 0
    assert {shape[1:] for shape in seen} == {(8, 8, 3)}
    assert s["p95_ms"] is not None
