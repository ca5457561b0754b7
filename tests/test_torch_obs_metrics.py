"""The port's metrics plane (obs/metrics.py) against the JAX package's.

For the same registry contents (counters, gauges, histograms, stats
sources with nested and labelled dicts, names that need mangling, label
values that need escaping, numbers of every shape) ``render()`` gives
the JAX package's Prometheus text byte for byte, and the JSON snapshot
the same metrics and sources. The scrape endpoint serves that text and
that snapshot; ``publish`` puts the snapshot into a store;
``EDL_TPU_METRICS_PORT`` starts the endpoint on the registry's first
use; and the comm step's ``step_dcn_bytes`` counter shows up on a
scrape.
"""

import json
import urllib.request

import pytest

from edl_tpu_torch.coord.store import InMemStore
from edl_tpu_torch.obs import metrics


def _fill(mod):
    """One registry of `mod` (either package's obs.metrics), filled the
    same way."""
    reg = mod.Registry()
    c = reg.counter("ops_total", "operations served")
    c.inc()
    c.inc(2.5)
    reg.counter("bytes-out/rank 0").inc(1 << 40)
    reg.counter("9lives").inc(10 ** 16)
    g = reg.gauge("queue_depth", 'depth "now"\\ of the queue')
    g.set(7)
    g.inc(0.25)
    reg.gauge("neg").set(-3)
    reg.gauge("tiny").set(1e-9)
    reg.gauge("big").set(1.5e300)
    reg.gauge("inf").set(float("inf"))
    reg.gauge("ninf").set(float("-inf"))
    h = reg.histogram("latency_ms", mod.LOG_BUCKETS_MS, help="per request")
    for v in (0.5, 3.0, 3.0, 40.0, 99999.0, 1000.0, 2.0):
        h.observe(v)
    h2 = reg.histogram("size", mod.log_buckets(1.0, 1000.0))
    for v in (1, 7, 70, 700, 7000):
        h2.observe(v)
    reg.register_stats("teacher", lambda: {
        "served_rows": 48, "ok": True, "ratio": 0.1 + 0.2,
        "name": "not a number", "hist": {"8": 2, "16": 1, "x": "skip"},
        "queue_depth_by_class": {"high": 1, "low": 4},
        "rejected_by_tenant": {'a"b': 2, "c\\d\ne": 3},
        "empty": {}, "nested": {"bool": True}})
    reg.register_stats("teacher", lambda: {"served_rows": 0})
    reg.register_stats("store-server", lambda: {"watchers": 3})
    reg.register_stats("dying", lambda: 1 / 0)
    reg.register_stats("none", lambda: None)
    return reg


def test_render_is_byte_equal_to_jax():
    from edl_tpu.obs import metrics as jmetrics

    ours, theirs = _fill(metrics), _fill(jmetrics)
    text = ours.render()
    assert text == theirs.render()
    assert 'edl_queue_depth 7.25' in text
    assert 'edl_latency_ms_bucket{le="+Inf"} 7' in text
    assert 'tenant="c\\\\d\\ne"' in text


def test_snapshot_matches_jax():
    from edl_tpu.obs import metrics as jmetrics

    ours, theirs = _fill(metrics).snapshot(), _fill(jmetrics).snapshot()
    for snap in (ours, theirs):
        snap.pop("ts")
    assert json.dumps(ours, sort_keys=True, default=str) \
        == json.dumps(theirs, sort_keys=True, default=str)


def test_name_and_value_helpers_match_jax():
    from edl_tpu.obs import metrics as jmetrics

    for raw in ("a", "a.b-c d", "9x", "", "x:y", "é"):
        assert metrics._metric_name(raw) == jmetrics._metric_name(raw)
    for v in ('q"uote', "back\\slash", "new\nline", 3, None):
        assert metrics._escape_label(v) == jmetrics._escape_label(v)
    for v in (0.0, -0.0, 1.0, 2.5, 1e15, 1e16, 123456789.0, 1e-12,
              float("inf"), float("-inf"), 7):
        assert metrics._fmt_value(v) == jmetrics._fmt_value(v)


def test_kind_clash_raises():
    reg = metrics.Registry()
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")


def test_histogram_count_and_sum():
    h = metrics.Histogram((1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    assert h.count == 3 and h.sum == 55.5


def test_scrape_round_trip():
    reg = _fill(metrics)
    srv = metrics.MetricsServer(reg, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=5).read()
        assert body.decode() == reg.render()
        snap = json.loads(urllib.request.urlopen(base + "/snapshot",
                                                 timeout=5).read())
        assert snap["metrics"]["ops_total"] == {"kind": "counter",
                                                "value": 3.5}
        assert snap["sources"]["teacher/0"]["served_rows"] == 48
        assert snap["scrapes"] >= 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=5)
    finally:
        srv.close()


def test_publish_puts_the_snapshot_into_a_store():
    store = InMemStore()
    reg = _fill(metrics)
    reg.publish(store, "/obs/proc-1")
    doc = json.loads(store.get("/obs/proc-1").value)
    assert doc["metrics"]["latency_ms"]["count"] == 7
    assert doc["sources"]["store-server/0"] == {"watchers": 3}

    class Broken:
        def put(self, *a, **k):
            raise OSError("store down")

    reg.publish(Broken(), "/obs/x")   # best effort: never raises


def test_metrics_port_starts_the_endpoint_on_first_use(monkeypatch):
    from edl_tpu_torch.utils.net import free_port

    metrics.stop_serving()
    port = free_port()
    monkeypatch.setenv("EDL_TPU_METRICS_PORT", str(port))
    try:
        reg = metrics.registry()
        reg.counter("test_metrics_port_probe").inc(5)
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=5).read().decode()
        assert "edl_test_metrics_port_probe 5" in body
        assert metrics.serve(port) is metrics.serve(port)   # idempotent
    finally:
        metrics.stop_serving()
    monkeypatch.delenv("EDL_TPU_METRICS_PORT")
    metrics.registry()
    assert metrics._http is None
    metrics.stop_serving()


def test_comm_step_bytes_show_up_on_a_scrape():
    """The comm step's cross-slice byte counter lives in the process
    registry, so a scrape reads it as ``edl_step_dcn_bytes``."""
    counter = metrics.registry().counter("step_dcn_bytes")
    before = counter.value
    counter.inc(4096)
    text = metrics.registry().render()
    line = [ln for ln in text.splitlines()
            if ln.startswith("edl_step_dcn_bytes ")]
    assert line and float(line[0].split()[1]) == before + 4096
