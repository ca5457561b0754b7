"""The port's trace readers and trace CLI against the JAX package's: a
span directory written by the port's trace (a resize-shaped trace from
the decision through the actuation, the epoch publication, a survivor's
adoption with its reform phases, a peer restore and the first fresh
utilization; an unrelated trace, an orphan, a torn line) reads the same
through both packages' ``load_spans``, ``group_traces``, ``span_tree``,
``resize_phase_summary`` and ``to_chrome``; both CLIs print the same
for ``trace --json``, the tree view and ``--chrome``; both selftests
pass."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from edl_tpu.obs import __main__ as jax_cli
from edl_tpu.obs import trace as jax_trace
from edl_tpu_torch.obs import __main__ as pt_cli
from edl_tpu_torch.obs import trace as pt_trace

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def span_dir(tmp_path, monkeypatch):
    """Spans written the way a resize writes them, across 'processes'
    (the wire seams' attach/extract and adopt), by the port's trace."""
    monkeypatch.setenv("EDL_TPU_TRACE", str(tmp_path))
    pt_trace.reconfigure()
    try:
        assert pt_trace.sink_dir() == str(tmp_path)
        with pt_trace.span("scaler.decide", attrs={"job": "j", "from": 1,
                                                   "to": 2}):
            with pt_trace.span("resize.request", attrs={"desired": 2}):
                header = pt_trace.inject()
                with pt_trace.adopt(header):           # the HTTP hop
                    with pt_trace.span("resize.actuate"):
                        with pt_trace.span("resize.publish_epoch") as ep:
                            epoch_ctx = list(ep.context)
        adopt = pt_trace.start_span("resize.adopt", parent=tuple(epoch_ctx),
                                    attrs={"pod": "p0", "world": 2})
        for name, dur in (("quiesce", 0.01), ("mesh-reform", 0.002),
                          ("peer-restore", 0.03)):
            pt_trace.event(f"reform.{name}", dur, parent=adopt.context,
                           attrs={"ok": True})
        adopt.end(downtime_s=0.08)
        msg = pt_trace.attach({"op": "fetch"})
        with pt_trace.adopt(pt_trace.extract(dict(msg))):
            pass
        with pt_trace.span("resize.restore_peers",
                           parent=tuple(epoch_ctx)):
            pt_trace.event("migrate.fetch", 0.004)
        pt_trace.instant("resize.first_fresh_util", parent=adopt.context,
                         attrs={"world": 2})
        with pt_trace.span("ckpt.save"):
            pass                                       # unrelated trace
        pt_trace.event("resize.adopt", 0.5, parent=("dead" * 4, "beef" * 4))
        assert len(pt_trace.finished("resize.")) >= 5
        pt_trace.clear_ring()
        assert pt_trace.finished() == []
    finally:
        monkeypatch.delenv("EDL_TPU_TRACE")
        pt_trace.reconfigure()
    (tmp_path / f"spans-{os.getpid()}.jsonl").open("a").write('{"tid": "x\n')
    (tmp_path / "notes.txt").write_text("not spans")
    return tmp_path


def test_both_readers_give_equal_values(span_dir):
    spans = pt_trace.load_spans(str(span_dir))
    assert spans == jax_trace.load_spans(str(span_dir))
    assert len(spans) == 13
    traces = pt_trace.group_traces(spans)
    assert traces == jax_trace.group_traces(spans)
    assert len(traces) == 3
    for tid, tspans in traces.items():
        assert pt_trace.span_tree(tspans) == jax_trace.span_tree(tspans)
    summary = pt_trace.resize_phase_summary(spans)
    assert summary == jax_trace.resize_phase_summary(spans)
    assert pt_trace.RESIZE_PHASES == jax_trace.RESIZE_PHASES
    assert pt_trace.to_chrome(spans) == jax_trace.to_chrome(spans)
    main = max(summary, key=lambda r: r["spans"])
    assert set(main["phases"]) == {"decision", "actuation", "restore",
                                   "first_fresh_util"}
    assert main["downtime_s"] > 0
    tree = [(s["name"], d) for s, d in pt_trace.span_tree(
        traces[main["trace_id"]])]
    assert tree[0] == ("scaler.decide", 0)
    assert ("reform.peer-restore", 5) in tree
    assert ("resize.first_fresh_util", 5) in tree
    orphan = [r for r in summary if r["spans"] == 1]
    assert orphan and orphan[0]["phases"] == {"restore": 0.5}


def run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out


def test_both_clis_print_the_same(span_dir, tmp_path, capsys):
    d = str(span_dir)
    ref = run_cli(jax_cli.main, ["trace", d, "--json"], capsys)
    got = run_cli(pt_cli.main, ["trace", d, "--json"], capsys)
    assert got == ref and ref[0] == 0
    doc = json.loads(got[1])
    assert doc["spans"] == 13 and doc["traces"] == 3
    assert len(doc["resizes"]) == 2
    assert run_cli(pt_cli.main, ["trace", d], capsys) == run_cli(
        jax_cli.main, ["trace", d], capsys)
    jax_chrome, pt_chrome = tmp_path / "j.json", tmp_path / "p.json"
    jax_cli.main(["trace", d, "--chrome", str(jax_chrome), "--json"])
    pt_cli.main(["trace", d, "--chrome", str(pt_chrome), "--json"])
    capsys.readouterr()
    assert json.loads(pt_chrome.read_text()) == json.loads(
        jax_chrome.read_text())
    empty = tmp_path / "empty"
    empty.mkdir()
    assert pt_cli.main(["trace", str(empty)]) == 1 == jax_cli.main(
        ["trace", str(empty)])


def test_both_selftests_pass_and_the_cli_runs_torch_free(capsys):
    assert pt_cli.selftest(verbose=False) == 0
    assert jax_cli.selftest(verbose=False) == 0
    capsys.readouterr()
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.obs",
                          "selftest"], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "no torch or numpy import crept in" in out.stdout
    assert out.stdout.strip().endswith("obs selftest: OK")
