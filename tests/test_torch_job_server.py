"""The port's JobServer/JobClient (collective/job_server.py) against the
JAX package's: the HTTP/JSON wire both ways (each package's client
against the other's server gives its own server's replies), the seeded
fault injector's sequence, the migration-epoch document a served resize
publishes, the trace hop of /resize, the client's reconcile, the CLI's
``--time-interval-to-change``, and TrainerEnv/JobEnv's ``job_server``
field from ``EDL_TPU_JOBSERVER``."""

import json
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from edl_tpu.collective import job_server as jax_js
from edl_tpu.collective import migration as jax_mig
from edl_tpu.coord.store import InMemStore as JaxStore
from edl_tpu_torch.collective import job_server as pt_js
from edl_tpu_torch.collective import migration as pt_mig
from edl_tpu_torch.coord.store import InMemStore as PtStore

ROOT = Path(__file__).resolve().parent.parent


def raw_post(addr: str, body: bytes):
    req = urllib.request.Request(
        f"http://{addr}/resize", method="POST", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def conversation(server_mod, client_mod):
    """One scripted exchange: get, resizes (in range, clamped both ways),
    malformed bodies and an unknown path."""
    state = server_mod.JobState("j1", 1, 4, desired=2)
    server = server_mod.JobServer(state, port=0).start()
    addr = f"127.0.0.1:{server.port}"
    try:
        out = [client_mod.get_job(addr), client_mod.request_resize(addr, 3),
               client_mod.request_resize(addr, 99),
               client_mod.request_resize(f":{server.port}", 0),
               client_mod.get_job(f"http://{addr}")]
        out += [raw_post(addr, body) for body in (
            b"{not json", b"[1, 2]", b"{}", b'{"desired": "lots"}',
            b'{"desired": 2.5}', b'{"desired": true}', b'{"desired": 3.0}')]
        try:
            urllib.request.urlopen(f"http://{addr}/nope", timeout=5)
        except urllib.error.HTTPError as exc:
            out.append((exc.code, json.loads(exc.read())))
        return out, state.resize_log
    finally:
        server.stop()


def test_the_wire_is_the_jax_package_s_both_ways():
    ref = conversation(jax_js, jax_js)
    assert conversation(pt_js, jax_js) == ref   # JAX client, port server
    assert conversation(jax_js, pt_js) == ref   # port client, JAX server
    assert conversation(pt_js, pt_js) == ref
    replies, log = ref
    assert replies[2] == {"job_id": "j1", "desired_nodes": 4,
                          "min_nodes": 1, "max_nodes": 4, "clamped": True,
                          "requested": 99}
    assert [r[0] for r in replies[5:11]] == [400] * 6
    assert replies[11] == (200, {"job_id": "j1", "desired_nodes": 3,
                                 "min_nodes": 1, "max_nodes": 4,
                                 "clamped": False})
    assert replies[12][0] == 404
    assert [e["to"] for e in log] == [3, 4, 1, 3]


def test_state_clamps_and_logs_like_the_jax_package():
    for mod in (jax_js, pt_js):
        assert mod.JobState("j1", 1, 4, desired=99).desired == 4
        assert mod.JobState("j1", 2, 4, desired=0).desired == 2
        assert mod.JobState("j1", 1, 4).desired == 4
    logs = []
    for mod in (jax_js, pt_js):
        state = mod.JobState("j1", 1, 4, desired=2, seed=7)
        state.resize(3)
        state.resize(99)
        state.random_resize()
        logs.append(state.resize_log)
    assert logs[0] == logs[1]
    assert logs[1][1]["clamped"] is True and logs[1][2]["source"] == "fault"


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_resize_sequence_under_one_seed(seed):
    seqs = []
    for mod in (jax_js, pt_js):
        state = mod.JobState("j", 1, 6, desired=3, seed=seed)
        seqs.append([state.random_resize()["desired_nodes"]
                     for _ in range(40)])
    assert seqs[0] == seqs[1]
    assert len(set(seqs[0])) > 2


def epoch_docs(js_mod, mig_mod, store):
    """The epoch documents a served resize sequence publishes (wall
    clock stamp dropped), with one live donor advertised."""
    store.put(mig_mod.donor_key("j", "p0"), json.dumps(
        {"pod_id": "p0", "addr": "10.0.0.1", "port": 7, "version": 4,
         "generation": 2, "nbytes": 99}))
    state = js_mod.JobState("j", 1, 4, desired=2, store=store)
    docs = []
    for desired in (3, 3, 1, 99):
        state.resize(desired)
        doc = json.loads(store.get(mig_mod.epoch_key("j")).value)
        doc.pop("ts")
        docs.append(doc)
    state.random_resize()
    doc = json.loads(store.get(mig_mod.epoch_key("j")).value)
    doc.pop("ts")
    docs.append(doc)
    return docs, state._migration_epoch


def test_migration_epoch_is_published_as_the_jax_package_publishes_it():
    ref = epoch_docs(jax_js, jax_mig, JaxStore())
    assert epoch_docs(pt_js, pt_mig, PtStore()) == ref
    docs, epoch = ref
    assert epoch == 4 and [d["epoch"] for d in docs] == [1, 1, 2, 3, 4]
    assert docs[0]["donors"] == [{"pod_id": "p0", "addr": "10.0.0.1",
                                  "port": 7, "version": 4,
                                  "generation": 2}]
    attached = pt_js.JobState("k", 1, 4, desired=2)
    store = PtStore()
    attached.resize(3)                 # no store: nothing published
    attached.attach_store(store)
    attached.resize(1)
    assert json.loads(store.get(pt_mig.epoch_key("k")).value)["epoch"] == 1


def test_resize_carries_the_trace_into_the_served_actuation(tmp_path,
                                                            monkeypatch):
    from edl_tpu_torch.obs import trace
    monkeypatch.setenv("EDL_TPU_TRACE", str(tmp_path))
    trace.reconfigure()
    try:
        store = PtStore()
        state = pt_js.JobState("j", 1, 4, desired=2, store=store)
        server = pt_js.JobServer(state, port=0).start()
        try:
            with trace.span("scaler.decide") as root:
                pt_js.request_resize(f"127.0.0.1:{server.port}", 3)
        finally:
            server.stop()
        spans = trace.load_spans(str(tmp_path))
        tree = [(s["name"], d) for s, d in trace.span_tree(
            trace.group_traces(spans)[root.trace_id])]
        assert tree == [("scaler.decide", 0), ("resize.request", 1),
                        ("resize.actuate", 2), ("resize.publish_epoch", 3)]
        doc = json.loads(store.get(pt_mig.epoch_key("j")).value)
        assert doc["trace"][0] == root.trace_id
        (summary,) = trace.resize_phase_summary(spans)
        assert set(summary["phases"]) == {"decision", "actuation"}
    finally:
        monkeypatch.delenv("EDL_TPU_TRACE")
        trace.reconfigure()


def test_job_client_reconciles_process_count():
    state = pt_js.JobState("j1", 1, 4, desired=2)
    server = pt_js.JobServer(state, port=0).start()
    client = pt_js.JobClient(f"127.0.0.1:{server.port}",
                             [sys.executable, "-c",
                              "import time; time.sleep(60)"], poll=0.1)
    try:
        client.reconcile(2)
        assert len(client.procs) == 2
        client.reconcile(3)
        assert len(client.procs) == 3
        client.reconcile(1)
        time.sleep(0.3)
        client._reap()
        assert len(client.procs) == 1
    finally:
        for p in client.procs:
            p.kill()
        server.stop()


def test_cli_injects_timed_resizes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.collective.job_server",
         "--port", str(port), "--nodes-range", "1:4", "--desired", "2",
         "--time-interval-to-change", "0.1", "--seed", "3"],
        cwd=str(ROOT), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        seen = set()
        deadline = time.time() + 20.0
        while time.time() < deadline and len(seen) < 2:
            try:
                seen.add(jax_js.get_job(f"127.0.0.1:{port}")[
                    "desired_nodes"])
            except OSError:
                pass
            time.sleep(0.05)
        assert len(seen) >= 2, "the fault injector never changed the job"
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_job_server_endpoint_reaches_the_envs(monkeypatch):
    from edl_tpu.collective.job_env import JobEnv as JaxJobEnv
    from edl_tpu_torch.collective.job_env import JobEnv
    from edl_tpu_torch.utils import config
    monkeypatch.setenv("EDL_TPU_JOBSERVER", "10.0.0.9:8180")
    assert JobEnv.from_environ().job_server == "10.0.0.9:8180" \
        == JaxJobEnv.from_environ().job_server
    assert "EDL_TPU_JOBSERVER" in config.ENV_VARS
