"""The port's store server and client (edl_tpu_torch.coord.server,
edl_tpu_torch.coord.client): the cases of tests/test_store_server.py
against the port's server with the port's client, then wire
compatibility both ways, the port's client against the JAX package's
StoreServer and the JAX package's client against the port's server, each
doing a rank claim, a leased put and its expiry, CAS and a watch; the
port's server as its own process (``python -m edl_tpu_torch.coord.server``);
and the replicated-store paths the port's client refuses.
"""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from edl_tpu.coord import client as jax_client
from edl_tpu.coord import server as jax_server
from edl_tpu_torch.coord import wire
from edl_tpu_torch.coord.client import LeaseKeeper, StoreClient
from edl_tpu_torch.coord.server import StoreServer
from edl_tpu_torch.utils.exceptions import EdlLeaseExpired, EdlStoreError

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def server():
    with StoreServer(port=0, host="127.0.0.1", sweep_interval=0.05) as srv:
        yield srv


@pytest.fixture
def client(server):
    c = StoreClient(f"127.0.0.1:{server.port}", timeout=5.0)
    yield c
    c.close()


def test_roundtrip(client):
    rev = client.put("/a", "1")
    assert client.get("/a").value == "1"
    assert client.get("/a").revision == rev
    recs, _ = client.get_prefix("/")
    assert [r.key for r in recs] == ["/a"]
    assert client.delete("/a")
    assert client.get("/a") is None


def test_typed_errors_survive_the_wire(client):
    # A put against a dead lease must raise EdlLeaseExpired (the subtype,
    # not just EdlStoreError) even through the TCP client — launcher
    # recovery paths dispatch on it.
    lease = client.lease_grant(5.0)
    assert client.lease_revoke(lease)
    with pytest.raises(EdlLeaseExpired):
        client.put("/dead", "1", lease=lease)


def test_cas_over_wire(client):
    assert client.put_if_absent("/rank/0", "me")
    assert not client.put_if_absent("/rank/0", "you")
    assert client.compare_and_swap("/rank/0", "me", "me2")
    assert not client.compare_and_swap("/rank/0", "nope", "x")


def test_lease_expiry_over_wire(server, client):
    lease = client.lease_grant(ttl=0.2)
    client.put("/eph", "v", lease=lease)
    assert client.get("/eph") is not None
    # sweeper expires it without further traffic
    deadline = threading.Event()
    deadline.wait(0.6)
    assert client.get("/eph") is None
    assert not client.lease_keepalive(lease)


def test_lease_keeper_keeps_alive(server, client):
    lease = client.lease_grant(ttl=0.3)
    client.put("/kept", "v", lease=lease)
    keeper = LeaseKeeper(client, lease, interval=0.05).start()
    threading.Event().wait(0.8)
    assert client.get("/kept") is not None
    keeper.stop(revoke=True)
    assert client.get("/kept") is None


def test_events_over_wire(client):
    r0 = client.put("/x", "1")
    client.put("/y", "2")
    evs, rev, compacted = client.events_since(r0)
    assert not compacted
    assert [(e.type, e.key) for e in evs] == [("PUT", "/y")]


def test_error_propagates(client):
    lease = client.lease_grant(ttl=10.0)
    client.lease_revoke(lease)
    with pytest.raises(EdlStoreError):
        client.put("/k", "v", lease=lease)


def test_concurrent_rank_claims(server):
    """N clients race put_if_absent for ranks; each rank claimed exactly once."""
    n = 8
    winners = []
    lock = threading.Lock()

    def claim(pod_id):
        c = StoreClient(f"127.0.0.1:{server.port}")
        got = None
        for rank in range(n):
            if c.put_if_absent(f"/job/rank/{rank}", pod_id):
                got = rank
                break
        with lock:
            winners.append((pod_id, got))
        c.close()

    threads = [threading.Thread(target=claim, args=(f"pod-{i}",)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ranks = sorted(r for _, r in winners)
    assert ranks == list(range(n))


# -- wire compatibility both ways --------------------------------------------

PAIRS = {"port_client_jax_server": (StoreClient, jax_server.StoreServer),
         "jax_client_port_server": (jax_client.StoreClient, StoreServer)}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_wire_compatibility(pair):
    """Rank claims, a leased put and its expiry (seen by a watch as a
    DELETE), CAS and a watch, across the two packages."""
    client_cls, server_cls = PAIRS[pair]
    with server_cls(port=0, host="127.0.0.1", sweep_interval=0.05) as srv:
        c = client_cls(f"127.0.0.1:{srv.port}", timeout=5.0)
        try:
            w = c.watch("/job/")
            assert c.put_if_absent("/job/ranks/000000", "pod-a")
            assert not c.put_if_absent("/job/ranks/000000", "pod-b")
            assert c.put_if_absent("/job/ranks/000001", "pod-b")
            lease = c.lease_grant(ttl=0.2)
            c.put("/job/eph", "v", lease=lease)
            assert c.get("/job/eph").lease == lease
            assert c.compare_and_swap("/job/cluster", None, "v1")
            assert not c.compare_and_swap("/job/cluster", "v0", "v2")
            assert c.compare_and_swap("/job/cluster", "v1", "v2")
            time.sleep(0.6)          # the sweeper expires the lease
            assert c.get("/job/eph") is None
            assert not c.lease_keepalive(lease)
            with pytest.raises(Exception, match="EdlLeaseExpired|expired"):
                c.put("/job/dead", "x", lease=lease)
            seen = []
            deadline = time.monotonic() + 5.0
            while len(seen) < 6 and time.monotonic() < deadline:
                batch = w.get(timeout=0.5)
                if batch is not None:
                    seen += [(e.type, e.key, e.value) for e in batch.events]
            assert seen == [("PUT", "/job/ranks/000000", "pod-a"),
                            ("PUT", "/job/ranks/000001", "pod-b"),
                            ("PUT", "/job/eph", "v"),
                            ("PUT", "/job/cluster", "v1"),
                            ("PUT", "/job/cluster", "v2"),
                            ("DELETE", "/job/eph", "v")], seen
            recs, rev = c.get_prefix("/job/ranks/")
            assert [r.value for r in recs] == ["pod-a", "pod-b"]
            w.cancel()
        finally:
            c.close()


def test_the_port_s_frames_are_the_jax_package_s():
    from edl_tpu.coord import wire as jax_wire

    msg = {"op": "put", "key": "/k", "value": "v\u00e9", "lease": 3}
    frames = []
    for mod in (wire, jax_wire):
        a, b = socket.socketpair()
        with a, b:
            mod.send_msg(a, msg)
            b.settimeout(2.0)
            frames.append(b.recv(1 << 16))
    assert frames[0] == frames[1]
    assert frames[0][:4] == wire.MAGIC


def test_the_server_runs_as_its_own_process(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("EDL_TPU_", "PALLAS_"))}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.coord.server", "--host",
         "127.0.0.1", "--port", str(port), "--sweep_interval", "0.05"],
        env=env, stdout=open(tmp_path / "store.log", "wb"),
        stderr=subprocess.STDOUT)
    try:
        c = StoreClient(f"127.0.0.1:{port}", timeout=2.0,
                        connect_retries=100, retry_interval=0.1)
        assert c.put_if_absent("/p/ranks/000000", "me")
        assert c.status()["role"] == "standalone"
        c.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_failover_rotates_to_the_next_endpoint(server):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    c = StoreClient(f"127.0.0.1:{dead},127.0.0.1:{server.port}",
                    timeout=2.0, connect_retries=2, retry_interval=0.05)
    assert c.put("/f", "1") > 0 and c.get("/f").value == "1"
    c.close()


class _RefusingServer:
    """A server that answers every request with one replicated-store
    refusal shape."""

    def __init__(self, refusal: dict):
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.refusal = refusal
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                try:
                    while True:
                        wire.recv_msg(conn)
                        wire.send_msg(conn, self.refusal)
                except (OSError, wire.WireError):
                    pass


@pytest.mark.parametrize("refusal", [
    {"ok": False, "not_leader": True, "leader": "127.0.0.1:1",
     "error": "not leader"},
    {"ok": False, "redirect": True, "group": "g1",
     "endpoints": ["127.0.0.1:1"], "error": "redirect"}])
def test_replicated_store_refusals_name_item_17(refusal):
    srv = _RefusingServer(refusal)
    c = StoreClient(f"127.0.0.1:{srv.port}", timeout=2.0)
    with pytest.raises(EdlStoreError, match="item 17"):
        c.put_if_absent("/job/ranks/000000", "me")
    c.close()
    srv.sock.close()


def test_a_relay_tier_is_refused(client, monkeypatch):
    monkeypatch.setenv("EDL_TPU_RELAY_ENDPOINTS", "127.0.0.1:1")
    with pytest.raises(EdlStoreError, match="item 17"):
        client.watch("/x/")


def test_a_watch_resumes_across_a_server_restart():
    """The stream reconnects and re-subscribes from its last revision:
    an event put while the server was down arrives once, no duplicate."""
    from edl_tpu_torch.coord.store import InMemStore

    store = InMemStore()
    srv = StoreServer(port=0, host="127.0.0.1", store=store,
                      sweep_interval=0.05).start()
    port = srv.port
    c = StoreClient(f"127.0.0.1:{port}", timeout=2.0, connect_retries=50,
                    retry_interval=0.05)
    w = c.watch("/r/", heartbeat=0.2)
    c.put("/r/a", "1")
    assert [e.key for e in w.get(timeout=5.0).events] == ["/r/a"]
    srv.stop()
    store.put("/r/b", "2")            # while no server runs
    srv = StoreServer(port=port, host="127.0.0.1", store=store,
                      sweep_interval=0.05).start()
    try:
        c.put("/r/c", "3")
        seen = []
        deadline = time.monotonic() + 10.0
        while len(seen) < 2 and time.monotonic() < deadline:
            batch = w.get(timeout=0.5)
            if batch is not None:
                seen += [e.key for e in batch.events]
        assert seen == ["/r/b", "/r/c"]
        assert w.get(timeout=0.5) is None
    finally:
        w.cancel()
        c.close()
        srv.stop()


def test_a_request_carries_its_span_across_the_store_hop(server, client,
                                                        monkeypatch,
                                                        tmp_path):
    """With tracing on, a request sent inside a span carries its context
    ("_tc") and the server's op runs as that span's child; outside a
    span, and with tracing off, nothing is attached."""
    from edl_tpu_torch.obs import trace

    monkeypatch.setenv("EDL_TPU_TRACE", str(tmp_path / "spans"))
    trace.reconfigure()
    try:
        assert trace.attach({"op": "get"}) == {"op": "get"}
        with trace.span("resize") as outer:
            assert trace.attach({"op": "get"})["_tc"] == list(outer.context)
            client.put("/t", "1")
        deadline = time.monotonic() + 5.0
        while not trace.finished("store.put") and time.monotonic() < deadline:
            time.sleep(0.05)
        (put,) = trace.finished("store.put")
        assert (put["tid"], put["parent"]) == outer.context
        assert trace.current() is None
    finally:
        monkeypatch.delenv("EDL_TPU_TRACE")
        trace.reconfigure()
    assert trace.attach({"op": "get"}) == {"op": "get"}
