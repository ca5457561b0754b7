"""The port's discovery plane (coord/consistent_hash.py, coord/registry.py,
distill/balance.py, distill/discovery_server.py, discovery_client.py,
registrar.py) against the JAX package's.

The rebalance math and the hash ring are pure functions of their
inputs: on seeded random sequences of membership changes, utilization
reports and rebalances, every client's assignment and version, and
every lookup and ring version, equal the JAX package's exactly. The
registrar's utilization document, from the same two stats polls, is
the JAX one byte for byte. Over real sockets the wire interoperates:
the JAX package's DiscoveryClient is served by the port's discovery
server. A churn run (a teacher joins, then the first dies) through the
port's store, discovery server, registrars, teacher servers and
DistillReader keeps every batch, in order, within 15 s; and the daemons
start as processes (``python -m``) without torch or numpy.
"""

import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from edl_tpu_torch.coord.consistent_hash import ConsistentHash
from edl_tpu_torch.coord.store import InMemStore
from edl_tpu_torch.distill import balance
from edl_tpu_torch.distill.discovery_client import DiscoveryClient
from edl_tpu_torch.distill.discovery_server import DiscoveryServer
from edl_tpu_torch.distill.reader import DistillReader
from edl_tpu_torch.distill.registrar import TeacherRegistrar
from edl_tpu_torch.distill.teacher_server import TeacherServer
from edl_tpu_torch.utils.exceptions import EdlError

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("c,s", [(0, 3), (3, 0), (1, 40), (10, 3), (2, 8),
                                 (7, 7), (100, 9)])
def test_caps_match_jax(c, s):
    from edl_tpu.distill.balance import caps
    assert balance.caps(c, s) == caps(c, s)


def _links(svc) -> dict:
    return {cid: (l.servers, l.version) for cid, l in svc.clients.items()}


@pytest.mark.parametrize("seed", range(6))
def test_rebalance_matches_jax_on_random_churn(seed):
    from edl_tpu.distill.balance import ServiceBalance as JBalance

    rng = random.Random(seed)
    ours, theirs = balance.ServiceBalance("s"), JBalance("s")
    servers: set[str] = set()
    clients: set[str] = set()
    for _ in range(60):
        op = rng.random()
        if op < 0.25:
            servers.add(f"t{rng.randrange(12)}")
            for b in (ours, theirs):
                b.set_servers(sorted(servers))
        elif op < 0.35 and servers:
            servers.discard(rng.choice(sorted(servers)))
            for b in (ours, theirs):
                b.set_servers(sorted(servers))
        elif op < 0.6:
            cid = f"c{rng.randrange(20)}"
            clients.add(cid)
            assert ours.add_client(cid, 1.0) == theirs.add_client(cid, 1.0)
        elif op < 0.7 and clients:
            cid = rng.choice(sorted(clients))
            clients.discard(cid)
            assert ours.remove_client(cid) == theirs.remove_client(cid)
        elif op < 0.8:
            util = {s: rng.random() for s in servers if rng.random() < 0.7}
            depth = {s: rng.randrange(8) for s in servers
                     if rng.random() < 0.5}
            by_class = {s: {c: rng.randrange(4) for c in
                            ("high", "normal", "low", "x")}
                        for s in servers if rng.random() < 0.3}
            for b in (ours, theirs):
                b.set_utilization(util, depth, by_class)
        elif op < 0.85:
            # heartbeats, then the silent clients' expiry
            now = rng.uniform(1.0, 3.0)
            for cid in sorted(clients):
                if rng.random() < 0.7:
                    assert ours.touch(cid, now) == theirs.touch(cid, now)
            gone = ours.expire_clients(now, 1.0)
            assert gone == theirs.expire_clients(now, 1.0)
            clients -= set(gone)
        assert ours.rebalance() == theirs.rebalance()
        assert _links(ours) == _links(theirs)
        assert ours.loads() == theirs.loads()


@pytest.mark.parametrize("seed", range(4))
def test_consistent_hash_matches_jax(seed):
    from edl_tpu.coord.consistent_hash import ConsistentHash as JHash

    rng = random.Random(seed)
    nodes = [f"10.0.0.{i}:{23800 + i}" for i in range(rng.randrange(1, 6))]
    vnodes = rng.choice([1, 7, 300])
    ours, theirs = ConsistentHash(nodes, vnodes), JHash(nodes, vnodes)
    keys = [f"svc-{rng.random()}" for _ in range(300)]
    for _ in range(8):
        assert [ours.lookup_with_version(k) for k in keys] == \
            [theirs.lookup_with_version(k) for k in keys]
        assert ours.nodes == theirs.nodes
        node = f"10.0.1.{rng.randrange(8)}:1"
        how = rng.choice(["add_node", "remove_node", "set_nodes"])
        arg = [node, *nodes[:2]] if how == "set_nodes" else node
        getattr(ours, how)(arg)
        getattr(theirs, how)(arg)
    assert ConsistentHash().lookup("x") is None


def test_utilization_info_matches_jax():
    from edl_tpu.distill.registrar import TeacherRegistrar as JRegistrar

    prev = {"served_rows": 100, "busy_s": 1.0, "rejected_total": 2,
            "batch_rows_hist": {"8": 5}, "latency_hist_ms": {"4.0": 3},
            "latency_hist_ms_by_class": {"high": {"4.0": 1}},
            "rejected_by_class": {"low": 2}}
    cur = {"served_rows": 420, "busy_s": 2.5, "rejected_total": 5,
           "queue_depth": 3, "inflight_groups": 2, "draining": 0,
           "batch_rows_hist": {"8": 9, "16": 20},
           "latency_hist_ms": {"4.0": 10, "16.0": 7},
           "latency_hist_ms_by_class": {"high": {"4.0": 4, "64.0": 2},
                                        "low": {"16.0": 3}},
           "rejected_by_class": {"low": 4, "normal": 1},
           "queue_depth_by_class": {"high": 1, "low": 2}}
    ours = TeacherRegistrar.__new__(TeacherRegistrar)
    theirs = JRegistrar.__new__(JRegistrar)
    for p in (None, prev):
        got = ours._utilization_info(cur, p, 2.0)
        assert got == theirs._utilization_info(cur, p, 2.0)
        assert json.loads(got)["queue_depth"] == 3


def _table_teacher(feeds):
    out = {"logits": np.stack([feeds["image"].sum(1),
                               feeds["image"].max(1)], 1)}
    return lambda: out


def test_jax_discovery_client_served_by_the_port_s_server():
    from edl_tpu.distill.discovery_client import DiscoveryClient as JClient

    store = InMemStore()
    reg = TeacherRegistrar(store, "svc", "127.0.0.1:9", ttl=5.0,
                           probe_timeout=0.1)
    reg.wait_alive = lambda: None   # a registry entry, no teacher
    reg.start()
    with DiscoveryServer(store, port=0, host="127.0.0.1",
                         tick_interval=0.1) as srv:
        client = JClient(srv.endpoint, "svc", heartbeat_interval=0.1).start()
        try:
            assert client.wait_for_servers(5.0) == ["127.0.0.1:9"]
            stats = srv.table.stats()["svc"]
            assert stats["clients"] == 1
            assert stats["loads"] == {"127.0.0.1:9": 1}
        finally:
            client.stop()
    reg.stop()


def test_discovery_churn_join_then_kill_keeps_every_batch():
    """A teacher joins mid-epoch (the balancer assigns it), then the
    first dies (server and registrar): every batch comes, in order, with
    its own rows' logits; under 15 s."""
    t0 = time.monotonic()
    store = InMemStore()

    def teacher():
        srv = TeacherServer(_table_teacher, host="127.0.0.1").start()
        ep = f"127.0.0.1:{srv.port}"
        reg = TeacherRegistrar(store, "svc", ep, ttl=1.0, probe_timeout=5.0,
                               probe_interval=0.05).start()
        return srv, reg, ep

    first = teacher()
    disco = DiscoveryServer(store, port=0, host="127.0.0.1",
                            tick_interval=0.1).start()
    rng = np.random.default_rng(3)
    batches = [{"image": rng.normal(size=(8, 5)).astype(np.float32)}
               for _ in range(16)]
    joined = []

    def source():
        for i, b in enumerate(batches):
            if i == 4:
                joined.append(teacher())
                deadline = time.monotonic() + 5
                while (joined[0][2] not in disco.table.stats()["svc"][
                        "loads"] and time.monotonic() < deadline):
                    time.sleep(0.02)
            if i == 10:
                first[0].stop()
                first[1].stop(deregister=False)
            time.sleep(0.02)
            yield b

    dr = DistillReader(source, feeds=["image"], predicts=["logits"],
                       discovery=disco.endpoint, service="svc",
                       teacher_batch_size=4, manage_interval=0.05)
    try:
        dr._get_servers()   # starts the discovery client; beat faster
        dr._discovery_client.heartbeat_interval = 0.1
        got = list(dr())
    finally:
        dr.close()
        disco.stop()
        for srv, reg, _ in joined:
            srv.stop()
            reg.stop()
    assert len(got) == len(batches)
    for want, out in zip(batches, got):
        np.testing.assert_array_equal(out["image"], want["image"])
        np.testing.assert_allclose(out["logits"][:, 0],
                                   want["image"].sum(1), rtol=1e-6)
    assert joined[0][0].batcher.stats()["served_rows"] > 0
    assert time.monotonic() - t0 < 15.0


def test_the_daemons_run_as_processes_without_torch(tmp_path):
    """The port's store server, discovery server and registrar CLIs, each
    a process that never imports torch or numpy, assign a teacher to a
    DiscoveryClient."""
    from edl_tpu_torch.utils.net import free_port

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("EDL_TPU_", "PALLAS_"))}
    env["PYTHONPATH"] = str(ROOT)
    probe = ("import runpy, sys; sys.argv = sys.argv[1:]; "
             "runpy.run_module(sys.argv[0], run_name='__main__')")
    guard = ("import builtins; _imp = builtins.__import__\n"
             "def _no(name, *a, **k):\n"
             "    if name.split('.')[0] in ('torch', 'numpy'):\n"
             "        raise ImportError('imported ' + name)\n"
             "    return _imp(name, *a, **k)\n"
             "builtins.__import__ = _no\n")
    store_port, disc_port = free_port(), free_port()
    srv = TeacherServer(_table_teacher, host="127.0.0.1").start()
    procs = []

    def run(module, *args):
        log = open(tmp_path / f"{module.rsplit('.', 1)[1]}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", guard + probe, module, *args], env=env,
            stdout=log, stderr=subprocess.STDOUT))

    try:
        run("edl_tpu_torch.coord.server", "--host", "127.0.0.1", "--port",
            str(store_port))
        run("edl_tpu_torch.distill.discovery_server", "--store",
            f"127.0.0.1:{store_port}", "--host", "127.0.0.1", "--port",
            str(disc_port), "--tick-interval", "0.1")
        run("edl_tpu_torch.distill.registrar", "--store",
            f"127.0.0.1:{store_port}", "--service", "svc", "--server",
            f"127.0.0.1:{srv.port}", "--ttl", "2", "--stats-interval", "0")
        deadline = time.monotonic() + 30
        client = None
        while client is None:
            try:
                client = DiscoveryClient(f"127.0.0.1:{disc_port}", "svc",
                                         heartbeat_interval=0.1).start()
            except EdlError:   # the daemons are not up yet
                assert time.monotonic() < deadline
                assert all(p.poll() is None for p in procs), [
                    (tmp_path / f).read_text() for f in os.listdir(tmp_path)]
                time.sleep(0.2)
        try:
            assert client.wait_for_servers(20.0) == [f"127.0.0.1:{srv.port}"]
        finally:
            client.stop()
    finally:
        for p in procs:
            p.kill()
            p.wait()
        srv.stop()
    logs = "".join((tmp_path / f).read_text() for f in os.listdir(tmp_path))
    assert "imported torch" not in logs and "imported numpy" not in logs
