"""The port's replicated/sharded store (``edl_tpu_torch/coord/
replication.py``): failover, fencing and REDIRECT semantics, each case of
``tests/test_replication.py`` run against the port, and the port's group
and client across the package line.

- kill the leader mid-watch: the client re-attaches by revision and
  sees every majority-acked event exactly once (zero lost, zero dup);
- a deposed (partitioned) leader cannot acknowledge writes (the commit
  gate times out while its quorum lease is dead) and rejoins via
  snapshot, discarding its divergent suffix;
- shard REDIRECTs route to the owning group and a redirect LOOP is
  bounded and surfaced as a clear error, not a hang;
- a port client against a JAX group, a JAX client against a port group,
  and a group of replicas from both packages: the same answers and zero
  lost or duplicated watch events across a leader kill (the peer
  messages and snapshots are the JAX package's bytes);
- ``python -m edl_tpu_torch.coord.replication selftest|dryrun`` exit 0.

Every wait is a condition under a deadline; the groups run a 1 s
election TTL so a loaded host's scheduling delays do not depose a live
leader mid-case.
"""

import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from edl_tpu.coord import replication as jax_replication
from edl_tpu.coord.client import StoreClient as JaxStoreClient
from edl_tpu_torch.coord import wire
from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.coord.registry import ServiceRegistry
from edl_tpu_torch.coord.replication import (ReplicaGroup, ReplicaServer,
                                             ShardedStoreClient, ShardRouter,
                                             parse_topology, shard_key)
from edl_tpu_torch.utils.exceptions import EdlStoreError
from edl_tpu_torch.utils.net import free_port


ROOT = Path(__file__).resolve().parent.parent
TTL = 1.0


@pytest.fixture
def group():
    with ReplicaGroup(3, election_ttl=TTL, commit_timeout=1.5) as g:
        g.wait_leader(timeout=20.0)
        yield g


def _raw(endpoint, req, timeout=10.0):
    """One request over the bare wire: no rerouting, no retry."""
    host, port = endpoint.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        wire.send_msg(s, req)
        return wire.recv_msg(s)


def _wait(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def test_leader_writes_replicate_to_follower_reads(group):
    client = group.client(timeout=3.0)
    rev = client.put("/r/a", "1")
    lease = client.lease_grant(30.0)
    client.put("/r/b", "2", lease=lease)
    leader = group.leader()
    for srv in group.servers:
        if srv is leader:
            continue
        # follower reads served locally, with the leader's revisions
        # AND the lease id on the record (promotion rebuilds from it)
        follower = StoreClient(srv.endpoint, timeout=3.0)
        assert _wait(lambda: follower.get("/r/b") is not None)
        rec = follower.get("/r/a")
        assert (rec.value, rec.revision) == ("1", rev)
        assert follower.get("/r/b").lease == lease
        follower.close()
    client.close()


def test_kill_leader_mid_watch_zero_lost_zero_dup(group):
    client = group.client(timeout=3.0)
    watcher = group.client(timeout=3.0)
    watch = watcher.watch("/job/", start_revision=0)
    acked = {}
    for i in range(10):
        acked[f"p{i}"] = client.put(f"/job/rank/{i}", f"p{i}")

    killed = group.kill_leader()
    new_leader = group.wait_leader(timeout=20.0)
    assert new_leader.endpoint != killed
    for i in range(10, 20):
        acked[f"p{i}"] = client.put(f"/job/rank/{i}", f"p{i}")

    seen = {}
    duplicates = 0
    compacted = False
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        batch = watch.get(timeout=0.5)
        if batch is None:
            if seen and max(seen) >= max(acked.values()):
                break
            continue
        compacted = compacted or batch.compacted
        for ev in batch.events:
            if ev.revision in seen:
                duplicates += 1
            seen[ev.revision] = ev.value
    assert not compacted, "short stream must not hit compaction"
    assert duplicates == 0
    lost = [v for v, rev in acked.items() if rev not in seen]
    assert not lost, f"acked events lost across failover: {lost}"
    assert all(seen[rev] == v for v, rev in acked.items())
    watch.cancel()
    watcher.close()
    client.close()


def test_resume_by_revision_on_new_leader(group):
    client = group.client(timeout=3.0)
    revs = [client.put(f"/res/{i}", str(i)) for i in range(6)]
    group.kill_leader()
    group.wait_leader(timeout=20.0)
    after = [client.put(f"/res/{i}", str(100 + i)) for i in range(3)]
    # a FRESH watch that resumes from the middle of the pre-kill stream
    # replays exactly the suffix — the new leader's history covers it
    watch = client.watch("/res/", start_revision=revs[2])
    got = []
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and len(got) < 3 + len(after):
        batch = watch.get(timeout=0.5)
        if batch is None:
            continue
        assert not batch.compacted
        got.extend(ev.revision for ev in batch.events)
    assert got == revs[3:] + after
    watch.cancel()
    client.close()


def test_deposed_leader_fenced_and_snapshot_rejoins(group):
    old = group.leader()
    others = [s for s in group.servers if s is not old]
    # a client pinned to the old leader only — no transparent failover,
    # we WANT to observe the refusal
    pinned = StoreClient(old.endpoint, timeout=2.0, connect_retries=2,
                         retry_interval=0.05)
    pinned.put("/fence/pre", "committed")

    old.node._partitioned = True
    # While its quorum lease may still look live the commit gate cannot
    # reach majority; once the lease ages out the role check refuses.
    # Either way the write is NOT acknowledged. It goes over the bare
    # wire: a client would follow a not_leader hint to the new leader.
    resp = _raw(old.endpoint, {"op": "put", "key": "/fence/divergent",
                               "value": "doomed", "lease": 0})
    assert resp.get("ok") is False, resp

    assert _wait(lambda: any(s.node.is_leader() for s in others),
                 timeout=15.0), "survivors must elect a new leader"
    new_leader = next(s for s in others if s.node.is_leader())
    ha = StoreClient(",".join(s.endpoint for s in others), timeout=3.0)
    ha.put("/fence/post", "new-reign")

    old.node._partitioned = False
    # the deposed leader steps down on first contact with the higher
    # term and rejoins via snapshot: its divergent write is DISCARDED
    assert _wait(lambda: old.node.role() == "follower", timeout=15.0)
    assert _wait(lambda: old.node.store.get("/fence/post") is not None,
                 timeout=15.0)
    assert old.node.store.get("/fence/divergent") is None
    assert old.node.store.get("/fence/pre") is not None
    assert old.node.term() >= new_leader.node.term()
    pinned.close()
    ha.close()


def test_sharded_redirect_and_routing():
    ports = [free_port(), free_port()]
    eps = [f"127.0.0.1:{p}" for p in ports]
    topo = {"s0": [eps[0]], "s1": [eps[1]]}
    router = ShardRouter(topo)
    # two services that land on DIFFERENT groups
    svc_a = next(f"svc{i}" for i in range(100)
                 if router.owner(f"/edl/svc{i}/nodes/x") == "s0")
    svc_b = next(f"svc{i}" for i in range(100)
                 if router.owner(f"/edl/svc{i}/nodes/x") == "s1")
    servers = [
        ReplicaServer(eps[i], ports[i], group_endpoints=[eps[i]],
                      group=g, topology=topo, election_ttl=0.5)
        for i, g in enumerate(["s0", "s1"])
    ]
    for s in servers:
        s.start()
    try:
        assert _wait(lambda: all(s.node.is_leader() for s in servers))
        key_b = f"/edl/{svc_b}/nodes/h1"
        # a plain client pointed at the WRONG group follows the REDIRECT
        wrong = StoreClient(eps[0], timeout=3.0)
        wrong.put(key_b, "routed")
        right = StoreClient(eps[1], timeout=3.0)
        assert right.get(key_b).value == "routed"
        assert StoreClient(eps[1]).get_prefix(f"/edl/{svc_b}/")[0]

        # the sharded client routes directly and virtualizes leases
        sharded = ShardedStoreClient(topo, timeout=3.0)
        registry = ServiceRegistry(sharded, root="edl")
        reg = registry.register(svc_a, "h:1", info="up", ttl=5.0)
        assert _wait(lambda: registry.get_service(svc_a))
        seen = threading.Event()
        watcher = registry.watch_service(svc_b,
                                         on_add=lambda m: seen.set())
        registry.register_permanent(svc_b, "h:2")
        assert seen.wait(5.0), "watch routed to the owning group"
        # cross-shard watch refuses (try_watch turns this into polling)
        with pytest.raises(EdlStoreError):
            sharded.watch("/edl/")
        watcher.stop()
        reg.stop()
        sharded.close()
        wrong.close()
        right.close()
    finally:
        for s in servers:
            s.stop()


def test_redirect_loop_bounded_and_clear():
    import socketserver

    class _LoopHandler(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                try:
                    wire.recv_msg(self.request)
                except (wire.WireError, OSError):
                    return
                try:
                    wire.send_msg(self.request, {
                        "ok": False, "redirect": True, "group": "g",
                        "endpoints": [self.server.self_ep],
                        "error": "always elsewhere"})
                except OSError:
                    return

    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _LoopHandler)
    srv.daemon_threads = True
    srv.self_ep = f"127.0.0.1:{srv.server_address[1]}"
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        client = StoreClient(srv.self_ep, timeout=2.0, connect_retries=2,
                             retry_interval=0.05, max_hops=3)
        with pytest.raises(EdlStoreError, match="redirect loop"):
            client.put("/loop/x", "1")
        client.close()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5.0)


def test_multi_endpoint_client_skips_dead_endpoint(group):
    dead = f"127.0.0.1:{free_port()}"
    client = StoreClient(f"{dead},{group.endpoints_spec}", timeout=1.0,
                         connect_retries=3, retry_interval=0.05)
    assert client.put("/multi/x", "1") > 0
    assert client.get("/multi/x").value == "1"
    client.close()


def test_shard_key_and_topology_parsing():
    assert shard_key("/edl/teachers/nodes/h:1") == "/edl/teachers"
    assert parse_topology("a:1,b:1") == {"shard0": ["a:1", "b:1"]}
    assert list(parse_topology("x=a:1;y=b:1")) == ["x", "y"]
    chunked = parse_topology("a:1,b:1,c:1", shards=3)
    assert [len(v) for v in chunked.values()] == [1, 1, 1]


def test_asymmetric_partition_writes_bounce_then_client_fails_over(group):
    """The chaos-plane drill as a pinned contract: the old
    leader stays REACHABLE by clients while cut off from quorum. Writes
    through it must bounce with a refusal (never ack-then-lose), a
    multi-endpoint client must fail over and keep writing, and a watch
    resumed by revision must deliver every acked write."""
    old = group.wait_leader()
    # client whose dial order starts at the (about to be deposed) leader
    ordered = [old.endpoint] + [e for e in group.endpoints
                                if e != old.endpoint]
    client = StoreClient(",".join(ordered), timeout=3.0,
                         connect_retries=30, retry_interval=0.05)
    acked: dict[str, int] = {}
    for i in range(3):
        acked[f"pre-{i}"] = client.put(f"/asym/{i}", f"pre-{i}")

    old.node.set_partition(True)  # asymmetric: clients in, quorum out
    # The write the partition catches first must REFUSE (commit gate
    # timeout or not_leader once the lease ages out) — EdlStoreError,
    # not a silent ack. put IS retryable-with-failover, so a refusal
    # may also resolve into a successful re-route; both are correct,
    # ack-then-lose is not.
    t0 = time.monotonic()
    survived = []
    for i in range(3, 8):
        try:
            acked[f"post-{i}"] = client.put(f"/asym/{i}", f"post-{i}")
            survived.append(i)
        except EdlStoreError:
            pass  # refusal: definitively not applied
    assert survived, "client never failed over to the new leader"
    assert time.monotonic() - t0 < 60.0
    new = group.leader()
    assert new is not None and new.endpoint != old.endpoint

    # every ACKED write is delivered exactly once on a fresh watch
    # resumed from before the partition (served by any live replica)
    ha = StoreClient(",".join(e for e in group.endpoints
                              if e != old.endpoint), timeout=3.0)
    watch = ha.watch("/asym/", start_revision=0)
    got: dict[int, str] = {}
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline \
            and not set(acked.values()) <= set(got):
        batch = watch.get(timeout=0.5)
        if batch is None:
            continue
        for ev in batch.events:
            assert ev.revision not in got, "duplicate delivery"
            got[ev.revision] = ev.value
    for value, rev in acked.items():
        assert got.get(rev) == value, f"acked {value}@{rev} lost"
    watch.cancel()
    ha.close()

    old.node.set_partition(None)  # heal: deposed leader snapshot-rejoins
    assert _wait(lambda: old.node.role() == "follower", timeout=15.0)
    client.close()


# -- commit-gated watch fan-out (the branch-anomaly regression) -------------


def test_fanout_gate_reuse_of_revisions_is_invisible():
    """The deterministic half of the branch-anomaly drill: a gated store
    (standing in for a doomed leader) applies a suffix that never
    commits; its watchers must see NOTHING of it — not at apply time,
    not as a resume-anchor advance, and not after the new reign reuses
    those revision numbers with different values (snapshot install)."""
    from edl_tpu_torch.coord.store import InMemStore

    store = InMemStore()
    store.set_fanout_gate(True)
    watch = store.watch("/j/")
    rev1 = store.put("/j/a", "committed")
    store.release_fanout(rev1)
    batch = watch.get(timeout=2.0)
    assert batch is not None and batch.events[0].value == "committed"

    # the doomed suffix: applied locally, never majority-committed
    store.put("/j/k", "doomed-1")
    store.put("/j/k", "doomed-2")
    assert watch.get(timeout=0.2) is None, \
        "uncommitted suffix leaked to a watcher"
    # the resume anchor must NOT advance past the commit gate — a
    # client resuming from it on the new reign would skip the reused
    # revisions entirely
    assert watch.progress_revision() == rev1

    # the new reign: same revision numbers, different (committed) data
    reign = InMemStore()
    reign.apply_put("/j/a", "committed", rev1)
    reign.apply_put("/j/k", "good", rev1 + 1)
    store.install_snapshot(reign.snapshot_state())
    batch = watch.get(timeout=2.0)
    assert batch is not None and batch.compacted, \
        "snapshot rejoin must force an explicit resync"
    assert store.get("/j/k").value == "good"
    # nothing pending survived the snapshot: later releases are no-ops
    store.release_fanout(10_000)
    assert watch.get(timeout=0.2) is None
    watch.cancel()


def test_fanout_gate_late_watcher_gets_tail_exactly_once():
    """A watcher subscribing with start_revision while a suffix is
    buffered replays only the committed prefix; the tail arrives
    exactly once when the commit gate advances over it."""
    from edl_tpu_torch.coord.store import InMemStore

    store = InMemStore()
    store.set_fanout_gate(True)
    r1 = store.put("/j/a", "1")
    store.release_fanout(r1)
    r2 = store.put("/j/b", "2")   # buffered behind the gate
    watch = store.watch("/j/", start_revision=0)
    batch = watch.get(timeout=2.0)
    assert [e.revision for e in batch.events] == [r1]
    assert watch.get(timeout=0.1) is None
    store.release_fanout(r2)
    batch = watch.get(timeout=2.0)
    assert [e.revision for e in batch.events] == [r2]
    assert watch.get(timeout=0.1) is None  # exactly once
    watch.cancel()


def test_fanout_gate_resume_anchor_never_redelivers_pending():
    """The failover-duplicate regression: a watcher that already HAS
    revision R (it resumes with start_revision=R on a replica whose
    commit gate is still behind R) must not be handed R again when the
    gate advances over the replica's pending tail."""
    from edl_tpu_torch.coord.store import InMemStore

    follower = InMemStore()
    follower.set_fanout_gate(True)
    follower.apply_put("/j/a", "1", 1)
    follower.release_fanout(1)
    # rev 2 applied but its commit not yet learned (pending)
    follower.apply_put("/j/b", "2", 2)
    # the client already consumed rev 2 from the dead leader: resume
    watch = follower.watch("/j/", start_revision=2)
    follower.release_fanout(2)
    assert watch.get(timeout=0.2) is None, \
        "resume anchor re-delivered by the commit-gate release"
    # but an event genuinely past the anchor still flows
    follower.apply_put("/j/c", "3", 3)
    follower.release_fanout(3)
    batch = watch.get(timeout=2.0)
    assert [e.revision for e in batch.events] == [3]
    watch.cancel()


def test_watch_on_doomed_leader_never_sees_its_suffix(group):
    """End-to-end over real sockets: a watcher pinned to a leader that
    gets partitioned from quorum must never be shown the write the
    partition catches (it may commit later OR be discarded — either
    way nothing is delivered until the outcome is decided), and after
    the new reign + snapshot rejoin the watcher resyncs to the
    committed branch only."""
    old = group.wait_leader()
    pinned = StoreClient(old.endpoint, timeout=2.0, connect_retries=2,
                         retry_interval=0.05)
    wclient = StoreClient(old.endpoint, timeout=2.0, connect_retries=2,
                          retry_interval=0.05)
    watch = wclient.watch("/branch/", start_revision=0)
    pinned.put("/branch/pre", "committed")

    def drain(seconds, until=None):
        got = []
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            batch = watch.get(timeout=0.2)
            if batch is not None:
                got.append(batch)
                if until is not None and until(batch):
                    break
        return got

    pre = [ev for b in drain(5.0, until=lambda b: any(
        ev.value == "committed" for ev in b.events)) for ev in b.events]
    assert any(ev.value == "committed" for ev in pre)

    old.node.set_partition(True)
    # over the bare wire, as in the fencing case: a client would follow
    # a not_leader hint to the new leader
    resp = _raw(old.endpoint, {"op": "put", "key": "/branch/k",
                               "value": "doomed", "lease": 0})
    assert resp.get("ok") is False, resp
    # whatever the old leader applied locally is behind the commit
    # gate: its watcher must see NO events for it
    assert not [ev for b in drain(1.5) for ev in b.events], \
        "watcher on the doomed leader saw its uncommitted suffix"

    others = [s for s in group.servers if s is not old]
    assert _wait(lambda: any(s.node.is_leader() for s in others),
                 timeout=15.0)
    ha = StoreClient(",".join(s.endpoint for s in others), timeout=3.0)
    ha.put("/branch/k", "good")  # the committed branch (revisions may
    # collide with the doomed suffix's — that is the point)

    old.node.set_partition(None)
    assert _wait(lambda: old.node.role() == "follower", timeout=15.0)
    assert _wait(lambda: old.node.store.get("/branch/k") is not None
                 and old.node.store.get("/branch/k").value == "good",
                 timeout=15.0)
    # the watcher either got an explicit compacted resync (snapshot
    # rejoin) or nothing — but NEVER a doomed value, and never the
    # same revision with two different values
    seen: dict[int, str] = {}
    for b in drain(3.0):
        for ev in b.events:
            assert ev.value != "doomed"
            assert seen.get(ev.revision, ev.value) == ev.value, \
                "same revision delivered with two different values"
            seen[ev.revision] = ev.value
    watch.cancel()
    wclient.close()
    pinned.close()
    ha.close()


# -- the election restriction and divergent followers -----------------------

_EPS = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]


def _node_hearing(answers):
    """An unstarted node of a group of three at revision 5, whose status
    calls to its peers return ``answers[i]`` for peer i (None: the call
    times out)."""
    from edl_tpu_torch.coord.replication import ReplicaNode

    node = ReplicaNode(_EPS[0], _EPS, election_ttl=TTL)
    for i in range(5):
        node.store.put(f"/n/{i}", str(i))
    by_peer = dict(zip(_EPS[1:], answers))

    def peer_call(endpoint, msg, timeout):
        assert msg == {"op": "status"}
        if by_peer[endpoint] is None:
            raise EdlStoreError("timed out")
        return by_peer[endpoint]

    node._peer_call = peer_call
    return node


def _status(revision, dirty=False, commit=0):
    return {"ok": True, "revision": revision, "dirty": dirty,
            "commit": commit}


@pytest.mark.parametrize("answers,defer", [
    ((None, None), True),
    ((_status(3), None), False),
    ((_status(5), _status(5)), False),
    ((_status(6), None), True),
    ((_status(3), _status(6)), True),
    ((_status(9, dirty=True, commit=5), _status(3)), False),
    ((_status(9, dirty=True, commit=6), None), True),
], ids=["no-answer", "a-majority-behind", "all-level", "clean-ahead",
        "one-of-two-ahead", "dirty-suffix-past-its-commit",
        "dirty-commit-ahead"])
def test_candidate_defers_unless_a_majority_shows_it_current(answers,
                                                             defer):
    """The election restriction: an acked write lives on a majority, so
    a candidate campaigns only when a majority answers (itself
    included) and none that answers may hold an acked write it lacks.
    A peer that times out is not taken to be behind: a candidate that
    took it so could win without the last acked writes."""
    node = _node_hearing(answers)
    assert node.store.current_revision == 5
    assert node._peer_ahead() is defer


def test_candidate_asks_again_under_the_quorum_lease():
    """The last reign can ack writes until its lease lapses, so a peer
    may get ahead between the first check and the lease: the elector
    asks again once it holds the lease, and releases it rather than
    rule without those writes."""
    node = _node_hearing((_status(3), _status(3)))
    checks = iter([False])
    node._peer_ahead = lambda: next(checks, True)
    calls = {"acquire": 0, "release": 0, "lead": 0}

    def acquire():
        calls["acquire"] += 1
        return True

    def release():
        calls["release"] += 1

    node.quorum.try_acquire = acquire
    node.quorum.release = release
    node._become_leader = lambda: calls.__setitem__("lead",
                                                    calls["lead"] + 1)
    elector = threading.Thread(target=node._elector, daemon=True)
    elector.start()
    assert _wait(lambda: calls["release"] >= 1, timeout=5.0)
    node._stop.set()
    elector.join(timeout=5.0)
    assert calls["acquire"] >= 1
    assert calls["lead"] == 0


def test_a_follower_ahead_of_the_leader_is_brought_back_by_snapshot(group):
    """A clean follower whose revision is past the leader's holds a
    suffix this reign never wrote. Taken as matched, it would skip the
    leader's next writes at those revision numbers as replays while
    counting toward their majority; the leader ships it a snapshot
    instead, and the follower takes the leader's revision."""
    client = group.client(timeout=3.0)
    client.put("/div/a", "1")
    leader = group.leader()
    follower = next(s for s in group.servers if s is not leader)
    assert _wait(lambda: follower.node.store.get("/div/a") is not None)
    ghost_rev = leader.node.store.current_revision + 50
    follower.node.store.apply_put("/div/ghost", "doomed", ghost_rev)
    # drop the leader's link to the follower: it probes again on reconnect
    leader.node.set_partition([follower.endpoint])
    client.put("/div/b", "2")
    leader.node.set_partition(None)
    rev = client.put("/div/c", "3")
    assert _wait(lambda: follower.node.store.get("/div/c") is not None,
                 timeout=15.0), "the follower skipped the leader's writes"
    assert follower.node.store.get("/div/b").value == "2"
    assert follower.node.store.get("/div/ghost") is None
    assert follower.node.store.current_revision == rev < ghost_rev
    client.close()


# -- across the package line ------------------------------------------------

PACKAGES = {"port": ReplicaServer, "jax": jax_replication.ReplicaServer}
CLIENTS = {"port": StoreClient, "jax": JaxStoreClient}


class _MixedGroup:
    """Three replicas, each from the package named in ``kinds``."""

    def __init__(self, kinds):
        ports = [free_port() for _ in kinds]
        self.endpoints = [f"127.0.0.1:{p}" for p in ports]
        self.servers = [
            PACKAGES[k](self.endpoints[i], ports[i], host="127.0.0.1",
                        group_endpoints=self.endpoints, election_ttl=TTL,
                        commit_timeout=1.5).start()
            for i, k in enumerate(kinds)]

    def leader(self):
        return next((s for s in self.servers
                     if s is not None and s.node.is_leader()), None)

    def wait_leader(self, timeout=20.0):
        assert _wait(lambda: self.leader() is not None, timeout=timeout)
        return self.leader()

    def stop(self):
        for s in self.servers:
            if s is not None:
                s.stop()


@pytest.mark.parametrize("client_kind,kinds", [
    ("port", ("jax", "jax", "jax")),
    ("jax", ("port", "port", "port")),
    ("port", ("port", "jax", "port")),
], ids=["port-client-jax-group", "jax-client-port-group",
        "port-client-mixed-group"])
def test_across_packages_zero_lost_zero_dup(client_kind, kinds):
    """The same writes, reads and a leader kill mid-watch, with a client
    of one package and replicas of the other (or of both in one group):
    every acked write is read back with its revision and delivered to
    the watcher exactly once."""
    group = _MixedGroup(kinds)
    try:
        first = group.wait_leader()
        spec = ",".join(group.endpoints)
        make = CLIENTS[client_kind]
        client = make(spec, timeout=3.0)
        watcher = make(spec, timeout=3.0)
        watch = watcher.watch("/x/", start_revision=0)
        acked = {f"p{i}": client.put(f"/x/rank/{i}", f"p{i}")
                 for i in range(8)}
        lease = client.lease_grant(30.0)
        acked["leased"] = client.put("/x/leased", "leased", lease=lease)
        rec = client.get("/x/rank/3")
        assert (rec.value, rec.revision) == ("p3", acked["p3"])

        killed = first.endpoint
        idx = group.servers.index(first)
        first.kill()
        group.servers[idx] = None
        second = group.wait_leader()
        assert second.endpoint != killed
        assert second.node.term() > 0
        for i in range(8, 16):
            acked[f"p{i}"] = client.put(f"/x/rank/{i}", f"p{i}")
        assert client.get("/x/leased").lease == lease
        recs, _ = client.get_prefix("/x/rank/")
        assert sorted(r.value for r in recs) == sorted(
            v for v in acked if v != "leased")

        seen, duplicates = {}, 0
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline \
                and not set(acked.values()) <= set(seen):
            batch = watch.get(timeout=0.5)
            if batch is None:
                continue
            assert not batch.compacted
            for ev in batch.events:
                duplicates += ev.revision in seen
                seen[ev.revision] = ev.value
        assert duplicates == 0
        lost = [v for v, rev in acked.items() if seen.get(rev) != v]
        assert not lost, f"acked events lost across failover: {lost}"
        watch.cancel()
        watcher.close()
        client.close()
    finally:
        group.stop()


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["selftest", "dryrun"])
def test_the_cli_checks_exit_0(cmd):
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.coord.replication", cmd],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "FAIL" not in out.stdout


def test_connect_store_routes_sharded_endpoints(monkeypatch):
    from edl_tpu_torch.coord.redis_store import connect_store

    store = connect_store("g0=127.0.0.1:1;g1=127.0.0.1:2", timeout=0.5)
    assert isinstance(store, ShardedStoreClient)
    store.close()
    monkeypatch.setenv("EDL_TPU_STORE_SHARDS", "2")
    store = connect_store("127.0.0.1:1,127.0.0.1:2", timeout=0.5)
    assert isinstance(store, ShardedStoreClient)
    store.close()
    monkeypatch.delenv("EDL_TPU_STORE_SHARDS")
    store = connect_store("127.0.0.1:1,127.0.0.1:2", timeout=0.5)
    assert type(store) is StoreClient
    store.close()
    from edl_tpu_torch.coord.redis_store import RedisStore
    from edl_tpu_torch.coord.resp import MiniRedis

    mini = MiniRedis().start()
    try:
        store = connect_store(f"redis://{mini.endpoint}", timeout=0.5)
        assert isinstance(store, RedisStore)
        assert store.ping()
        store.close()
    finally:
        mini.stop()
