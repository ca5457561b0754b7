"""The port's InMemStore (edl_tpu_torch.coord.store) against the JAX
package's: the cases of tests/test_store.py that touch the ported part,
on the port's store with a fake clock, and a seeded script of puts,
deletes, CAS, leases, keepalives, expiries, compaction and watches run on
both packages' stores, which must give equal revisions, records, event
histories and watch deliveries.
"""

import random

import pytest

from edl_tpu.coord import store as jax_store
from edl_tpu_torch.coord.store import InMemStore, try_watch
from edl_tpu_torch.utils.exceptions import EdlLeaseExpired


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def clock():
    return FakeClock()


@pytest.fixture
def store(clock):
    return InMemStore(clock=clock)


def test_put_get_delete(store):
    rev1 = store.put("/a/x", "1")
    rev2 = store.put("/a/y", "2")
    assert rev2 == rev1 + 1
    assert store.get("/a/x").value == "1"
    assert store.get("/missing") is None
    recs, rev = store.get_prefix("/a/")
    assert [r.key for r in recs] == ["/a/x", "/a/y"]
    assert rev == rev2
    assert store.delete("/a/x")
    assert not store.delete("/a/x")
    assert store.get("/a/x") is None


def test_put_overwrites_and_bumps_revision(store):
    r1 = store.put("/k", "v1")
    r2 = store.put("/k", "v2")
    assert r2 > r1
    assert store.get("/k").value == "v2"


def test_put_if_absent_races(store):
    assert store.put_if_absent("/rank/0", "pod-a")
    assert not store.put_if_absent("/rank/0", "pod-b")
    assert store.get("/rank/0").value == "pod-a"


def test_compare_and_swap(store):
    assert store.compare_and_swap("/k", None, "v1")
    assert not store.compare_and_swap("/k", None, "again")
    assert store.compare_and_swap("/k", "v1", "v2")
    assert not store.compare_and_swap("/k", "v1", "v3")
    assert store.get("/k").value == "v2"


def test_lease_expiry_deletes_keys(store, clock):
    lease = store.lease_grant(ttl=10.0)
    store.put("/svc/nodes/a", "meta", lease=lease)
    clock.advance(9.0)
    assert store.get("/svc/nodes/a") is not None
    clock.advance(2.0)
    # key must not be alive after the lease expired
    assert store.get("/svc/nodes/a") is None
    with pytest.raises(EdlLeaseExpired):
        store.put("/svc/nodes/b", "x", lease=lease)


def test_lease_keepalive_extends(store, clock):
    lease = store.lease_grant(ttl=10.0)
    store.put("/k", "v", lease=lease)
    for _ in range(5):
        clock.advance(8.0)
        assert store.lease_keepalive(lease)
    assert store.get("/k") is not None
    clock.advance(11.0)
    assert not store.lease_keepalive(lease)
    assert store.get("/k") is None


def test_lease_revoke(store):
    lease = store.lease_grant(ttl=100.0)
    store.put("/k", "v", lease=lease)
    assert store.lease_revoke(lease)
    assert store.get("/k") is None
    assert not store.lease_revoke(lease)


def test_permanent_key_outlives_leases(store, clock):
    store.put("/perm", "v")
    lease = store.lease_grant(ttl=1.0)
    store.put("/eph", "v", lease=lease)
    clock.advance(100.0)
    assert store.get("/perm") is not None
    assert store.get("/eph") is None


def test_overwrite_detaches_old_lease(store, clock):
    lease = store.lease_grant(ttl=5.0)
    store.put("/k", "v1", lease=lease)
    store.put("/k", "v2")  # now permanent
    clock.advance(10.0)
    assert store.get("/k").value == "v2"


def test_events_since(store, clock):
    r0 = store.put("/a", "1")
    store.put("/b", "2")
    store.delete("/a")
    evs, rev, compacted = store.events_since(r0)
    assert not compacted
    assert [(e.type, e.key) for e in evs] == [("PUT", "/b"), ("DELETE", "/a")]
    # prefix filter
    evs, _, _ = store.events_since(0, prefix="/a")
    assert [(e.type, e.key) for e in evs] == [("PUT", "/a"), ("DELETE", "/a")]
    # lease expiry shows up as DELETE events
    lease = store.lease_grant(ttl=1.0)
    store.put("/c", "3", lease=lease)
    clock.advance(2.0)
    evs, _, _ = store.events_since(rev)
    types = [(e.type, e.key) for e in evs]
    assert ("PUT", "/c") in types and ("DELETE", "/c") in types


def test_event_compaction(clock):
    store = InMemStore(clock=clock, max_events=4)
    for i in range(10):
        store.put(f"/k{i}", str(i))
    evs, rev, compacted = store.events_since(0)
    assert compacted
    # a recent revision still works
    evs, _, compacted = store.events_since(rev - 2)
    assert not compacted
    assert len(evs) == 2


def test_compact_trims_history_and_forces_resync(store):
    revs = [store.put(f"/c/{i}", str(i)) for i in range(20)]
    dropped = store.compact(revs[9], keep=4)
    assert dropped == 10
    # below the floor: compacted resync
    _, _, compacted = store.events_since(revs[4])
    assert compacted
    # at or above the floor: normal resume
    evs, _, compacted = store.events_since(revs[9])
    assert not compacted
    assert len(evs) == 10
    # the resume cushion is honoured: compacting "everything" keeps 4
    store.compact(revs[-1], keep=4)
    evs, _, compacted = store.events_since(revs[-5])
    assert not compacted
    assert len(evs) == 4


def test_watch_delivers_puts_deletes_and_expiry(store, clock):
    w = store.watch("/w/")
    store.put("/w/a", "1")
    store.put("/other", "x")
    lease = store.lease_grant(1.0)
    store.put("/w/b", "2", lease=lease)
    store.delete("/w/a")
    clock.advance(2.0)
    store.sweep()
    seen = []
    while (batch := w.get(timeout=0.0)) is not None:
        seen += [(e.type, e.key) for e in batch.events]
    assert seen == [("PUT", "/w/a"), ("PUT", "/w/b"), ("DELETE", "/w/a"),
                    ("DELETE", "/w/b")]
    w.cancel()
    assert store.watcher_count() == 0


def test_watch_resumes_from_a_revision_and_flags_compaction(clock):
    store = InMemStore(clock=clock, max_events=4)
    r1 = store.put("/r/0", "0")
    for i in range(1, 3):
        store.put(f"/r/{i}", str(i))
    w = store.watch("/r/", start_revision=r1)
    batch = w.get(timeout=0.0)
    assert [e.key for e in batch.events] == ["/r/1", "/r/2"]
    w.cancel()
    for i in range(3, 10):
        store.put(f"/r/{i}", str(i))
    w = store.watch("/r/", start_revision=r1)
    assert w.get(timeout=0.0).compacted
    w.cancel()


def test_try_watch_is_none_where_the_store_gives_no_watch(store):
    """try_watch: a watch where the store has one, None (keep polling)
    where its watch raises."""
    w = try_watch(store, "/x/")
    assert w is not None
    w.cancel()

    class NoWatch(InMemStore):
        def watch(self, prefix="", start_revision=None):
            raise NotImplementedError

    assert try_watch(NoWatch(), "/x/") is None


def _script(store, clock, seed: int) -> list:
    """A seeded mix of every ported mutation and read; returns what each
    call answered (records as tuples), then the final state, the event
    history and everything two watches received."""
    rng = random.Random(seed)
    watches = [store.watch("/job/"), store.watch("/job/ranks/")]
    leases, out = [], []
    keys = [f"/job/ranks/{i:06d}" for i in range(4)] + [
        "/job/cluster", "/job/complete", "/other/k"]
    for _ in range(300):
        op = rng.randrange(11)
        key = rng.choice(keys)
        value = str(rng.randrange(5))
        lease = rng.choice(leases) if leases and rng.random() < 0.5 else 0
        try:
            if op == 0:
                out.append(store.put(key, value, lease=lease))
            elif op == 1:
                rec = store.get(key)
                out.append(None if rec is None else tuple(vars(rec).values()))
            elif op == 2:
                out.append(store.delete(key))
            elif op == 3:
                out.append(store.put_if_absent(key, value, lease=lease))
            elif op == 4:
                expect = rng.choice([None, value, "0"])
                out.append(store.compare_and_swap(key, expect, value,
                                                  lease=lease))
            elif op == 5:
                leases.append(store.lease_grant(rng.choice([1.0, 3.0])))
                out.append(leases[-1])
            elif op == 6 and leases:
                out.append(store.lease_keepalive(rng.choice(leases)))
            elif op == 7 and leases:
                out.append(store.lease_revoke(rng.choice(leases)))
            elif op == 8:
                clock.advance(rng.choice([0.5, 1.5]))
                store.sweep()
            elif op == 9:
                recs, rev = store.get_prefix(rng.choice(["/job/", "/"]))
                out.append(([tuple(vars(r).values()) for r in recs], rev))
            else:
                evs, rev, compacted = store.events_since(
                    max(0, store.current_revision - rng.randrange(8)),
                    rng.choice(["", "/job/ranks/"]))
                out.append(([tuple(vars(e).values()) for e in evs], rev,
                            compacted))
        except Exception as exc:  # noqa: BLE001 — the type is compared
            out.append(type(exc).__name__)
    store.compact(store.current_revision - 10, keep=4)
    out.append(store.events_since(0)[2])
    delivered = []
    for w in watches:
        batches = []
        while (b := w.get(timeout=0.0)) is not None:
            batches.append(([tuple(vars(e).values()) for e in b.events],
                            b.revision, b.compacted))
        delivered.append(batches)
        w.cancel()
    recs, rev = store.get_prefix("")
    return [out, [tuple(vars(r).values()) for r in recs], rev, delivered,
            {k: v for k, v in store.stats().items()
             if k in ("keys", "revision", "ops", "leases_live",
                      "leases_expired", "watch_fanout_events")}]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_script_gives_the_jax_package_s_revisions_records_and_events(seed):
    port_clock, jax_clock = FakeClock(), FakeClock()
    ours = _script(InMemStore(clock=port_clock, max_events=64), port_clock,
                   seed)
    theirs = _script(jax_store.InMemStore(clock=jax_clock, max_events=64),
                     jax_clock, seed)
    assert ours == theirs
    assert ours[2] > 30 and "EdlLeaseExpired" in ours[0]
