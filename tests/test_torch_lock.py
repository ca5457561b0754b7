"""The port's distributed lock and leader election (coord/lock.py): the
JAX package's lock cases on the port's store (in process and over the
port's store server and client), and cross-package cases: a JAX lock and
a port lock contend for one key on the port's server and each honors the
other's hold, handoff, lease expiry and fencing."""

import threading
import time

import pytest

from edl_tpu.coord.client import StoreClient as JaxClient
from edl_tpu.coord.lock import DistributedLock as JaxLock
from edl_tpu.coord.lock import LeaderElection as JaxElection
from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.coord.lock import (DistributedLock, EdlLockError,
                                      LeaderElection)
from edl_tpu_torch.coord.server import StoreServer
from edl_tpu_torch.coord.store import InMemStore


@pytest.fixture
def store():
    return InMemStore()


@pytest.fixture
def server():
    with StoreServer(port=0, host="127.0.0.1", sweep_interval=0.05) as srv:
        yield srv


@pytest.fixture
def clients(server):
    """A port client and a JAX client on the port's server."""
    ep = f"127.0.0.1:{server.port}"
    made = [StoreClient(ep), JaxClient(ep)]
    yield made
    for c in made:
        c.close()


class TestDistributedLock:
    def test_mutual_exclusion(self, store):
        a = DistributedLock(store, "/l", "A", ttl=5)
        b = DistributedLock(store, "/l", "B", ttl=5)
        assert a.try_acquire()
        assert not b.try_acquire()
        assert a.held() and not b.held()
        a.release()
        assert b.try_acquire()
        b.release()

    def test_reentrant_same_owner(self, store):
        a = DistributedLock(store, "/l", "A", ttl=5)
        assert a.try_acquire()
        assert a.try_acquire()  # idempotent while held
        a.release()

    def test_context_manager(self, store):
        with DistributedLock(store, "/l", "A", ttl=5) as a:
            assert a.held()
            b = DistributedLock(store, "/l", "B", ttl=5)
            assert not b.acquire(timeout=0.3)
        assert DistributedLock(store, "/l", "C", ttl=5).try_acquire()

    def test_acquire_blocks_until_released(self, store):
        a = DistributedLock(store, "/l", "A", ttl=5)
        b = DistributedLock(store, "/l", "B", ttl=5)
        assert a.try_acquire()
        got = []
        t = threading.Thread(target=lambda: got.append(
            b.acquire(timeout=10, poll=0.05)))
        t.start()
        time.sleep(0.2)
        a.release()
        t.join(timeout=10)
        assert got == [True]
        b.release()

    def test_expiry_takeover_and_fencing(self, server):
        """A partitioned holder's lease dies server-side, a rival takes
        the lock; the zombie's held() goes False within its ttl by
        renewal age (no loss event reached it yet)."""
        sa = StoreClient(f"127.0.0.1:{server.port}")
        sb = StoreClient(f"127.0.0.1:{server.port}")
        a = DistributedLock(sa, "/l", "A", ttl=0.4)
        b = DistributedLock(sb, "/l", "B", ttl=5)
        assert a.try_acquire()
        sb.lease_revoke(a._hold.lease)
        assert b.acquire(timeout=10, poll=0.1)
        assert b.held()
        deadline = time.time() + 5
        while a.held() and time.time() < deadline:
            time.sleep(0.05)
        assert not a.held()
        b.release()
        a.release()  # a late zombie release is harmless
        sa.close()
        sb.close()

    def test_stalled_keepalive_flips_held_within_ttl(self, server):
        sa = StoreClient(f"127.0.0.1:{server.port}")
        a = DistributedLock(sa, "/l", "A", ttl=0.5)
        assert a.try_acquire()
        a._hold.stop.set()
        a._hold.keeper.join(timeout=2)
        a._hold.stop.clear()  # held() must flip by renewal age alone
        time.sleep(0.6)
        assert not a.held()
        sa.close()

    def test_release_never_deletes_successor(self, server):
        sa = StoreClient(f"127.0.0.1:{server.port}")
        sb = StoreClient(f"127.0.0.1:{server.port}")
        a = DistributedLock(sa, "/l", "A", ttl=0.4)
        b = DistributedLock(sb, "/l", "B", ttl=5)
        assert a.try_acquire()
        sb.lease_revoke(a._hold.lease)
        assert b.acquire(timeout=10, poll=0.1)
        a.release()
        rec = sb.get("/l")
        assert rec is not None and rec.value == "B"
        b.release()
        sa.close()
        sb.close()

    def test_abandon_frees_only_at_lease_expiry(self, server):
        """abandon() is a holder's crash: no revoke, so a rival waits out
        the TTL instead of taking the key at once."""
        sa = StoreClient(f"127.0.0.1:{server.port}")
        sb = StoreClient(f"127.0.0.1:{server.port}")
        a = DistributedLock(sa, "/l", "A", ttl=0.6)
        b = DistributedLock(sb, "/l", "B", ttl=5)
        assert a.try_acquire()
        t0 = time.monotonic()
        a.abandon()
        assert not a.held() and not b.try_acquire()
        assert b.acquire(timeout=10, poll=0.05)
        assert time.monotonic() - t0 >= 0.3
        b.release()
        sa.close()
        sb.close()

    def test_context_manager_raises_on_timeout(self, store):
        a = DistributedLock(store, "/l", "A", ttl=5)
        assert a.try_acquire()
        b = DistributedLock(store, "/l", "B", ttl=5)
        b.acquire = lambda timeout=None, poll=0.2: False  # force failure
        with pytest.raises(EdlLockError):
            b.__enter__()
        a.release()


class TestLeaderElection:
    def test_campaign_and_observe(self, store):
        ea = LeaderElection(store, "/leader", "A", ttl=5)
        eb = LeaderElection(store, "/leader", "B", ttl=5)
        assert ea.campaign(timeout=5)
        assert ea.is_leader()
        assert not eb.campaign(timeout=0.3)
        assert eb.leader() == "A"
        ea.resign()
        assert eb.campaign(timeout=5)
        assert eb.leader() == "B"
        eb.close()

    def test_on_lost_fires_on_lease_loss(self, server):
        sa = StoreClient(f"127.0.0.1:{server.port}")
        lost = []
        ea = LeaderElection(store=sa, key="/leader", owner="A", ttl=0.4,
                            on_lost=lambda: lost.append(True))
        assert ea.campaign(timeout=5)
        sa.lease_revoke(ea.lock._hold.lease)
        deadline = time.time() + 5
        while not lost and time.time() < deadline:
            time.sleep(0.05)
        assert lost == [True]
        assert not ea.is_leader()
        ea.close()
        sa.close()


class TestAcrossPackages:
    def test_jax_and_port_locks_exclude_each_other(self, clients):
        port_c, jax_c = clients
        p = DistributedLock(port_c, "/x", "port", ttl=5)
        j = JaxLock(jax_c, "/x", "jax", ttl=5)
        assert p.try_acquire()
        assert not j.try_acquire() and not j.held()
        assert jax_c.get("/x").value == "port"
        got = []
        t = threading.Thread(target=lambda: got.append(
            j.acquire(timeout=10, poll=0.05)))
        t.start()
        time.sleep(0.2)
        assert got == []
        p.release()               # the JAX waiter wakes on the DELETE
        t.join(timeout=10)
        assert got == [True] and j.held()
        assert not p.try_acquire()
        assert port_c.get("/x").value == "jax"
        j.release()
        assert p.try_acquire()
        p.release()

    def test_a_dead_jax_holder_is_taken_over_after_its_ttl(self, clients):
        port_c, jax_c = clients
        j = JaxLock(jax_c, "/y", "jax", ttl=0.5)
        p = DistributedLock(port_c, "/y", "port", ttl=5)
        assert j.try_acquire()
        j.abandon()               # the JAX holder crashes (no revoke)
        assert not p.try_acquire()
        assert p.acquire(timeout=10, poll=0.05) and p.held()
        j.release()               # the zombie's release spares the port's
        assert jax_c.get("/y").value == "port"
        p.release()

    def test_port_zombie_is_fenced_when_the_jax_rival_wins(self, clients):
        port_c, jax_c = clients
        p = DistributedLock(port_c, "/z", "port", ttl=0.4)
        j = JaxLock(jax_c, "/z", "jax", ttl=5)
        assert p.try_acquire()
        jax_c.lease_revoke(p._hold.lease)   # the port holder's lease dies
        assert j.acquire(timeout=10, poll=0.05)
        deadline = time.time() + 5
        while p.held() and time.time() < deadline:
            time.sleep(0.05)
        assert not p.held()
        j.release()
        p.release()

    def test_one_leader_across_packages(self, clients):
        port_c, jax_c = clients
        ep = LeaderElection(port_c, "/lead", "port", ttl=5)
        ej = JaxElection(jax_c, "/lead", "jax", ttl=5)
        assert ej.campaign(timeout=5)
        assert not ep.campaign(timeout=0.3)
        assert ep.leader() == "jax" and ej.leader() == "jax"
        ej.close()
        assert ep.campaign(timeout=5) and ep.is_leader()
        assert ej.leader() == "port"
        ep.close()
