"""The port's HostLeaseCoalescer (edl_tpu_torch.coord.client) on the
port's InMemStore: the cases of tests/test_lease_coalesce.py.

Coalescing reduces keepalive WRITE volume, never failure-detection
latency: a keepalive re-arms deadline = now + ttl, never further;
host-lease expiry sweeps every attached key in ONE event batch; per-pod
detach touches only its own key.
"""

import threading
import time

import pytest

from edl_tpu_torch.coord.client import HostLeaseCoalescer, host_coalescer
from edl_tpu_torch.coord.store import InMemStore


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


def test_host_expiry_sweeps_all_keys_in_one_batch(store, clock):
    # interval is huge so the keepalive thread never writes: the lease
    # must expire purely on the fake clock
    co = HostLeaseCoalescer(store, "host-a", ttl=5.0, interval=3600.0)
    w = store.watch("/pods/")
    for p in range(8):
        lease = co.attach(f"/pods/{p}")
        store.put(f"/pods/{p}", f"pod-{p}", lease=lease)
    # drain the 8 PUT batches first
    puts = 0
    while puts < 8:
        b = w.get(timeout=1.0)
        assert b is not None
        puts += len(b.events)
    clock.advance(6.0)
    store.sweep()
    batch = w.get(timeout=1.0)
    assert batch is not None
    assert len(batch.events) == 8          # ONE sweep batch, not 8
    assert all(e.type == "DELETE" for e in batch.events)
    assert w.get(timeout=0.0) is None
    w.cancel()
    co.close()


def test_host_loss_fires_every_on_lost(store, clock):
    co = HostLeaseCoalescer(store, "host-b", ttl=2.0, interval=0.05)
    fired = set()
    done = threading.Event()

    def lost(p):
        fired.add(p)
        if len(fired) == 4:
            done.set()

    for p in range(4):
        lease = co.attach(f"/pods/{p}", on_lost=lambda p=p: lost(p))
        store.put(f"/pods/{p}", "x", lease=lease)
    clock.advance(3.0)  # past ttl: the next keepalive finds it expired
    assert done.wait(timeout=5.0)
    assert fired == {0, 1, 2, 3}
    assert co.stats()["leases_lost"] == 1
    assert co.stats()["active"] == 0
    assert store.get("/pods/0") is None    # swept with the lease
    co.close()


def test_detach_removes_only_that_key(store, clock):
    co = HostLeaseCoalescer(store, "host-c", ttl=30.0, interval=3600.0)
    for p in range(3):
        lease = co.attach(f"/pods/{p}")
        store.put(f"/pods/{p}", "x", lease=lease)
    co.detach("/pods/1", delete=True)
    assert store.get("/pods/1") is None
    assert store.get("/pods/0") is not None
    assert store.get("/pods/2") is not None
    assert co.stats()["lease_batch_size"] == 2
    assert co.stats()["active"] == 1       # siblings keep the lease
    co.close()


def test_last_detach_retires_the_host_lease(store, clock):
    co = HostLeaseCoalescer(store, "host-d", ttl=30.0, interval=3600.0)
    lease = co.attach("/pods/only")
    store.put("/pods/only", "x", lease=lease)
    co.detach("/pods/only", delete=False)
    assert co.stats()["active"] == 0
    # the revoke swept the still-attached key with the lease
    assert store.get("/pods/only") is None
    # a fresh attach re-grants a NEW lease
    lease2 = co.attach("/pods/again")
    assert lease2 != lease
    assert co.stats()["active"] == 1
    co.close()


def test_keepalive_rearms_to_now_plus_ttl_never_further(store, clock):
    lease = store.lease_grant(10.0)
    store.put("/k", "v", lease=lease)
    clock.advance(5.0)
    assert store.lease_keepalive(lease)    # deadline -> t=15, not t=20
    clock.advance(9.0)                     # t=14: still inside the ttl
    store.sweep()
    assert store.get("/k") is not None
    clock.advance(2.0)                     # t=16: one ttl past the LAST
    store.sweep()                          # keepalive — expired
    assert store.get("/k") is None
    assert not store.lease_keepalive(lease)


def test_keepalives_coalesce_to_one_write_per_interval(store, clock):
    # 16 pods on one host: the write volume is the HOST's keepalive
    # cadence, independent of how many pods attached
    co = HostLeaseCoalescer(store, "host-e", ttl=1.0, interval=0.05)
    for p in range(16):
        co.attach(f"/pods/{p}")
    before = store.op_count
    time.sleep(0.4)
    writes = co.stats()["keepalives_sent"]
    assert writes >= 2                     # the thread is actually running
    # every keepalive is ONE store op, not 16
    assert store.op_count - before <= writes + 2
    assert co.stats()["lease_batch_size"] == 16
    co.close()


def test_one_coalescer_per_store_and_host(store):
    a = host_coalescer(store, "host-f", ttl=30.0)
    assert host_coalescer(store, "host-f") is a
    assert host_coalescer(store, "host-g") is not a
    a.close()
    assert host_coalescer(store, "host-f") is not a   # closed: a new one
    for h in ("host-f", "host-g"):
        host_coalescer(store, h).close()


def test_pod_registers_ride_one_host_lease(store, clock):
    """PodRegister given the host's coalescer: every pod claims on the
    one host lease, a release deletes only its own claim, and the host
    lease's loss marks every register still attached lost."""
    from edl_tpu_torch.collective import register as reg
    from edl_tpu_torch.collective.cluster import Pod

    co = HostLeaseCoalescer(store, "host-r", ttl=2.0, interval=0.05)
    regs = [reg.PodRegister(store, "job", Pod(pod_id=f"p{i}",
                                              addr="127.0.0.1"),
                            ttl=2.0, coalescer=co) for i in range(3)]
    assert [r.claim(timeout=5.0) for r in regs] == [0, 1, 2]
    assert len({r.lease for r in regs}) == 1
    regs[1].release()
    assert [p.pod_id for p in reg.live_pods(store, "job")[0]] == ["p0", "p2"]
    assert co.stats()["lease_batch_size"] == 2
    clock.advance(3.0)     # past ttl: the next keepalive finds it expired
    assert regs[0].lost.wait(5.0) and regs[2].lost.wait(5.0)
    assert not regs[1].lost.is_set()
    assert reg.live_pods(store, "job")[0] == []
    co.close()
