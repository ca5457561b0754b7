"""Two knobs the port once ignored, now honoured as the JAX package
honours them.

``EDL_TPU_COORD_WATCH=0`` turns every watch off: ``try_watch`` returns
None in both packages, no watcher registers, and the converted consumers
(the service watcher, the lock handoff) still work on their poll loops.
``EDL_TPU_LEASE_COALESCE=1`` gives ``PodRegister`` the host lease
coalescer by default in both packages: every claim on one host rides one
shared lease, and releasing a pod deletes only its key.
"""

import threading
import time

import pytest

from edl_tpu_torch.collective.cluster import Pod
from edl_tpu_torch.collective.register import PodRegister, \
    default_coalescer, rank_key
from edl_tpu_torch.coord.lock import DistributedLock
from edl_tpu_torch.coord.registry import ServiceRegistry
from edl_tpu_torch.coord.store import InMemStore, try_watch, watch_enabled


@pytest.mark.parametrize("value,enabled", [(None, True), ("1", True),
                                           ("0", False)])
def test_watch_hatch_agrees_with_jax(monkeypatch, value, enabled):
    from edl_tpu.coord.store import InMemStore as JStore
    from edl_tpu.coord.store import try_watch as jtry_watch

    if value is None:
        monkeypatch.delenv("EDL_TPU_COORD_WATCH", raising=False)
    else:
        monkeypatch.setenv("EDL_TPU_COORD_WATCH", value)
    ours, theirs = InMemStore(), JStore()
    w, jw = try_watch(ours, "/any/"), jtry_watch(theirs, "/any/")
    try:
        assert watch_enabled() is enabled
        assert (w is not None) is enabled
        assert (jw is not None) is enabled
        assert ours.watcher_count() == theirs.watcher_count() \
            == (1 if enabled else 0)
    finally:
        for watch in (w, jw):
            if watch is not None:
                watch.cancel()


def test_escape_hatch_restores_pure_polling(monkeypatch):
    """Under the hatch the service watcher's callbacks still fire and a
    lock hands off, each on its poll loop, and no watch registers."""
    monkeypatch.setenv("EDL_TPU_COORD_WATCH", "0")
    store = InMemStore()
    registry = ServiceRegistry(store, root="t")
    seen = threading.Event()
    watcher = registry.watch_service("svc", on_add=lambda m: seen.set(),
                                     interval=0.05)
    registry.register_permanent("svc", "a:1")
    assert seen.wait(2.0)
    assert store.watcher_count() == 0, "a watch leaked past the hatch"
    watcher.stop()
    a = DistributedLock(store, "/l", "A", ttl=5)
    b = DistributedLock(store, "/l", "B", ttl=5)
    assert a.try_acquire()
    got = []
    t = threading.Thread(
        target=lambda: got.append(b.acquire(timeout=5, poll=0.05)))
    t.start()
    time.sleep(0.2)
    a.release()
    t.join(timeout=10)
    assert got == [True]
    assert store.watcher_count() == 0
    b.release()


def _claims(register_cls, pod_cls, store, n):
    regs = []
    for i in range(n):
        reg = register_cls(store, "job", pod_cls(f"pod-{i}", "127.0.0.1"),
                           ttl=5.0)
        reg.claim(timeout=5.0)
        regs.append(reg)
    return regs


@pytest.mark.parametrize("value,coalesced", [(None, False), ("0", False),
                                             ("1", True)])
def test_lease_coalesce_agrees_with_jax(monkeypatch, value, coalesced):
    from edl_tpu.collective.cluster import Pod as JPod
    from edl_tpu.collective.register import PodRegister as JRegister
    from edl_tpu.coord.store import InMemStore as JStore

    if value is None:
        monkeypatch.delenv("EDL_TPU_LEASE_COALESCE", raising=False)
    else:
        monkeypatch.setenv("EDL_TPU_LEASE_COALESCE", value)
    ours, theirs = InMemStore(), JStore()
    assert (default_coalescer(ours, 5.0) is not None) is coalesced
    mine = _claims(PodRegister, Pod, ours, 3)
    jax_regs = _claims(JRegister, JPod, theirs, 3)
    try:
        for regs, store in ((mine, ours), (jax_regs, theirs)):
            assert [r.pod.claimed_rank for r in regs] == [0, 1, 2]
            leases = {r.lease for r in regs}
            # one host lease for every claim, or one lease a pod
            assert len(leases) == (1 if coalesced else 3)
            assert all(store.get(rank_key("job", i)) is not None
                       for i in range(3))
            regs[1].release()
            assert store.get(rank_key("job", 1)) is None
            assert store.get(rank_key("job", 0)) is not None
            assert store.get(rank_key("job", 2)) is not None
    finally:
        for reg in mine + jax_regs:
            reg.release()
        if coalesced:
            for reg in (mine[0], jax_regs[0]):
                reg._coalescer.close()
