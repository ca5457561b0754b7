"""The port's serving elasticity against the JAX package's: ServingPolicy
decisions over SimServingPool's steady, step and burst traces held
exactly; the TeacherPoolActuator with the port's TeacherServers on the
CPU (a grow spawns and registers, a graceful drain deregisters first and
completes in-flight work, a drain past its deadline is a counted hard
kill); the collector's pool rollup, which takes the worst teacher's
tail, against the JAX collector's on the same store."""

import json
import threading
import time

import numpy as np
import pytest

from edl_tpu.scaler import serving as jax_srv
from edl_tpu.scaler import simulator as jax_sim
from edl_tpu_torch.scaler import serving as pt_srv
from edl_tpu_torch.scaler import simulator as pt_sim

TRACES = {"steady": lambda m: m.steady(200.0),
          "step": lambda m: m.step(100.0, 4.0, at=40),
          "burst": lambda m: m.burst(100.0, 4.0, at=30, length=25)}


def decisions(srv_mod, sim_mod, trace: str, seed: int):
    """Every tick's (view, proposal) and the run's summary."""
    pool = sim_mod.SimServingPool("svc", TRACES[trace](sim_mod),
                                  teachers=1, max_teachers=16, tick_s=1.0,
                                  noise=0.05, seed=seed)
    policy = srv_mod.ServingPolicy(srv_mod.ServingConfig(
        slo_p95_ms=250.0, breach_ticks=2, idle_ticks=5, cooldown_s=15.0,
        max_teachers=16))
    ticks = []
    for _ in range(160):
        view = pool.tick()
        (prop,) = policy.decide([view], pool.now)
        if prop.is_resize:
            policy.notify_resized(view.service, pool.resize(prop.desired),
                                  pool.now)
        ticks.append((view.n_teachers, view.latency_ms_p95,
                      view.queue_depth, prop.current, prop.desired,
                      prop.reason))
    pool2 = sim_mod.SimServingPool("svc", TRACES[trace](sim_mod),
                                   teachers=1, max_teachers=16, tick_s=1.0,
                                   seed=seed)
    summary = sim_mod.run_serving_policy(pool2, srv_mod.ServingPolicy(
        srv_mod.ServingConfig(slo_p95_ms=250.0, breach_ticks=2,
                              idle_ticks=5, cooldown_s=15.0,
                              max_teachers=16)), ticks=160)
    return ticks, summary


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_serving_policy_decides_what_the_jax_package_decides(trace, seed):
    jax_run = decisions(jax_srv, jax_sim, trace, seed)
    port_run = decisions(pt_srv, pt_sim, trace, seed)
    assert port_run == jax_run
    if trace != "steady":
        assert any(t[3] != t[4] for t in port_run[0])


def test_serving_restore_and_both_selftests_pass(capsys):
    entries = [{"kind": "serving", "service": "svc", "action": "resize",
                "ts": 100.0}, {"job_id": "j", "action": "resize",
                               "ts": 50.0}]
    got = []
    for srv_mod in (jax_srv, pt_srv):
        pol = srv_mod.ServingPolicy(srv_mod.ServingConfig(cooldown_s=15.0,
                                                          breach_ticks=1))
        pol.restore(entries)
        view = srv_mod.ServingView("svc", 1, latency_ms_p95=900.0)
        got.append([pol.decide([view], now)[0].reason
                    for now in (110.0, 120.0)])
    assert got[0] == got[1] == ["cooldown", "slo-breach-grow"]
    assert pt_srv.selftest(verbose=False) == 0
    assert jax_srv.selftest(verbose=False) == 0


# -- the actuator on the port's TeacherServers ---------------------------


@pytest.fixture()
def store_server():
    from edl_tpu_torch.coord.server import StoreServer
    srv = StoreServer(port=0, host="127.0.0.1", sweep_interval=0.1).start()
    yield srv
    srv.stop()


def sleepy(seconds: float):
    def predict(feeds):
        rows = next(iter(feeds.values())).shape[0]
        time.sleep(seconds)
        out = {"logits": np.full((rows, 4), 1.5, np.float32)}
        return lambda: out
    return predict


def local_pool(store, service: str, predict_s: float, *,
               drain_deadline_s: float = 10.0, max_teachers: int = 3):
    from edl_tpu_torch.distill.registrar import TeacherRegistrar
    from edl_tpu_torch.distill.teacher_server import TeacherServer

    def spawn(index):
        del index
        server = TeacherServer(sleepy(predict_s), port=0, host="127.0.0.1",
                               max_batch=8, max_wait=0.001).start()
        registrar = TeacherRegistrar(store, service,
                                     f"127.0.0.1:{server.port}", ttl=2.0,
                                     probe_timeout=10.0)
        registrar.start()
        return pt_srv.LocalTeacher(server, registrar)

    return pt_srv.TeacherPoolActuator(
        spawn, min_teachers=1, max_teachers=max_teachers,
        drain_deadline_s=drain_deadline_s, drain_poll_s=0.05,
        service=service)


def registered(store, service: str) -> list[str]:
    from edl_tpu_torch.coord.registry import ServiceRegistry
    from edl_tpu_torch.distill.registrar import DISTILL_ROOT
    return sorted(m.server for m in ServiceRegistry(
        store, root=DISTILL_ROOT).get_service(service))


def test_grow_spawns_and_registers(store_server):
    act = local_pool(store_server.store, "grow", 0.001)
    try:
        assert act.resize(2) == {"desired_teachers": 2, "requested": 2,
                                 "clamped": False}
        assert act.pool_size() == 2
        assert registered(store_server.store, "grow") == sorted(
            act.endpoints())
        resp = act.actuate("grow", 9)
        assert resp["clamped"] and resp["desired_teachers"] == 3
        assert len(registered(store_server.store, "grow")) == 3
        assert [r["to"] for r in act.resize_log] == [2, 3]
    finally:
        act.close()


def test_graceful_drain_deregisters_first_and_completes_inflight(
        store_server):
    """The retired (newest) teacher leaves discovery before it stops, its
    in-flight requests complete with results, and the drain log records a
    graceful drain with no hard kill."""
    from edl_tpu_torch.distill.teacher_server import TeacherClient
    store = store_server.store
    act = local_pool(store, "drain", 0.4)
    try:
        act.resize(2)
        victim = act.endpoints()[-1]
        client = TeacherClient(victim, timeout=10.0, max_inflight=8)
        pending = [client.predict_async(
            {"image": np.zeros((2, 4), np.float32)}) for _ in range(3)]
        time.sleep(0.1)   # the first group is on the stand-in device
        seen_gone = threading.Event()

        def watch():
            while act.drain_log == []:
                if victim not in registered(store, "drain"):
                    # deregistered while the server still answers
                    if pt_srv.ProcessTeacher(None, None, victim).stats():
                        seen_gone.set()
                    return
                time.sleep(0.01)
        watcher = threading.Thread(target=watch)
        watcher.start()
        act.resize(1)
        results = [p.result() for p in pending]
        assert all(np.allclose(r["logits"], 1.5) for r in results)
        assert act.wait_drains(timeout=10.0)
        watcher.join(timeout=5.0)
        client.close()
        assert seen_gone.is_set()
        (entry,) = act.drain_log
        assert entry["endpoint"] == victim and entry["drained"]
        assert not entry["hard_killed"] and entry["wait_s"] > 0.0
        assert registered(store, "drain") == act.endpoints()
        assert act.stats()["hard_kills"] == 0
    finally:
        act.close()


def test_drain_deadline_falls_back_to_a_counted_hard_kill(store_server):
    from edl_tpu_torch.distill.teacher_server import TeacherClient
    act = local_pool(store_server.store, "kill", 3.0, drain_deadline_s=0.3)
    try:
        act.resize(2)
        victim = act.endpoints()[-1]
        client = TeacherClient(victim, timeout=10.0)
        client.predict_async({"image": np.zeros((1, 4), np.float32)})
        time.sleep(0.1)
        act.resize(1)
        assert act.wait_drains(timeout=10.0)
        (entry,) = act.drain_log
        assert entry["hard_killed"] and not entry["drained"]
        assert act.stats()["hard_kills"] == 1
        assert victim not in registered(store_server.store, "kill")
        client.close()
    finally:
        act.close()


def test_pool_rollup_takes_the_worst_teachers_tail(store_server):
    """Two members' registrar docs on the port's store server, read by
    the port's Collector (in process) and by the JAX package's (through
    its own client over the wire): equal rollups, latency from the worst
    member, rates and queues summed, a blind member counted."""
    from edl_tpu.coord.client import StoreClient as JaxClient
    from edl_tpu.coord.collector import Collector as JaxCollector
    from edl_tpu_torch.coord.collector import Collector
    from edl_tpu_torch.coord.registry import ServiceRegistry
    from edl_tpu_torch.distill.registrar import DISTILL_ROOT
    reg = ServiceRegistry(store_server.store, root=DISTILL_ROOT)
    docs = {"10.0.0.1:1": {"rows_per_sec": 120.0, "util": 0.8,
                           "queue_depth": 3, "latency_ms_p50": 12.0,
                           "latency_ms_p95": 40.0, "shed_per_sec": 0.5,
                           "queue_depth_by_class": {"high": 1},
                           "latency_ms_p95_by_class": {"high": 30.0}},
            "10.0.0.2:2": {"rows_per_sec": 80.0, "util": 0.4,
                           "queue_depth": 1, "latency_ms_p50": 20.0,
                           "latency_ms_p95": 95.0, "draining": True,
                           "queue_depth_by_class": {"high": 2},
                           "latency_ms_p95_by_class": {"high": 10.0}},
            "10.0.0.3:3": ""}
    for server, info in docs.items():
        reg.register_permanent("pool", server,
                               json.dumps(info) if info else "")
    port = Collector(store_server.store, services=("pool",),
                     registry_root=DISTILL_ROOT).service_rollup("pool")
    client = JaxClient(f"127.0.0.1:{store_server.port}")
    try:
        ref = JaxCollector(client, services=("pool",),
                           registry_root=DISTILL_ROOT).service_rollup("pool")
    finally:
        client.close()
    assert port == ref
    assert port["latency_ms_p95"] == 95.0 and port["latency_ms_p50"] == 20.0
    assert port["n_teachers"] == 3 and port["reporting"] == 2
    assert port["rows_per_sec"] == 200.0 and port["queue_depth"] == 4
    assert port["latency_ms_p95_by_class"] == {"high": 30.0}
    assert port["draining"] == 1
