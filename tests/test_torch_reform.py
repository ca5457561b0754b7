"""The reform state machine in the port (edl_tpu_torch.collective.reform
and its wiring in train/loop.py): the cases of tests/test_reform.py under
the same asserts, and the machine's documents against the JAX package's.

A surviving trainer rides a world change IN PLACE (quiesce ->
mesh-reform -> peer-restore -> re-jit -> first-step) and every failure
lands on its defined downgrade: donor death mid-peer-restore falls back
to disk, a mesh-reform deadline overrun to a clean stop-resume (and a
half-reformed survivor never acks), a world the hook reports unchanged
keeps the fast path. In the port a rank's world is its process group, so
the tiny loop's ``reform_mesh`` flips a world of one and two by handing
the loop the step built for it; the JAX test's "a second reform of an
already-seen shape performs zero fresh jits" becomes "the step built for
an already-seen world is the one the loop runs again".
"""

import re
import threading
import time

import pytest

from edl_tpu.collective import reform as jrf
from edl_tpu_torch.collective import migration as mig
from edl_tpu_torch.collective import reform as rf
from edl_tpu_torch.collective import register as reg
from edl_tpu_torch.collective.cluster import Cluster, Pod
from edl_tpu_torch.coord.store import InMemStore
from edl_tpu_torch.train import classification as tcls
from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
from edl_tpu_torch.train.state import TrainStatus
from test_torch_checkpoint import port_batch, port_state
from test_torch_world import one_torch_thread  # noqa: F401


# -- machine unit tests (no training loop) -------------------------------------


class TestReformMachine:
    def cfg(self, **kw):
        base = dict(quiesce_s=5.0, mesh_s=5.0, restore_s=5.0,
                    rejit_s=5.0)
        base.update(kw)
        return rf.ReformConfig(**base)

    def test_ladder_happy_path_records_phases_in_order(self):
        m = rf.ReformMachine(2, self.cfg())
        m.run_ladder(quiesce=lambda dl: None,
                     mesh_reform=lambda dl: None,
                     restore_peers=lambda dl: None,
                     restore_disk=lambda dl: None)
        assert m.result == rf.IN_PLACE
        assert m.restore == "peers"
        assert [p["phase"] for p in m.phases] == [
            "quiesce", "mesh-reform", "peer-restore"]
        assert all(p["ok"] for p in m.phases)

    def test_peer_failure_downgrades_to_disk(self):
        def bad_peers(dl):
            raise ConnectionError("donor died mid-transfer")
        m = rf.ReformMachine(2, self.cfg())
        m.run_ladder(mesh_reform=lambda dl: None,
                     restore_peers=bad_peers,
                     restore_disk=lambda dl: None)
        assert m.result == rf.IN_PLACE
        assert m.restore == "disk"
        names = [p["phase"] for p in m.phases]
        assert names == ["mesh-reform", "peer-restore", "disk-restore"]
        assert m.phases[1]["ok"] is False

    def test_disk_failure_lands_on_stop_resume(self):
        def bad(dl):
            raise OSError("no sealed version")
        m = rf.ReformMachine(2, self.cfg())
        m.run_ladder(restore_peers=bad, restore_disk=bad)
        assert m.result == rf.STOP_RESUME
        assert "disk-restore" in m.error

    def test_deadline_overrun_is_a_typed_failure(self):
        # enforcement is post-hoc: a phase that RETURNS late still
        # failed its budget
        m = rf.ReformMachine(2, self.cfg(mesh_s=0.05))
        m.run_ladder(mesh_reform=lambda dl: time.sleep(0.12))
        assert m.result == rf.STOP_RESUME
        assert "deadline exceeded" in m.error
        assert m.phases[0]["overrun"] is True

    def test_quiesce_failure_downgrades_to_stop_resume(self):
        def stuck(dl):
            raise TimeoutError("checkpoint writer did not drain")
        m = rf.ReformMachine(2, self.cfg())
        m.run_ladder(quiesce=stuck, restore_peers=lambda dl: None,
                     restore_disk=lambda dl: None)
        assert m.result == rf.STOP_RESUME
        assert m.restore is None  # never got to the restore phases

    def test_deferred_phases_flag_overruns_without_downgrade(self):
        m = rf.ReformMachine(3, self.cfg(rejit_s=0.01))
        m.run_ladder(quiesce=lambda dl: None)
        m.note_deferred("re-jit", 0.5)
        m.note_deferred("first-step", 0.001)
        doc = m.finish()
        assert doc["result"] == rf.IN_PLACE  # advisory past dispatch
        rejit = [p for p in doc["phases"] if p["phase"] == "re-jit"][0]
        assert rejit["overrun"] is True

    def test_finish_is_idempotent(self):
        m = rf.ReformMachine(2, self.cfg())
        m.run_ladder(quiesce=lambda dl: None)
        assert m.finish() == m.finish()


def _fails(exc):
    def fn(dl):
        raise exc
    return fn


def _sleeps(s):
    return lambda dl: time.sleep(s)


OK = (lambda dl: None)
# (name, ReformConfig kwargs, run_ladder executors, deferred phases)
SCRIPTS = [
    ("happy", {}, dict(quiesce=OK, mesh_reform=OK, restore_peers=OK,
                       restore_disk=OK, rejit=OK), []),
    ("peers-to-disk", {}, dict(mesh_reform=OK,
                               restore_peers=_fails(ConnectionError("x")),
                               restore_disk=OK), [("re-jit", 0.2)]),
    ("disk-fails", {}, dict(restore_peers=_fails(OSError("gone")),
                            restore_disk=_fails(OSError("no sealed"))), []),
    ("quiesce-stuck", {}, dict(quiesce=_fails(TimeoutError("drain")),
                               restore_peers=OK), []),
    ("mesh-overrun", {"mesh_s": 0.02}, dict(quiesce=OK,
                                            mesh_reform=_sleeps(0.06)), []),
    ("peers-no-disk", {}, dict(restore_peers=_fails(ValueError("bad"))),
     []),
    ("deferred-overrun", {"rejit_s": 0.01}, dict(quiesce=OK),
     [("re-jit", 0.5), ("first-step", 0.001)]),
]


def _without_durations(doc: dict) -> dict:
    def clean(p):
        p = {k: v for k, v in p.items() if k != "s"}
        if "error" in p:
            p["error"] = re.sub(r"\d+\.\d+s >", "<s> >", p["error"])
        return p
    out = dict(doc, phases=[clean(p) for p in doc["phases"]])
    if out["error"]:
        out["error"] = re.sub(r"\d+\.\d+s >", "<s> >", out["error"])
    return out


@pytest.mark.parametrize("script", SCRIPTS, ids=[s[0] for s in SCRIPTS])
def test_machine_documents_are_the_jax_package_s(script):
    """The port's and the JAX package's machines over the same scripted
    phase outcomes give the same to_dict() (durations excluded)."""
    _, cfg, execs, deferred = script
    docs = []
    for mod in (rf, jrf):
        base = dict(quiesce_s=5.0, mesh_s=5.0, restore_s=5.0, rejit_s=5.0)
        m = mod.ReformMachine(7, mod.ReformConfig(**{**base, **cfg}))
        m.run_ladder(**execs)
        for name, s in deferred:
            m.note_deferred(name, s)
        docs.append(_without_durations(m.finish()))
    assert docs[0] == docs[1]


# -- generation fencing (the epoch-doc half) ------------------------------------


class TestGenerationFencing:
    def _service(self, store):
        return mig.MigrationService(store, "fjob", "pod0",
                                    addr="127.0.0.1", generation=2)

    def _publish_cluster(self, store, version):
        pods = [Pod(pod_id="pod0", addr="127.0.0.1", claimed_rank=0,
                    rank=0)]
        store.put(reg.cluster_key("fjob"),
                  Cluster(job_id="fjob", version=version,
                          pods=pods).to_json())

    def test_stale_adoption_ack_bounces(self):
        store = InMemStore()
        svc = self._service(store)
        try:
            self._publish_cluster(store, 3)  # the world moved on
            assert svc.ack("adopted", generation=2) is False
            assert store.get(mig.ack_key("fjob", "pod0")) is None
        finally:
            svc.shutdown(linger=False)

    def test_current_generation_ack_lands(self):
        store = InMemStore()
        svc = self._service(store)
        try:
            self._publish_cluster(store, 3)
            assert svc.ack("adopted", generation=3) is True
            rec = store.get(mig.ack_key("fjob", "pod0"))
            assert rec is not None
        finally:
            svc.shutdown(linger=False)

    def test_non_adoption_acks_are_not_fenced(self):
        # a restore ack describes THIS pod's restart, not a claim about
        # the world's generation: it lands even mid-churn
        store = InMemStore()
        svc = self._service(store)
        try:
            self._publish_cluster(store, 9)
            assert svc.ack("peers", generation=2) is True
        finally:
            svc.shutdown(linger=False)


# -- loop-level fault matrix -----------------------------------------------------


class FakeMigration:
    """The loop-facing surface of MigrationService, scriptable."""

    def __init__(self, store, job="rjob", pod="pod0"):
        self.stop_requested = threading.Event()
        self.generation = 1
        self.pod_id = pod
        self.job_id = job
        self.store = store
        self.pending: list = []       # Reform objects to deliver
        self.acks: list = []
        self.adopted_generations: list = []
        self.peer_restore = "ok"      # "ok" | "dead-donor"
        self.restores = 0

    def poll_reform(self):
        return self.pending[0] if self.pending else None

    def adopted(self, reform):
        self.generation = reform.generation
        self.adopted_generations.append(reform.generation)
        if self.pending and self.pending[0] is reform:
            self.pending.pop(0)

    def ack(self, mode, **kw):
        self.acks.append((mode, kw))
        return True

    def flush_advert(self):
        return True

    def restore_from_peers(self, target, **kw):
        self.restores += 1
        if self.peer_restore == "dead-donor":
            raise mig.PeerRestoreError("donor died mid-transfer")
        return target, TrainStatus(), {"bytes_from_peers": 64, "version": 1,
                                       "donors": ["pod0"],
                                       "restore_s": 0.01}

    def shutdown(self, linger=None):
        pass


def _cluster(version):
    return Cluster(job_id="rjob", version=version,
                   pods=[Pod(pod_id="pod0", addr="127.0.0.1",
                             claimed_rank=0, rank=0)])


class ReformHarness:
    """A tiny loop wired like an elastic trainer: the step of the current
    world (built once a world, as a jit caches a shape), scripted reform
    deliveries, the world flipping between one and two."""

    def __init__(self, tmp_path, reform_config=None, steps=12,
                 triggers=None):
        self.steps_built: dict[int, object] = {}
        self.world = 1

        def step_for(world):
            if world not in self.steps_built:
                self.steps_built[world] = tcls.make_classification_step(
                    10, smoothing=0.1)
            return self.steps_built[world]

        def reform_mesh(rank, world, cluster):
            new = 2 if world <= 1 else 1
            if new == self.world:
                return None
            self.world = new
            return step_for(new)

        self.triggers = dict(triggers or {})

        def hook(loop, epoch, step_no, metrics):
            gen = self.triggers.pop(step_no, None)
            if gen is not None:
                # the world flips 2 <-> 1, so the hook's world 1 <-> 2
                world = 1 if gen % 2 == 0 else 2
                self.fake.pending.append(mig.Reform(_cluster(gen), 0, world))

        self.loop = TrainLoop(
            step_for(1), port_state("resnet", "sgdm", "fp32"), device="cpu",
            config=LoopConfig(num_epochs=1, log_every_steps=1,
                              ckpt_dir=str(tmp_path / "ckpt")),
            reform_mesh=reform_mesh, reform_config=reform_config,
            hooks=[hook])
        self.fake = FakeMigration(InMemStore())
        self.loop._migration = self.fake
        self.batches = [{k: v[:4] for k, v in port_batch("resnet", i).items()}
                        for i in range(steps)]

    def run(self):
        return self.loop.run(lambda epoch: iter(self.batches))


class TestLoopReformFaultMatrix:
    def test_reform_restores_from_peers_and_reacks(self, tmp_path):
        h = ReformHarness(tmp_path, triggers={3: 2})
        h.run()
        assert h.loop.reforms == 1
        assert h.fake.adopted_generations == [2]
        adopted = [kw for mode, kw in h.fake.acks if mode == "adopted"]
        assert len(adopted) == 1
        doc = adopted[0]["reform"]
        assert doc["result"] == "in-place"
        assert doc["restore"] == "peers"
        names = [p["phase"] for p in doc["phases"]]
        assert names == ["quiesce", "mesh-reform", "peer-restore",
                         "re-jit", "first-step"]
        assert adopted[0]["bytes_from_peers"] == 64

    def test_second_reform_of_a_seen_world_builds_no_step(self, tmp_path):
        # worlds: 1 (start) -> 2 (gen 2) -> 1 (gen 3, ALREADY BUILT):
        # across three worlds two steps were built, and the last reform
        # runs the first world's step again
        h = ReformHarness(tmp_path, triggers={3: 2, 7: 3})
        first = h.loop.step_fn
        h.run()
        assert h.loop.reforms == 2
        assert len(h.steps_built) == 2, (
            f"expected 2 built steps (worlds 1 and 2), got "
            f"{len(h.steps_built)}: the seen-world reform built another")
        assert h.loop.step_fn is first

    def test_donor_death_mid_peer_restore_falls_back_to_disk(
            self, tmp_path):
        h = ReformHarness(tmp_path, triggers={3: 2})
        h.fake.peer_restore = "dead-donor"
        h.run()
        assert h.loop.reforms == 1
        adopted = [kw for mode, kw in h.fake.acks if mode == "adopted"]
        doc = adopted[0]["reform"]
        assert doc["result"] == "in-place"
        assert doc["restore"] == "disk"
        names = [p["phase"] for p in doc["phases"]]
        assert "peer-restore" in names and "disk-restore" in names
        # the quiesce-sealed version is what disk restored
        assert h.loop.restore_source == "disk"

    def test_mesh_deadline_exceeded_degrades_to_stop_resume(
            self, tmp_path):
        cfg = rf.ReformConfig(quiesce_s=5.0, mesh_s=0.05,
                              restore_s=5.0, rejit_s=5.0)
        h = ReformHarness(tmp_path, reform_config=cfg, triggers={3: 2})
        slow_inner = h.loop.reform_mesh

        def slow_mesh(rank, world, cluster):
            time.sleep(0.12)  # past the 0.05s mesh budget
            return slow_inner(rank, world, cluster)

        h.loop.reform_mesh = slow_mesh
        with pytest.raises(SystemExit) as exc:
            h.run()
        assert exc.value.code == 143  # the graceful-stop exit contract
        assert h.loop.stop_reason == "reform-downgrade"
        assert h.loop.last_reform["result"] == "stop-resume"
        assert "deadline exceeded" in h.loop.last_reform["error"]
        # never adopted, never acked adoption: the launcher's
        # wait_adopted times out into a stop-resume
        assert h.fake.adopted_generations == []
        assert not any(m == "adopted" for m, _ in h.fake.acks)
        # the trainer's generation never advanced, so a late ack through
        # the real service would bounce (TestGenerationFencing)
        assert h.fake.generation == 1

    def test_unchanged_world_keeps_the_fast_path(self, tmp_path):
        # a reform whose hook answers None must not seal or restore
        h = ReformHarness(tmp_path, triggers={3: 2})
        h.loop.reform_mesh = lambda rank, world, cluster: None
        h.run()
        assert h.loop.reforms == 1
        adopted = [kw for mode, kw in h.fake.acks if mode == "adopted"]
        doc = adopted[0]["reform"]
        assert doc["result"] == "in-place"
        assert doc["restore"] is None
        # the run's startup try_restore is the only peer restore
        assert h.fake.restores == 1
        names = [p["phase"] for p in doc["phases"]]
        assert "peer-restore" not in names and "disk-restore" not in names
