"""The port's elastic stop-resume job on the CPU: its store server, its
launchers (``python -m edl_tpu_torch.collective.launch``) and its
``imagenet_train --device cpu`` at ResNetTiny and 16 px over gloo, every
process the port's (none imports JAX).

- a single pod completes and ``/<job>/complete`` is set;
- SIGTERM to a launcher leaves no orphan trainer and releases the claim;
- two pods, then the pod holding rank 0 (both the barrier's leader and
  the checkpoint writer) is SIGKILLed, launcher and trainer session: the
  survivor stop-resumes into a world of one and finishes every epoch
  from the shared checkpoint; its benchmark log starts after epoch 0;
- worlds 2 -> 1 -> 2 on one checkpoint with ``--schedule-epochs`` against
  a straight world of one: acc1 within 0.01 of the straight run, which
  reaches above 0.85 (the bound of
  tests/test_imagenet_multipod.py::test_two_resizes_under_one_percent_acc_loss),
  and each phase trains only its own epochs.

Every test has its own deadline; past it, or on any failure, every
process the test started (found by its job id in /proc too) is killed.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from edl_tpu_torch.collective import register as reg
from edl_tpu_torch.collective.barrier import read_cluster
from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.examples.imagenet_train import make_synthetic_shards
from edl_tpu_torch.utils.net import free_port

ROOT = Path(__file__).resolve().parent.parent
_SPEC = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)
# the chip phase's own means of finding and killing a job's processes
elastic_job_id, kill_groups, pids_with_env = (
    cs.elastic_job_id, cs.kill_groups, cs.pids_with_env)
TRAINER = "edl_tpu_torch.examples.imagenet_train"
TINY = ["--model", "ResNetTiny", "--num-classes", "8", "--image-size", "16",
        "--batch-size", "32", "--warmup-epochs", "1", "--lr-strategy",
        "cosine", "--lr", "0.05", "--no-augment", "--label-smoothing", "0",
        "--device", "cpu"]
# a world of two takes the manual gradient path, as on the card
WORLD_FLAGS = ["--dcn-compress", "int8", "--fused-opt", "fp32"]


def base_env(extra: dict | None = None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("EDL_TPU_", "PALLAS_", "JAX_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


class Job:
    """One elastic job: the port's store server and the launchers started
    for it, under a deadline. Its id is ``name`` made unique to this run
    (elastic_job_id). Leaving the block kills every process of the job
    (by process group and by the job id in /proc)."""

    def __init__(self, tmp_path: Path, name: str, deadline_s: float):
        self.dir, self.name = tmp_path, elastic_job_id(name)
        self.deadline = time.monotonic() + deadline_s
        self.port = free_port()
        self.procs: list[subprocess.Popen] = []
        self.logs = []
        self.store_proc = self._spawn(
            "store", [sys.executable, "-m", "edl_tpu_torch.coord.server",
                      "--host", "127.0.0.1", "--port", str(self.port),
                      "--sweep_interval", "0.05"], base_env())
        self.client = StoreClient(f"127.0.0.1:{self.port}", timeout=5.0,
                                  connect_retries=150, retry_interval=0.1)
        assert self.client.ping(), "store server never came up"

    def _spawn(self, tag, cmd, env):
        self.logs.append(open(self.dir / f"{tag}.log", "wb"))
        proc = subprocess.Popen(cmd, env=env, stdout=self.logs[-1],
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        self.procs.append(proc)
        return proc

    def launcher(self, pod: str, trainer_argv: list,
                 extra_env: dict | None = None) -> subprocess.Popen:
        env = base_env({
            "EDL_TPU_JOB_ID": self.name,
            "EDL_TPU_STORE_ENDPOINTS": f"127.0.0.1:{self.port}",
            "EDL_TPU_POD_ID": pod,
            "EDL_TPU_CHECKPOINT_PATH": str(self.dir / "ckpt"),
            "EDL_TPU_LOG_DIR": str(self.dir / f"log_{pod}"),
            "EDL_TPU_LEASE_TTL": "2.0",
            "EDL_TPU_BARRIER_STABLE": "0.5",
            "EDL_TPU_NODES_RANGE": "1:4",
            "EDL_TPU_RESIZE_P2P": "0",
            **(extra_env or {}),
        })
        return self._spawn(pod, [sys.executable, "-m",
                                 "edl_tpu_torch.collective.launch", "--",
                                 sys.executable, "-m", TRAINER,
                                 *trainer_argv], env)

    def wait_for(self, cond, what: str) -> None:
        while time.monotonic() < self.deadline:
            if cond():
                return
            time.sleep(0.2)
        pytest.fail(f"{self.name}: deadline passed waiting for {what}\n"
                    + self.tails())

    def wait_exit(self, proc: subprocess.Popen, what: str) -> int:
        self.wait_for(lambda: proc.poll() is not None, what)
        return proc.returncode

    def pod_pids(self, pod: str) -> list[int]:
        return pids_with_env(EDL_TPU_JOB_ID=self.name, EDL_TPU_POD_ID=pod)

    def world(self):
        return read_cluster(self.client, self.name)

    def tails(self) -> str:
        return "\n".join(
            f"--- {f.name} ---\n" + Path(f.name).read_text(
                errors="replace")[-3000:] for f in self.logs[1:])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        kill_groups([p.pid for p in self.procs[1:] if p.poll() is None]
                    + pids_with_env(EDL_TPU_JOB_ID=self.name))
        self.client.close()
        self.store_proc.kill()
        for p in self.procs:
            p.wait(timeout=30)
        for f in self.logs:
            f.close()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two learnable shards of 128 rows and a val shard, 8 classes, 16 px
    (the JAX package's multipod data)."""
    d = tmp_path_factory.mktemp("elastic_data")
    make_synthetic_shards(str(d), 2, 128, 16, 8)
    return d


def blog(path: Path) -> dict:
    with open(path / "log_0.json") as f:
        return json.load(f)


def test_single_pod_completes(data_dir, tmp_path):
    with Job(tmp_path, "solo-job", deadline_s=150) as job:
        p = job.launcher("solo", ["--data-dir", str(data_dir), *TINY,
                                  "--epochs", "2"])
        assert job.wait_exit(p, "launcher exit") == 0, job.tails()
        assert job.client.get(f"/{job.name}/complete") is not None
        assert job.world().world_size == 1
        assert reg.live_pods(job.client, job.name)[0] == []


def test_sigterm_launcher_leaves_no_orphan_trainer(data_dir, tmp_path):
    """SIGTERM reaches the launcher only (the trainer is in its own
    session): the launcher must kill the trainer's group inside its grace
    (its loader process too), leave none of the trainer's shared-memory
    ring behind, and release its claim at once (revoked, not
    TTL-drained)."""
    with Job(tmp_path, "term-job", deadline_s=120) as job:
        p = job.launcher("victim", ["--data-dir", str(data_dir), *TINY,
                                    "--epochs", "100", "--loader-workers",
                                    "1"])
        job.wait_for(lambda: job.world() is not None, "cluster formation")
        # the launcher, its trainer and the trainer's loader process
        job.wait_for(lambda: len(job.pod_pids("victim")) >= 3,
                     "trainer and loader start")
        trainers = [pid for pid in job.pod_pids("victim") if pid != p.pid]
        job.wait_for(lambda: any(n.startswith(tuple(
            f"edl_mp_{pid}_" for pid in trainers))
            for n in os.listdir("/dev/shm")), "the loader's ring")
        assert len(reg.live_pods(job.client, job.name)[0]) == 1
        t0 = time.monotonic()
        os.kill(p.pid, signal.SIGTERM)     # the launcher only
        job.wait_exit(p, "launcher exit")
        job.wait_for(lambda: not job.pod_pids("victim"), "trainer cleanup")
        assert time.monotonic() - t0 < 10.0, "the trainer outlived grace"
        assert reg.live_pods(job.client, job.name)[0] == []
        job.wait_for(lambda: not any(n.startswith(tuple(
            f"edl_mp_{pid}_" for pid in trainers))
            for n in os.listdir("/dev/shm")), "the ring's unlink")


def _ends(job: Job, pod: str) -> list[str]:
    """The restart reasons the pod's launcher logged, generation by
    generation."""
    text = (job.dir / f"{pod}.log").read_text(errors="replace")
    return [line.rsplit(": ", 1)[1] for line in text.splitlines()
            if "generation v" in line and " ends: " in line]


def test_two_pods_then_the_rank_0_pod_is_killed(data_dir, tmp_path,
                                                capsys):
    """Kill the pod holding rank 0 once the two-rank world has sealed a
    checkpoint, leaving a torn save behind: the survivor stop-resumes
    (by its trainer's crash or by the lease expiry, whichever its
    launcher sees first) into a world of one and finishes from the last
    sealed checkpoint."""
    epochs = 6
    argv = ["--data-dir", str(data_dir), *TINY, *WORLD_FLAGS, "--epochs",
            str(epochs), "--benchmark-log", str(tmp_path / "blog")]
    with Job(tmp_path, "kill-job", deadline_s=300) as job:
        pods = {name: job.launcher(name, argv) for name in ("podA", "podB")}
        job.wait_for(lambda: getattr(job.world(), "world_size", 0) == 2,
                     "2-pod world")
        ckpt = tmp_path / "ckpt"
        job.wait_for(lambda: ckpt.is_dir() and any(
            c.name.startswith("ckpt-") for c in ckpt.iterdir()),
            "a sealed checkpoint of the 2-pod world")
        first = job.world()
        leader = first.pods[0].pod_id          # rank 0: writer and leader
        survivor = next(p for p in pods if p != leader)
        kill_groups([pods[leader].pid, *job.pod_pids(leader)])
        # what the writer leaves when it dies mid-save: a torn tmp dir
        torn = ckpt / ".tmp-ckpt-killed-writer"
        torn.mkdir(exist_ok=True)
        (torn / "state.msgpack").write_bytes(b"torn")

        def resized():
            c = job.world()
            return (c is not None and c.world_size == 1
                    and c.pod_ids() == {survivor})
        job.wait_for(resized, "stop-resume into a 1-pod world")
        assert job.wait_exit(pods[survivor], "survivor completion") == 0, \
            job.tails()
        assert job.client.get(f"/{job.name}/complete") is not None
        ends = _ends(job, survivor)
        with capsys.disabled():
            print(f"\nsurvivor {survivor}'s generations ended by {ends}")
        assert ends[0] in ("crash", "membership") and ends[-1] == "complete"
        log = blog(tmp_path / "blog")
        trained = [e["epoch"] for e in log["epochs"]]
        # the world of one resumed from the two-rank world's checkpoint
        assert log["world_size"] == 1 and trained[0] > 0, trained
        assert trained == list(range(trained[0], epochs)), trained
        assert log["epochs"][-1]["acc1"] > 0.85, log["epochs"][-1]
        # the next generation restored a sealed version and collected
        # the torn one
        assert not torn.exists()
        banners = sum(f.read_text().count("==== start rank=")
                      for f in (tmp_path / f"log_{survivor}").iterdir())
        assert banners >= 2, "no trainer restart recorded"


def run_world(tmp_path: Path, tag: str, world: int, data_dir: Path,
              epochs: int, ckpt: Path | None = None,
              schedule_epochs: int = 0, coordinator: str = "",
              timeout: float = 150) -> dict:
    """imagenet_train over ``world`` gloo ranks started directly (the
    launcher's env contract, no launcher), as the JAX package's multipod
    test runs its phases; returns rank 0's benchmark log."""
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    blog_dir = tmp_path / f"blog-{tag}"
    extra = ["--ckpt-dir", str(ckpt)] if ckpt else []
    if schedule_epochs:
        extra += ["--schedule-epochs", str(schedule_epochs)]
    procs, logs = [], []
    deadline = time.monotonic() + timeout
    try:
        for rank in range(world):
            env = base_env({"EDL_TPU_RANK": str(rank),
                            "EDL_TPU_WORLD_SIZE": str(world),
                            "EDL_TPU_COORDINATOR": coordinator})
            logs.append(open(tmp_path / f"{tag}.r{rank}.log", "wb"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", TRAINER, "--data-dir", str(data_dir),
                 *TINY, *WORLD_FLAGS, "--epochs", str(epochs),
                 "--benchmark-log", str(blog_dir), *extra],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        for rank, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            assert rc == 0, (f"{tag} rank {rank} exit {rc}:\n" + (
                tmp_path / f"{tag}.r{rank}.log").read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    return blog(blog_dir)


def test_two_resizes_keep_acc1_within_a_hundredth(data_dir, tmp_path):
    """Worlds 2 -> 1 -> 2 on one checkpoint, every phase on the same
    5-epoch cosine curve (--schedule-epochs), against a straight world
    of one over the same 5 epochs. The two-rank phases meet at one
    coordinator port, as a launcher's generations do when rank 0's pod
    keeps its claim: the second binds the port the first one's store
    held."""
    ckpt = tmp_path / "ckpt"
    port = f"127.0.0.1:{free_port()}"
    p1 = run_world(tmp_path, "p1", 2, data_dir, 2, ckpt, 5, port)
    p2 = run_world(tmp_path, "p2", 1, data_dir, 3, ckpt, 5)    # resize 1
    p3 = run_world(tmp_path, "p3", 2, data_dir, 5, ckpt, 5, port)
    straight = run_world(tmp_path, "straight", 1, data_dir, 5)
    assert [e["epoch"] for e in p1["epochs"]] == [0, 1]
    assert [e["epoch"] for e in p2["epochs"]] == [2]
    assert [e["epoch"] for e in p3["epochs"]] == [3, 4]
    assert (p1["world_size"], p2["world_size"], p3["world_size"]) == (2, 1, 2)
    acc_r, acc_s = p3["final"]["acc1"], straight["final"]["acc1"]
    assert acc_s > 0.85, straight["final"]
    assert abs(acc_r - acc_s) < 0.01, (p3["final"], straight["final"])
