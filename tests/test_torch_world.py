"""Worlds of ranks on the CPU, and the port's world formation and
data-parallel imagenet_train against the JAX package.

A world is W ranks started as subprocesses (``World``, ``run_world``).
Each runs only the port (this module imports no JAX at its top, and a
rank never imports it), joins the world over gloo and writes its results
to an .npz file; tests/test_torch_comm.py and
tests/test_torch_comm_step.py start their worlds through the same
harness. Every world has its own
timeout, so a hung rank fails one test and cannot stall the run. A world
that does not exercise ``init_from_env`` meets at a ``FileStore`` under
the test's tmp_path; one that does takes a free TCP port (bound to port
0), so two test workers never collide.

Covered here: ``init_from_env`` (a world of 2 forms, a second call does
nothing, ``shutdown`` leaves it; an empty coordinator raises ``EdlError``
before connecting), ``slice_topology`` and the rank groups against the
JAX package's, and ``imagenet_train`` at world 2 with ``--dcn-compress
int8 --fused-opt fp32`` (ResNetTiny, 2 epochs): the ranks end bitwise
equal in parameters and BatchNorm buffers, rank 0's benchmark log holds
the JAX package's ``stats()`` keys, the loss is finite and falls; the
top-k and bucketed dense wires, run next in the same world of processes,
keep the ranks bitwise equal too. A world
above one without a comm flag exits before any work, naming item 10; in a
world of one the comm flags and env knobs train through the comm step.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
WORLD_TIMEOUT_S = 180


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the test process's own torch work (the
    ranks run with one already). The suite runs several test processes
    side by side, and a pool of one thread per core in each of them
    oversubscribes the cores (six processes on eight cores: a test that
    takes a second alone took half a minute). Modules that import this
    fixture get it too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``world`` ranks of ``task`` (a function of this module's TASKS)
    running as subprocesses; ``results()`` waits for them (at most
    ``timeout`` seconds, then every rank is killed and the test fails)
    and returns each rank's results, in rank order. ``inputs`` (numpy
    arrays) reach every rank through an .npz file. With ``tcp`` the ranks
    join through ``init_from_env`` (the EDL_TPU_* env with a free port),
    else at a FileStore."""

    def __init__(self, task: str, world: int, tmp_path: Path,
                 inputs: dict | None = None, tcp: bool = False,
                 timeout: float = WORLD_TIMEOUT_S):
        self.task, self.world, self.dir = task, world, tmp_path
        self.deadline = time.monotonic() + timeout
        tmp_path.mkdir(parents=True, exist_ok=True)
        np.savez(tmp_path / "in.npz", **(inputs or {}))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("EDL_TPU_", "PALLAS_"))}
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT), str(TESTS), env.get("PYTHONPATH", "")]
        ).rstrip(os.pathsep)
        env["OMP_NUM_THREADS"] = "1"
        coordinator = f"127.0.0.1:{free_port()}" if tcp else ""
        self.procs = []
        for rank in range(world):
            renv = dict(env, EDL_TPU_RANK=str(rank),
                        EDL_TPU_WORLD_SIZE=str(world),
                        EDL_TPU_COORDINATOR=coordinator)
            with open(tmp_path / f"rank{rank}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c",
                     "import test_torch_world as w; w.worker_main()", task,
                     str(tmp_path), "tcp" if tcp else "file"],
                    env=renv, cwd=str(tmp_path), stdout=log,
                    stderr=subprocess.STDOUT))

    def results(self) -> list[dict]:
        try:
            for proc in self.procs:
                proc.wait(timeout=max(0.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        codes = [proc.returncode for proc in self.procs]
        if any(codes):
            logs = "\n".join(
                f"--- rank {r} (exit {c}) ---\n"
                + (self.dir / f"rank{r}.log").read_text()[-4000:]
                for r, c in enumerate(codes))
            pytest.fail(f"world {self.task!r} of {self.world} failed "
                        f"(exit codes {codes}):\n{logs}")
        out = []
        for rank in range(self.world):
            with np.load(self.dir / f"out{rank}.npz") as z:
                out.append({k: z[k] for k in z.files})
        return out


def run_world(task: str, world: int, tmp_path: Path,
              inputs: dict | None = None, tcp: bool = False) -> list[dict]:
    """Start a :class:`World` and wait for its results."""
    return World(task, world, tmp_path, inputs, tcp).results()


def as_json(a: np.ndarray):
    return json.loads(str(a))


# -- the rank side (port only) -----------------------------------------------


def worker_main() -> None:
    task, directory, how = sys.argv[1:4]
    directory = Path(directory)
    torch.set_num_threads(1)
    from edl_tpu_torch.parallel import distributed
    rank = int(os.environ["EDL_TPU_RANK"])
    if how == "file":
        world = int(os.environ["EDL_TPU_WORLD_SIZE"])
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(directory / "store"), world),
            rank=rank, world_size=world)
    with np.load(directory / "in.npz") as z:
        inputs = {k: z[k] for k in z.files}
    out = TASKS[task](inputs, directory)
    np.savez(directory / f"out{rank}.npz", **out)
    distributed.shutdown()


def _task_imagenet(inputs: dict, directory: Path) -> dict:
    """For each run of ``inputs["runs"]`` (JSON: name, argv, coordinator),
    in turn: init_from_env twice, imagenet_train.main at world 2 (it shuts
    the world down at its end), then this rank's losses and final state,
    under ``<name>/``."""
    from edl_tpu_torch.examples import imagenet_train
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.train import comm

    seen = {}
    call = comm.CommTrainStep.__call__

    def probe(self, state, batch):
        state, metrics = call(self, state, batch)
        seen["losses"].append(float(metrics["loss"]))
        seen["state"] = state
        return state, metrics

    comm.CommTrainStep.__call__ = probe
    out = {}
    for run in as_json(inputs["runs"]):
        os.environ["EDL_TPU_COORDINATOR"] = run["coordinator"]
        env = distributed.init_from_env(backend="gloo", device="cpu")
        # a second call returns at once (a second init_process_group raises)
        again = distributed.init_from_env(backend="gloo", device="cpu")
        idempotent = (again == env and distributed.world_size() == 2
                      and distributed.rank() == env.rank)
        seen["losses"] = []
        rc = imagenet_train.main(run["argv"])
        sd = seen["state"].model.state_dict()
        out.update({f"{run['name']}/{k}": v for k, v in {
            "rc": np.array(rc), "rank": np.array(env.rank),
            "idempotent": np.array(idempotent),
            "shut_down": np.array(not distributed.is_initialized()),
            "losses": np.array(seen["losses"]),
            **{f"sd/{k}": v.numpy() for k, v in sd.items()}}.items()})
    return out


def _task_wires(inputs: dict, directory: Path) -> dict:
    """all_gather_int8 of row r of ``gather`` (W, n) and all_to_all_int8
    of block r of ``a2a`` (W, W, m), with this rank's packs."""
    from edl_tpu_torch.ops import pack
    from edl_tpu_torch.parallel import distributed

    r = distributed.rank()
    x = torch.from_numpy(inputs["gather"][r])
    gathered, local = pack.all_gather_int8(x)
    q, scale = pack.pack_int8(x)
    blocks = torch.from_numpy(inputs["a2a"][r])
    packed = [pack.pack_int8(b) for b in blocks]
    return {"gathered": gathered.numpy(), "local": local.numpy(),
            "q": q.numpy(), "scale": scale.numpy(),
            "a2a": pack.all_to_all_int8(blocks).numpy(),
            "a2a_q": torch.stack([p[0] for p in packed]).numpy(),
            "a2a_scale": torch.stack([p[1] for p in packed]).numpy()}


def _task_reduce(inputs: dict, directory: Path) -> dict:
    """comm._reduce_bucket of row r of each case's ``buf`` and ``resid``
    (cases in ``inputs["cases"]``, JSON), with what the int8 leg packed
    (its input u, q and scale)."""
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel import mesh
    from edl_tpu_torch.train import comm

    r = distributed.rank()
    packed = []
    pack_all = comm.pack_int8_buckets

    def probe(us):
        out = pack_all(us)
        packed.extend((u.clone(), q, s) for u, (q, s) in zip(us, out))
        return out

    comm.pack_int8_buckets = probe
    groups: dict = {}
    out = {}
    for case in as_json(inputs["cases"]):
        name, n_slices, chips = case["name"], case["n_slices"], case["chips"]
        if (n_slices, chips) not in groups:
            groups[n_slices, chips] = (mesh.comm_groups(n_slices, chips)
                                       if n_slices > 1 else (None, None))
        config = comm.CommConfig(**case["config"])
        packed.clear()
        red, resid = comm._reduce_bucket(
            torch.from_numpy(inputs[f"{name}/buf"][r]),
            torch.from_numpy(inputs[f"{name}/resid"][r]), n_slices=n_slices,
            chips=chips, config=config, groups=groups[n_slices, chips])
        out[f"{name}/out"] = red.numpy()
        out[f"{name}/resid"] = resid.numpy()
        for k, t in zip(("u", "q", "scale"), packed[0] if packed else ()):
            out[f"{name}/{k}"] = t.numpy()
    return out


def _task_comm_steps(inputs: dict, directory: Path) -> dict:
    """3 CommTrainStep steps of the smoke problems from the weights given
    (``tr/*``, ``cnn/*``), compress off/int8/topk; then the port's
    gates: loss_parity_gate (int8, the CNN) and convergence_smoke (int8,
    topk)."""
    from edl_tpu_torch.train import comm

    config = as_json(inputs["config"])
    out = {}
    for model, smoke in (("tr", comm._smoke_transformer),
                         ("cnn", comm._smoke_cnn)):
        loss_fn, state_fn, batch = smoke(2, device="cpu")
        local = comm._local_rows(batch)
        weights = {k.split("/", 1)[1]: torch.from_numpy(v)
                   for k, v in inputs.items() if k.startswith(model + "/")}
        for mode in comm.COMPRESS_MODES:
            state = state_fn()
            state.model.load_state_dict(weights)
            step = comm.make_comm_train_step(
                loss_fn, config=comm.CommConfig(compress=mode, **config))
            losses = []
            for _ in range(3):
                state, metrics = step(state, local)
                losses.append(float(metrics["loss"]))
            out[f"{model}/{mode}/losses"] = np.array(losses)
            out[f"{model}/{mode}/resid_widths"] = np.array(
                [t.numel() for t in step.resid])
            out[f"{model}/{mode}/stats"] = np.array(json.dumps(step.stats()))
            for k, v in state.model.state_dict().items():
                out[f"{model}/{mode}/sd/{k}"] = v.numpy()
    jax_init = {name: {k.split("/", 1)[1]: torch.from_numpy(v)
                       for k, v in inputs.items() if k.startswith(model + "/")}
                for name, model in (("transformer", "tr"), ("cnn", "cnn"))}
    for name, smoke in (("transformer", comm._smoke_transformer),
                        ("cnn", comm._smoke_cnn)):
        loss_fn, state_fn, batch = smoke(2, device="cpu")
        gate = comm.loss_parity_gate(
            loss_fn, comm._loaded(state_fn, jax_init[name]),
            comm._local_rows(batch),
            config=comm.CommConfig(compress="int8", **config))
        out[f"gate/{name}"] = np.array(json.dumps(gate))
    for mode in ("int8", "topk"):
        out[f"smoke/{mode}"] = np.array(json.dumps(
            comm.convergence_smoke(mode, weights=jax_init, device="cpu")))
    return out


def _task_phased_reduce(inputs: dict, directory: Path) -> dict:
    """For each mode of ``inputs["modes"]`` (JSON: int8, topk, off, and
    off_sliced: compress off over two slices of one rank), two steps of
    CommTrainStep._reduce of this rank's gradients (``g{rank}_{i}``, leaf
    lengths ``leaves``) over a plan of 0.0005 MiB buckets from injected
    residuals, then the same two steps through _reduce_bucket bucket by
    bucket from the same residuals: the reduced gradients and residuals
    of both, and the pack_int8_buckets calls the phased steps made."""
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.parallel import mesh
    from edl_tpu_torch.train import comm

    r = distributed.rank()
    grads = [torch.from_numpy(inputs[f"g{r}_{i}"])
             for i in range(len(inputs["leaves"]))]
    calls = []
    pack_all = comm.pack_int8_buckets

    def probe(us):
        calls.append(len(us))
        return pack_all(us)

    comm.pack_int8_buckets = probe
    out = {}
    for mode in as_json(inputs["modes"]):
        config = comm.CommConfig(
            compress="off" if mode.startswith("off") else mode,
            bucket_mb=0.0005, topk_frac=0.25, min_compress_elems=32)
        step = comm.CommTrainStep(
            None, config=config,
            topology=mesh.SliceTopology(2, 1) if mode == "off_sliced"
            else None)
        step.plan = comm.plan_buckets(grads, config.bucket_mb, align=2)
        if step.n_slices > 1:
            step.groups = mesh.comm_groups(step.n_slices, step.chips)
        rng = np.random.default_rng(10 + r)
        legs = [comm._needs_residual(b, step.chips, step.n_slices, config)
                for b in step.plan.buckets]
        resid0 = [torch.from_numpy(rng.normal(
            0, 1e-3, b.padded if leg else 3).astype(np.float32))
            for b, leg in zip(step.plan.buckets, legs)]
        step.resid = [t.clone() for t in resid0]
        calls.clear()
        for _ in range(2):
            phased = step._reduce([g.clone() for g in grads])
        pack_calls = list(calls)
        resid = [t.clone() for t in resid0]
        for _ in range(2):
            bufs = comm.pack_buckets([g.clone() for g in grads], step.plan)
            outs = []
            for i, buf in enumerate(bufs):
                o, resid[i] = comm._reduce_bucket(
                    buf, resid[i], n_slices=step.n_slices, chips=step.chips,
                    config=config, groups=step.groups)
                outs.append(o)
            one_by_one = comm.unpack_buckets(outs, step.plan)
        for name, gs, rs in (("phased", phased, step.resid),
                             ("one_by_one", one_by_one, resid)):
            out.update({f"{mode}/{name}/g{i}": g.numpy()
                        for i, g in enumerate(gs)})
            out.update({f"{mode}/{name}/resid{i}": t.numpy()
                        for i, t in enumerate(rs)})
        sizes = [b.padded for b in step.plan.buckets]
        out[f"{mode}/info"] = np.array(json.dumps({
            "buckets": step.plan.n_buckets, "sizes": sizes,
            "n_slices": step.n_slices, "pack_calls": pack_calls,
            "int8_legs": sum(legs) if mode == "int8" else 0,
            "dense_small": any(n < config.min_compress_elems
                               for n in sizes)}))
    return out


def _task_wires_reduce(inputs: dict, directory: Path) -> dict:
    """_task_wires, then _task_reduce, in one world."""
    return {**_task_wires(inputs, directory),
            **_task_reduce(inputs, directory)}


TASKS = {"imagenet": _task_imagenet, "wires_reduce": _task_wires_reduce,
         "comm_steps": _task_comm_steps, "phased_reduce": _task_phased_reduce}


# -- the tests ---------------------------------------------------------------

TINY_ARGV = ["--model", "ResNetTiny", "--image-size", "32",
             "--num-classes", "10", "--batch-size", "16", "--epochs", "2",
             "--rows-per-file", "32", "--warmup-epochs", "1", "--lr", "0.05",
             "--device", "cpu", "--no-augment", "--label-smoothing", "0"]
# the JAX package's CommTrainStep.stats() keys
STATS_KEYS = {"comm_buckets", "comm_bucket_mb", "dcn_compress",
              "dcn_bytes_per_step", "dcn_overlap_pct", "comm_steps"}


# the world's runs after the int8 one: the top-k wire and the bucketed
# dense reduction, one epoch each on the int8 run's shards
OTHER_WIRES = {"topk": ["--dcn-compress", "topk"],
               "bucketed_dense": ["--dcn-compress", "off",
                                  "--comm-bucket-mb", "0.05"]}


@pytest.fixture(scope="module")
def imagenet_world(tmp_path_factory):
    """One world of 2 ranks runs imagenet_train three times in turn, each
    at its own coordinator: int8 (2 epochs, writing the shards and the
    benchmark log), then OTHER_WIRES."""
    d = tmp_path_factory.mktemp("imagenet_world")
    data = ["--data-dir", str(d / "data")]
    runs = [{"name": "int8", "argv": [
        *data, "--make-synthetic", "2", *TINY_ARGV, "--dcn-compress", "int8",
        "--comm-bucket-mb", "0.05", "--fused-opt", "fp32", "--benchmark-log",
        str(d / "blog")]}]
    runs += [{"name": name, "argv": [*data, *TINY_ARGV, "--epochs", "1",
                                     "--fused-opt", "fp32", *flags]}
             for name, flags in OTHER_WIRES.items()]
    for run in runs:
        run["coordinator"] = f"127.0.0.1:{free_port()}"
    ranks = run_world("imagenet", 2, d / "world",
                      {"runs": np.array(json.dumps(runs))}, tcp=True)
    return d, ranks


def test_imagenet_train_world_of_two_forms_and_shuts_down(imagenet_world):
    _, ranks = imagenet_world
    for name in ("int8", *OTHER_WIRES):
        assert [int(r[f"{name}/rank"]) for r in ranks] == [0, 1]
        for r in ranks:
            assert int(r[f"{name}/rc"]) == 0
            assert bool(r[f"{name}/idempotent"]), \
                "a second init_from_env re-formed"
            assert bool(r[f"{name}/shut_down"]), \
                "imagenet_train left the world up"


def test_imagenet_train_world_ranks_stay_in_lockstep(imagenet_world):
    _, (r0, r1) = imagenet_world
    keys = sorted(k for k in r0 if k.startswith("int8/sd/"))
    assert keys and keys == sorted(k for k in r1 if k.startswith("int8/sd/"))
    assert any(k.endswith("running_var") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_array_equal(r0["int8/losses"], r1["int8/losses"])


def test_imagenet_train_world_loss_finite_and_falling(imagenet_world):
    _, (r0, _) = imagenet_world
    losses = r0["int8/losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[4:].mean() < losses[:4].mean(), losses


def test_imagenet_train_world_benchmark_log(imagenet_world):
    d, _ = imagenet_world
    assert not (d / "blog" / "log_1.json").exists()
    with open(d / "blog" / "log_0.json") as f:
        blog = json.load(f)
    assert STATS_KEYS <= set(blog)
    assert blog["dcn_compress"] == "int8" and blog["world_size"] == 2
    assert blog["comm_steps"] == 8 and blog["comm_buckets"] > 1
    assert blog["dcn_bytes_per_step"] > 0
    assert {"acc1", "acc5"} <= set(blog["final"])


@pytest.mark.parametrize("name", list(OTHER_WIRES))
def test_imagenet_train_world_other_wires_stay_in_lockstep(imagenet_world,
                                                           name):
    """The top-k wire and the bucketed dense reduction through
    imagenet_train at world 2, one epoch: the ranks end bitwise equal."""
    _, (r0, r1) = imagenet_world
    assert int(r0[f"{name}/rc"]) == int(r1[f"{name}/rc"]) == 0
    losses = r0[f"{name}/losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    keys = [k for k in r0 if k.startswith(f"{name}/sd/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_world_of_two_without_a_comm_flag_exits_before_any_work(
        tmp_path, monkeypatch):
    from edl_tpu_torch.examples import imagenet_train
    monkeypatch.setenv("EDL_TPU_WORLD_SIZE", "2")
    monkeypatch.setenv("EDL_TPU_COORDINATOR", "127.0.0.1:1")
    data_dir = tmp_path / "never-written"
    with pytest.raises(SystemExit, match="item 10"):
        imagenet_train.main(["--data-dir", str(data_dir), "--make-synthetic",
                             "1", *TINY_ARGV])
    assert not data_dir.exists()
    assert not dist.is_initialized()


@pytest.mark.parametrize("flags,env,compress", [
    (["--dcn-compress", "int8"], {}, "int8"),
    (["--comm-bucket-mb", "4"], {}, "off"),
    ([], {"EDL_TPU_DCN_COMPRESS": "topk"}, "topk")])
def test_comm_flags_in_a_world_of_one_run_the_comm_step(
        tmp_path, monkeypatch, capsys, flags, env, compress):
    """The manual gradient path at world 1: one all-reduce of one rank a
    bucket, the wire never runs (K8 is not called), and the benchmark log
    carries the step's accounting."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    blog = tmp_path / "blog"
    from edl_tpu_torch.examples import imagenet_train
    rc = imagenet_train.main(["--data-dir", str(tmp_path / "data"),
                              "--make-synthetic", "1", *TINY_ARGV, *flags,
                              "--fused-opt", "fp32", "--benchmark-log",
                              str(blog)])
    assert rc == 0 and "final_acc1=" in capsys.readouterr().out
    with open(blog / "log_0.json") as f:
        log = json.load(f)
    assert log["dcn_compress"] == compress and log["world_size"] == 1
    assert log["comm_steps"] == 4 and log["dcn_bytes_per_step"] == 0
    assert log["comm_buckets"] >= 1


def test_empty_coordinator_raises_before_connecting():
    from edl_tpu_torch.collective.job_env import TrainerEnv
    from edl_tpu_torch.parallel import distributed
    from edl_tpu_torch.utils.exceptions import EdlError

    assert distributed.init_from_env(TrainerEnv()).world_size == 1
    assert not distributed.is_initialized()
    with pytest.raises(EdlError, match="EDL_TPU_COORDINATOR"):
        distributed.init_from_env(TrainerEnv(world_size=2, rank=0),
                                  backend="gloo", device="cpu")
    assert not distributed.is_initialized()


@pytest.mark.parametrize("world,n_slices", [(1, 0), (4, 0), (4, 1), (4, 2),
                                            (8, 4)])
def test_slice_topology_is_the_jax_package_s(world, n_slices):
    from edl_tpu.collective.job_env import TrainerEnv as JEnv
    from edl_tpu.parallel import distributed as jdist
    from edl_tpu_torch.collective.job_env import TrainerEnv
    from edl_tpu_torch.parallel import distributed

    want = jdist.slice_topology(JEnv(world_size=world, n_slices=n_slices),
                                devices=[object()] * world)
    got = distributed.slice_topology(
        TrainerEnv(world_size=world, n_slices=n_slices))
    assert (got.n_slices, got.chips_per_slice, got.is_multi_slice) == (
        want.n_slices, want.chips_per_slice, want.is_multi_slice)


def test_slice_topology_refuses_a_ragged_split():
    from edl_tpu_torch.collective.job_env import TrainerEnv
    from edl_tpu_torch.parallel import distributed
    with pytest.raises(ValueError, match="not divisible"):
        distributed.slice_topology(TrainerEnv(world_size=6, n_slices=4))


@pytest.mark.parametrize("n_slices,chips", [(1, 4), (2, 2), (4, 1), (2, 4),
                                            (3, 2)])
def test_comm_groups_are_the_jax_package_s(n_slices, chips):
    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu_torch.parallel import mesh

    assert mesh.dp_comm_groups(n_slices, chips) == jmesh.dp_comm_groups(
        n_slices, chips)
    assert mesh.ep_comm_groups(n_slices, chips) == jmesh.ep_comm_groups(
        n_slices, chips)
    topo = mesh.SliceTopology(n_slices, chips)
    assert topo.n_devices == n_slices * chips
    with pytest.raises(ValueError):
        mesh.ep_comm_groups(0, chips)


def test_rank_device_maps_ranks_onto_cards(monkeypatch):
    from edl_tpu_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.rank_device("cuda", 3) == torch.device("cuda", 1)
    assert distributed.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
