"""Resume through the port's CLIs on the CPU.

Exact equality: ``imagenet_train`` (ResNetTiny at 32 px over packed
records, two loader processes, crop/flip on the device) and ``lm_train``
(a 2-layer LM) run 2 epochs straight, and 1 epoch then a resume to 2:
the final checkpoints are the same bytes. Sync and async saves, resumed
at an epoch boundary and mid-epoch (a ``--ckpt-steps`` version copied
into a fresh dir).

The JAX package's ``imagenet_train`` writes a checkpoint after 1 epoch;
the port's CLI restores it bit for bit, and the 3 steps of its second
epoch land within the imagenet slice's bounds
(tests/test_torch_imagenet_slice.py: 1e-4 on the parameters, batch
statistics and fp32 momenta) of the JAX package's own resume from the
same checkpoint.

A world of 2 gloo ranks runs ``imagenet_train`` to a checkpoint and
resumes from it: the ranks come out bitwise equal. ``--profile DIR``
writes a trace on the CPU.
"""

import json
import os
import shutil

import numpy as np
import pytest
from flax import serialization as fser

from edl_tpu.examples import imagenet_train as jimagenet
from edl_tpu_torch import bridge
from edl_tpu_torch.examples import imagenet_train, lm_train
from edl_tpu_torch.train import loop as loop_mod
from edl_tpu_torch.train import serialization as tser
from test_torch_world import free_port, run_world
from test_torch_world import one_torch_thread  # noqa: F401

IMAGENET = ["--model", "ResNetTiny", "--image-size", "32",
            "--num-classes", "10", "--batch-size", "16",
            "--rows-per-file", "32", "--warmup-epochs", "1", "--lr", "0.05",
            "--device", "cpu", "--fused-opt", "fp32"]
PACKED = ["--data-format", "packed", "--loader-workers", "2"]
LM = ["--rows-per-file", "48", "--vocab", "64", "--seq-len", "32",
      "--d-model", "32", "--n-heads", "2", "--n-layers", "2", "--d-ff", "64",
      "--batch-size", "8", "--device", "cpu", "--fused-opt", "int8",
      "--warmup-steps", "1", "--schedule-epochs", "2"]   # the job's total


def latest(ckpt_dir) -> str:
    names = sorted((n for n in os.listdir(ckpt_dir) if n.startswith("ckpt-")),
                   key=lambda n: int(n[5:]))
    return os.path.join(ckpt_dir, names[-1])


def payload(ckpt_dir) -> bytes:
    with open(os.path.join(latest(ckpt_dir), "state.msgpack"), "rb") as f:
        return f.read()


def status(version_dir) -> dict:
    with open(os.path.join(version_dir, "meta.json")) as f:
        return json.load(f)["status"]


def version_at(ckpt_dir, step: int) -> str:
    for n in os.listdir(ckpt_dir):
        if n.startswith("ckpt-") and status(os.path.join(
                ckpt_dir, n))["step"] == step:
            return os.path.join(ckpt_dir, n)
    raise AssertionError(f"no version at step {step}: {os.listdir(ckpt_dir)}")


def straight_and_resumed(main, base: list, tmp_path, sync: bool,
                         mid: bool, steps_per_epoch: int):
    """Final checkpoint payloads of 2 epochs straight and of 1 epoch then
    a resume (or, ``mid``, a resume from the version at step
    steps_per_epoch + 1 copied into a fresh dir)."""
    flags = ["--ckpt-sync"] if sync else []
    if mid:
        # one save mid-epoch 1, between the two epoch-end saves: none is
        # superseded or collected (max_to_keep 3)
        flags += ["--ckpt-steps", str(steps_per_epoch + 1)]
    a, b = tmp_path / "straight", tmp_path / "resumed"
    assert main([*base, "--epochs", "2", "--ckpt-dir", str(a), *flags]) == 0
    if mid:
        src = version_at(a, steps_per_epoch + 1)
        assert status(src)["step_in_epoch"] == 1
        os.makedirs(b)
        shutil.copytree(src, b / os.path.basename(src))
    else:
        assert main([*base, "--epochs", "1", "--ckpt-dir", str(b),
                     *flags]) == 0
        assert status(latest(b))["epoch"] == 0
    assert main([*base, "--epochs", "2", "--ckpt-dir", str(b), *flags]) == 0
    assert status(latest(a)) == status(latest(b))
    return payload(a), payload(b)


@pytest.fixture(scope="module")
def packed_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume_imagenet")
    imagenet_train.make_synthetic_shards(str(d), 2, 32, 32, 10, seed=0)
    from edl_tpu_torch.data.packed_records import pack_npz
    pack_npz(sorted(str(d / f) for f in os.listdir(d)
                    if f.startswith("train")), str(d / "train.pack"))
    return d


@pytest.mark.parametrize("mid", [False, True], ids=["epoch", "mid-epoch"])
@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_imagenet_train_resume_is_exact(packed_data, tmp_path, sync, mid):
    base = ["--data-dir", str(packed_data), *IMAGENET, *PACKED]
    a, b = straight_and_resumed(imagenet_train.main, base, tmp_path, sync,
                                mid, steps_per_epoch=4)
    assert a == b


@pytest.fixture(scope="module")
def lm_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume_lm")
    lm_train.make_synthetic_shards(str(d), 1, 48, 32, 64, seed=0)
    return d


@pytest.mark.parametrize("mid", [False, True], ids=["epoch", "mid-epoch"])
@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_lm_train_resume_is_exact(lm_data, tmp_path, sync, mid):
    base = ["--data-dir", str(lm_data), *LM]
    a, b = straight_and_resumed(lm_train.main, base, tmp_path, sync, mid,
                                steps_per_epoch=6)
    assert a == b


def test_lm_train_sharded_checkpoints_resume(lm_data, tmp_path):
    base = ["--data-dir", str(lm_data), *LM, "--ckpt-sharded",
            "--loader-workers", "2"]
    assert lm_train.main([*base, "--epochs", "1", "--ckpt-dir",
                          str(tmp_path)]) == 0
    assert any(n.startswith("index.") for n in os.listdir(latest(tmp_path)))
    assert lm_train.main([*base, "--epochs", "2", "--ckpt-dir",
                          str(tmp_path)]) == 0
    assert status(latest(tmp_path))["step"] == 12


def _jax_argv(data, ckpt, epochs):
    return ["--data-dir", str(data), "--model", "ResNetTiny",
            "--image-size", "32", "--num-classes", "10", "--batch-size",
            "16", "--rows-per-file", "24", "--warmup-epochs", "1", "--lr",
            "0.05", "--fused-opt", "fp32", "--epochs", str(epochs),
            "--ckpt-dir", str(ckpt), "--ckpt-sync"]


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX package's imagenet_train checkpoint after epoch 0 restores
    in the port's CLI bit for bit; the 3 steps of epoch 1 then agree with
    the JAX package's own resume within the slice's bounds."""
    data = tmp_path / "data"
    jimagenet.make_synthetic_shards(str(data), 2, 24, 32, 10, seed=0)
    assert jimagenet.main(_jax_argv(data, tmp_path / "j", 1)) == 0
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    saved = payload(tmp_path / "j")

    restored = {}
    original = loop_mod.TrainLoop.try_restore

    def probe(self):
        ok = original(self)
        restored["bytes"] = tser.to_bytes(bridge.state_to_flax(self.state))
        restored["status"] = self.status.to_dict()
        return ok

    monkeypatch.setattr(loop_mod.TrainLoop, "try_restore", probe)
    assert imagenet_train.main([*_jax_argv(data, tmp_path / "t", 2),
                                "--device", "cpu"]) == 0
    assert restored["bytes"] == saved
    assert restored["status"]["epoch"] == 0 and \
        restored["status"]["step"] == 3
    assert jimagenet.main(_jax_argv(data, tmp_path / "j", 2)) == 0
    want = fser.msgpack_restore(payload(tmp_path / "j"))
    got = fser.msgpack_restore(payload(tmp_path / "t"))
    assert int(got["step"]) == int(want["step"]) == 6
    for key in ("params", "batch_stats", "opt_state"):
        for (path, x), (_, y) in zip(
                _leaves(got[key]), _leaves(want[key])):
            np.testing.assert_allclose(x, y, atol=1e-4, err_msg=path)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def test_profile_writes_a_trace(packed_data, tmp_path, monkeypatch):
    base = ["--data-dir", str(packed_data), *IMAGENET, "--epochs", "2",
            "--no-augment", "--profile", str(tmp_path / "prof")]
    monkeypatch.setenv("EDL_TPU_PROFILE_START", "2")
    assert imagenet_train.main(base) == 0
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "prof" / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_a_world_of_two_resumes_in_lockstep(tmp_path):
    """Two gloo ranks: imagenet_train to epoch 1 with checkpoints (rank 0
    writes), then resumed to epoch 2 (both ranks restore the version rank
    0 picks): the second run takes only epoch 1's steps and the ranks end
    bitwise equal."""
    data = ["--data-dir", str(tmp_path / "data")]
    common = [*data, "--model", "ResNetTiny", "--image-size", "32",
              "--num-classes", "10", "--batch-size", "16",
              "--rows-per-file", "32", "--warmup-epochs", "1", "--lr",
              "0.05", "--device", "cpu", "--fused-opt", "fp32",
              "--dcn-compress", "int8", "--comm-bucket-mb", "0.05",
              "--ckpt-dir", str(tmp_path / "ckpt")]
    runs = [{"name": "first", "argv": [*common, "--make-synthetic", "2",
                                       "--epochs", "1"]},
            {"name": "resumed", "argv": [*common, "--epochs", "2"]}]
    for run in runs:
        run["coordinator"] = f"127.0.0.1:{free_port()}"
    r0, r1 = run_world("imagenet", 2, tmp_path / "world",
                       {"runs": np.array(json.dumps(runs))}, tcp=True)
    assert len(r0["first/losses"]) == len(r0["resumed/losses"]) == 4
    keys = sorted(k for k in r0 if k.startswith("resumed/sd/"))
    assert keys
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_array_equal(r0["resumed/losses"], r1["resumed/losses"])
    assert status(latest(tmp_path / "ckpt"))["step"] == 8
