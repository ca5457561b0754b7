"""The ResNet slice as a whole: the port's imagenet_train path (loader
with flip/crop, ResNet, classification step, fused momentum-SGD with fp32
or quantized momentum, eval) against the JAX package's, and the port's
imagenet_train entry point on the CPU.

JAX's fused optimizer runs its Pallas kernels in interpret mode.
ResNetTiny (vd) at 32 px starts from the same variables on both sides
(the port's seeded init, bridged), reads the same synthetic shards
through each package's loader with random_flip_lr/random_crop, and takes
3 steps of make_classification_step (label smoothing 0.1) with
make_fused_tx("sgdm", 0.05, mode, momentum=0.9, weight_decay=1e-4).
Tolerances: the batches bitwise; the losses within 1e-5 and the
parameters and batch statistics within 1e-4 after each step (fp32 sums
in another order, and flax's E[x^2] - E[x]^2 batch variance against
torch's; measured under 4e-6 and 1.1e-5); the fp32 momenta within 1e-4
(measured 1.8e-5 at a largest momentum of 1.8); the int8 momenta,
reassembled from their planes, within 1e-3 (measured 2.1e-4: one
residual step is 5.6e-5 at that magnitude, and the third step's
gradients carry the int8 runs' parameter gap of 1e-5). Batch
normalization over 8 rows of 1x1 in the last stage magnifies any such
gap step by step, so the comparison stops at 3 steps.

The bf16 trajectory: ResNetTiny (vd) in bf16 activations at
imagenet_train's default lr 0.1 (1 epoch of linear warmup, momentum 0.9,
weight decay 1e-4, label smoothing 0.1) for 20 steps of 64 rows (2
epochs of 10 steps over 640 rows), the epoch shape of chip_smoke.py's
ResNet50_vd run. The two frameworks round bf16 activations at different places, so
the trajectories part step by step; the yardstick is the JAX package's
own bf16 rounding, the largest gap between its bf16 and its fp32
per-step losses. The port's bf16 losses lie within 1.5x that of the JAX
package's bf16 losses and within 2x of its fp32 losses (measured 0.88x
and 1.24x, the yardstick 0.14), and the first step within 5e-3 of JAX's
bf16 (the bf16 forward alone; measured 2.2e-3).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.data import pipeline as jpipe
from edl_tpu.examples import imagenet_train as jimagenet
from edl_tpu.models.resnet import ResNetTiny as JTiny
from edl_tpu.ops import opt_kernels as jok
from edl_tpu.train import classification as jcls
from edl_tpu.train import fused_opt as jfo
from edl_tpu.train.state import TrainState as JTrainState
from edl_tpu_torch import bridge
from edl_tpu_torch.data import pipeline as tpipe
from edl_tpu_torch.examples import imagenet_train
from edl_tpu_torch.models.resnet import ResNetTiny
from edl_tpu_torch.ops import opt_kernels as tok
from edl_tpu_torch.train import classification as tcls
from edl_tpu_torch.train import fused_opt as tfo
from edl_tpu_torch.utils.exceptions import EdlError

LR = 0.05
TINY_ARGV = ["--model", "ResNetTiny", "--image-size", "32",
             "--num-classes", "10", "--batch-size", "16", "--epochs", "2",
             "--rows-per-file", "32", "--warmup-epochs", "1", "--lr", "0.05",
             "--device", "cpu"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    imagenet_train.make_synthetic_shards(str(d), 2, 16, 32, 10, seed=0)
    return d


def test_synthetic_shards_are_the_jax_package_s(shards, tmp_path):
    jimagenet.make_synthetic_shards(str(tmp_path), 2, 16, 32, 10, seed=0)
    names = sorted(os.listdir(shards))
    assert names == sorted(os.listdir(tmp_path)) == [
        "train-0000.npz", "train-0001.npz", "val.npz"]
    for name in names:
        with np.load(shards / name) as a, np.load(tmp_path / name) as b:
            assert a["image"].dtype == np.float16
            for k in ("image", "label"):
                np.testing.assert_array_equal(a[k], b[k])


def _variables(seed: int = 0) -> dict:
    """The port's own init (flax's initializers: each block's last BN
    scale at zero), as a flax variable tree."""
    model = ResNetTiny(num_classes=10, vd=True, dtype=torch.float32,
                       device="cpu", seed=seed)
    return bridge.torch_to_flax_variables(model.state_dict())


def _close(got: dict, want: dict, atol: float) -> None:
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        ours = got
        for k in path:
            ours = ours[k.key]
        np.testing.assert_allclose(ours, np.asarray(leaf), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_three_classification_steps_match_jax(shards, mode, monkeypatch):
    # JAX's fused update through its Pallas kernels (interpret mode), for
    # this test only
    monkeypatch.setattr(jok, "_FORCE_INTERPRET", True)
    files = sorted(str(shards / f) for f in os.listdir(shards)
                   if f.startswith("train"))
    v = _variables()
    jmodel = JTiny(num_classes=10, vd=True, dtype=jnp.float32)
    jtx = jfo.make_fused_tx("sgdm", LR, mode, momentum=0.9,
                            weight_decay=1e-4)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=v["params"],
                                tx=jtx, batch_stats=v["batch_stats"])
    jstep = jcls.make_classification_step(10, smoothing=0.1, donate=False)

    model = ResNetTiny(num_classes=10, vd=True, dtype=torch.float32,
                       device="cpu")
    model.load_state_dict(bridge.flax_variables_to_torch(v))
    ttx = tfo.make_fused_tx("sgdm", LR, mode, momentum=0.9,
                            weight_decay=1e-4)
    state = tcls.create_state(model, ttx)
    step = tcls.make_classification_step(10, smoothing=0.1)

    transforms = {"j": (jpipe.random_flip_lr, jpipe.random_crop),
                  "t": (tpipe.random_flip_lr, tpipe.random_crop)}
    jbatches = jpipe.DataLoader(jpipe.FileSource(files), 8, seed=0,
                                transforms=transforms["j"],
                                num_workers=0).epoch(0)
    tbatches = tpipe.DataLoader(tpipe.FileSource(files), 8, seed=0,
                                transforms=transforms["t"],
                                num_workers=0).epoch(0)
    for _, jb, tb in zip(range(3), jbatches, tbatches):
        for k in ("image", "label"):
            np.testing.assert_array_equal(jb[k], tb[k])
        jstate, jm = jstep(jstate, jb)
        state, tm = step(state, {k: torch.from_numpy(x)
                                 for k, x in tb.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        assert float(tm["acc1"]) == float(jm["acc1"])
        ours = bridge.torch_to_flax_variables(model.state_dict())
        _close(ours["params"], jstate.params, 1e-4)
        _close(ours["batch_stats"], jstate.batch_stats, 1e-4)
    assert state.step == int(jstate.step) == 3

    named = bridge.flax_named_parameters(model)
    plan = ttx.plan(named)
    moments = [m if mode == "fp32" else tok.dequant_plane(m, mode)
               for m in state.opt_state.m]
    want = [m if mode == "fp32" else jok.dequant_plane(m, mode)
            for m in jstate.opt_state.m]
    flat = bridge.buckets_to_flax(moments, plan, [n for n, _ in named])
    assert len(flat) == len(want) > 0
    for a, b in zip(flat, want):
        np.testing.assert_allclose(a, np.asarray(b),
                                   atol=1e-4 if mode == "fp32" else 1e-3)
    if mode == "int8":
        assert all(isinstance(m, tok.QPlane) for m in state.opt_state.m)


@pytest.mark.parametrize("fused_opt", ["fp32", "int8", "off"])
def test_imagenet_train_main_on_the_cpu(tmp_path, capsys, fused_opt):
    rc = imagenet_train.main(["--data-dir", str(tmp_path),
                              "--make-synthetic", "2", *TINY_ARGV,
                              "--fused-opt", fused_opt])
    assert rc == 0
    final = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("final_acc1=")]
    assert len(final) == 1
    assert 0.0 <= float(final[0].split("=")[1]) <= 1.0


def test_imagenet_train_mixup_and_benchmark_log(tmp_path, capsys):
    blog = tmp_path / "blog"
    rc = imagenet_train.main(["--data-dir", str(tmp_path / "data"),
                              "--make-synthetic", "2", *TINY_ARGV,
                              "--mixup-alpha", "0.2", "--bf16",
                              "--no-augment", "--benchmark-log", str(blog)])
    assert rc == 0
    assert "final_acc1=" in capsys.readouterr().out
    import json
    with open(blog / "log_0.json") as f:
        log = json.load(f)
    assert log["model"] == "ResNetTiny" and len(log["epochs"]) == 2
    assert {"acc1", "acc5", "examples_per_sec"} <= set(log["final"])


@pytest.mark.parametrize("flags,match", [
    (["--dgc-sparsity", "0.9", "--fused-opt", "fp32"],
     "mutually exclusive"),
    (["--model", "VGG16"], "InvalidRngError")])
def test_unported_flags_exit_before_any_work(tmp_path, flags, match):
    """VGG exits naming the reference's dropout fault (the JAX CLI dies
    at its first step); DGC (ported) with the fused optimizer exits with
    the JAX CLI's words."""
    data_dir = tmp_path / "never-written"
    with pytest.raises(SystemExit, match=match):
        imagenet_train.main(["--data-dir", str(data_dir), "--make-synthetic",
                             "1", *TINY_ARGV, *flags])
    assert not data_dir.exists()


@pytest.mark.parametrize("env,value,match", [
    ("EDL_TPU_WORLD_SIZE", "2", "EDL_TPU_COORDINATOR")])
def test_unported_env_exits_before_any_work(tmp_path, monkeypatch, env,
                                            value, match):
    """A world above one trains now (the SPMD world step); one without a
    coordinator still stops before any work, with init_from_env's typed
    error."""
    monkeypatch.setenv(env, value)
    data_dir = tmp_path / "never-written"
    with pytest.raises(EdlError, match=match):
        imagenet_train.main(["--data-dir", str(data_dir), "--make-synthetic",
                             "1", *TINY_ARGV])
    assert not data_dir.exists()


def _schedule_args() -> argparse.Namespace:
    """imagenet_train's default LR flags with --warmup-epochs 1 and
    --epochs 2, as the chip run passes them."""
    return argparse.Namespace(lr=0.1, warmup_epochs=1, schedule_epochs=0,
                              epochs=2, lr_strategy="piecewise",
                              lr_boundaries=[30, 60, 80], lr_decay=0.1)


def _jax_losses(files, v, dtype, steps_per_epoch) -> list[float]:
    jmodel = JTiny(num_classes=10, vd=True, dtype=dtype)
    sched = jimagenet.build_schedule(_schedule_args(), steps_per_epoch, 1)
    jtx = jfo.make_fused_tx("sgdm", sched, "fp32", momentum=0.9,
                            weight_decay=1e-4)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=v["params"],
                                tx=jtx, batch_stats=v["batch_stats"])
    jstep = jcls.make_classification_step(10, smoothing=0.1, donate=False)
    loader = jpipe.DataLoader(jpipe.FileSource(files), 64, seed=0,
                              num_workers=0)
    losses = []
    for epoch in range(2):
        for batch in loader.epoch(epoch):
            jstate, metrics = jstep(jstate, batch)
            losses.append(float(metrics["loss"]))
    return losses


def test_bf16_trajectory_at_lr_0_1_follows_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jok, "_FORCE_INTERPRET", True)
    imagenet_train.make_synthetic_shards(str(tmp_path), 4, 160, 32, 10,
                                         seed=0)
    files = sorted(str(tmp_path / f) for f in os.listdir(tmp_path)
                   if f.startswith("train"))
    v = _variables()
    want_fp32 = np.array(_jax_losses(files, v, jnp.float32, 10))
    want_bf16 = np.array(_jax_losses(files, v, jnp.bfloat16, 10))

    model = ResNetTiny(num_classes=10, vd=True, dtype=torch.bfloat16,
                       device="cpu")
    model.load_state_dict(bridge.flax_variables_to_torch(v))
    sched = imagenet_train.build_schedule(_schedule_args(), 10)
    state = tcls.create_state(model, tfo.make_fused_tx(
        "sgdm", sched, "fp32", momentum=0.9, weight_decay=1e-4))
    step = tcls.make_classification_step(10, smoothing=0.1)
    loader = tpipe.DataLoader(tpipe.FileSource(files), 64, seed=0,
                              num_workers=0)
    got = []
    for epoch in range(2):
        for batch in loader.epoch(epoch):
            state, metrics = step(state, {k: torch.from_numpy(x)
                                          for k, x in batch.items()})
            got.append(float(metrics["loss"]))
    got = np.array(got)

    assert len(got) == len(want_bf16) == 20 and np.isfinite(got).all()
    yardstick = np.abs(want_bf16 - want_fp32).max()
    assert 0 < yardstick
    assert abs(got[0] - want_bf16[0]) <= 5e-3
    assert np.abs(got - want_bf16).max() <= 1.5 * yardstick
    assert np.abs(got - want_fp32).max() <= 2 * yardstick
