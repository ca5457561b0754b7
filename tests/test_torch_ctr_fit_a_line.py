"""The port's ctr_train and fit_a_line (edl_tpu_torch.examples) against
the JAX package's, on the CPU.

- ``ctr_train --device cpu`` end to end at the JAX test's size (3 shards
  of 2,048 rows, 6 epochs, hidden 64, lr 3e-3, batch 256): the AUC over
  the JAX test's bar of 0.62 and the benchmark log's fields as the JAX
  test checks them; ``--store h:p`` over the port's store server, the
  task table all done.
- ``make_synthetic_files`` writes the JAX CLI's arrays, bit for bit.
- fit_a_line: the synthetic stream bit for bit, then two epochs (100
  steps) of the port's step against the JAX CLI's on the bridged init,
  each step's loss within 1e-6 (plain SGD: one fp32 matmul and mean in
  another order a step; measured under 1e-7).
- The port's fit_a_line checkpoint restored by the JAX
  CheckpointManager into the JAX CLI's own state: the parameters equal
  and the status at the last epoch; and a run resumed from it ends at
  the unbroken run's loss, bit for bit.
- The default ``--device cuda`` raises where there is no card, before
  any work.
"""

import json
import zipfile

import jax
import numpy as np
import pytest
import torch

from edl_tpu.examples import ctr_train as jctr
from edl_tpu.examples import fit_a_line as jfal
from edl_tpu.models import linear as jlinear
from edl_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from edl_tpu.train.step import make_train_step as jmake_train_step
from edl_tpu_torch import bridge
from edl_tpu_torch.coord.client import StoreClient
from edl_tpu_torch.coord.server import StoreServer
from edl_tpu_torch.examples import ctr_train, fit_a_line
from edl_tpu_torch.train.checkpoint import CheckpointManager


def _ctr_argv(tmp_path, *extra):
    return ["--data-dir", str(tmp_path / "data"), "--make-synthetic", "3",
            "--rows-per-file", "2048", "--epochs", "6", "--hidden", "64",
            "--lr", "3e-3", "--batch-size", "256", "--device", "cpu",
            "--benchmark-log", str(tmp_path / "blog"), *extra]


def test_ctr_train_end_to_end(tmp_path, capsys):
    assert ctr_train.main(_ctr_argv(tmp_path)) == 0
    blog = json.load(open(tmp_path / "blog" / "log_0.json"))
    assert blog["model"] == "deepfm_ctr"
    assert len(blog["epochs"]) == 6
    assert blog["final"]["auc"] > 0.62, blog["final"]
    assert blog["max_examples_per_sec"] > 0
    assert f"final_auc={blog['final']['auc']:.4f}" in capsys.readouterr().out


def test_ctr_train_over_a_store_server(tmp_path):
    """``--store``: the task table lives on the store server; after the
    run every task of both epochs is done by this trainer."""
    with StoreServer(port=0, host="127.0.0.1") as srv:
        argv = _ctr_argv(tmp_path, "--store", f"127.0.0.1:{srv.port}",
                         "--trainer-id", "t0", "--job-id", "ctrjob")
        argv[argv.index("--epochs") + 1] = "2"
        assert ctr_train.main(argv) == 0
        client = StoreClient(f"127.0.0.1:{srv.port}")
        try:
            for epoch in range(2):
                recs, _ = client.get_prefix(f"/ctrjob/data/e{epoch}/task/")
                states = [json.loads(r.value) for r in recs]
                assert len(states) == 2
                assert all(s["state"] == "done" and s["owner"] == "t0"
                           for s in states)
        finally:
            client.close()


def test_make_synthetic_files_are_the_jax_clis_bytes(tmp_path):
    ours = ctr_train.make_synthetic_files(str(tmp_path / "t"), 2, 300,
                                          seed=3)
    theirs = jctr.make_synthetic_files(str(tmp_path / "j"), 2, 300, seed=3)
    for a, b in zip(ours, theirs):
        with np.load(a) as x, np.load(b) as y:
            assert x.files == y.files == ["dense", "sparse", "label"]
            for k in x.files:
                assert x[k].dtype == y[k].dtype
                assert x[k].tobytes() == y[k].tobytes()
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            for name in za.namelist():
                assert za.read(name) == zb.read(name)


def test_fit_a_line_steps_match_the_jax_cli():
    cfg = jfal.Config(num_epochs=2)
    tcfg = fit_a_line.Config(num_epochs=2)
    jstate, _ = jfal.build(cfg)

    def jloss(state, params, batch):
        pred = state.apply_fn({"params": params}, batch["x"])
        return jlinear.mse_loss(pred, batch["y"]), {}

    jstep = jmake_train_step(jloss, donate=False)
    state, step = fit_a_line.build(tcfg, "cpu")
    state.model.load_state_dict(bridge.flax_variables_to_torch(
        {"params": jax.device_get(jstate.params)}))
    n = 0
    for epoch in range(2):
        for jb, tb in zip(jfal.synthetic_batches(epoch, cfg),
                          fit_a_line.synthetic_batches(epoch, tcfg)):
            for k in ("x", "y"):
                assert jb[k].tobytes() == tb[k].tobytes()
            jstate, jm = jstep(jstate, jb)
            state, tm = step(state, {k: torch.from_numpy(v)
                                     for k, v in tb.items()})
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       atol=1e-6)
            n += 1
    assert n == 100 and state.step == 100
    assert float(tm["loss"]) < 1e-3                    # it fits the line


def test_fit_a_line_checkpoint_restored_by_the_jax_manager(tmp_path):
    ckpt = tmp_path / "ckpt"
    partial = fit_a_line.main(["--device", "cpu", "--num_epochs", "3",
                               "--ckpt_dir", str(ckpt)])
    target, _ = jfal.build(jfal.Config())
    restored, status = JCheckpointManager(str(ckpt)).restore(target)
    assert status.epoch == 2 and status.step == 150
    assert int(restored.step) == 150
    # the parameters the port wrote, as the port's own manager reads them
    raw, _ = CheckpointManager(str(ckpt)).restore_raw()
    for k in ("kernel", "bias"):
        got = np.asarray(restored.params["Dense_0"][k])
        assert got.shape == np.asarray(target.params["Dense_0"][k]).shape
        assert got.tobytes() == np.asarray(
            raw["params"]["Dense_0"][k]).tobytes()
    resumed = fit_a_line.main(["--device", "cpu", "--num_epochs", "5",
                               "--ckpt_dir", str(ckpt)])
    straight = fit_a_line.main(["--device", "cpu", "--num_epochs", "5"])
    assert resumed == straight and resumed < partial


@pytest.mark.parametrize("main,argv", [
    (ctr_train.main, ["--make-synthetic", "3"]),
    (fit_a_line.main, [])])
def test_default_device_cuda_raises_without_a_card(tmp_path, main, argv,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "never-written"
    args = [*argv, "--data-dir", str(data)] if main is ctr_train.main \
        else argv
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        main(args)
    assert not data.exists()
