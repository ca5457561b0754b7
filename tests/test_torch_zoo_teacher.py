"""The port's zoo-teacher CLI (edl_tpu_torch/distill/teacher_server.py
``_build_model_predict`` and ``main``) and its multi-device predict
(distill/sharded_teacher.py) against the JAX package's, on the CPU.

Both packages' builders restore the same checkpoint (one written by the
JAX package's CheckpointManager, one by the port's; a trainer's
TrainState with its momentum, of which only params and batch_stats are
served) and serve the same feeds: an MLP over uint8 pixels with
``--input-normalize imagenet`` or ``unit``, and the CNN text teacher over
int32 ids. The dense logits within 1e-5 (fp32 sums in another order);
top-k: indices equal and fp16 values within 1e-3 (one fp16 ulp at the
logits' size). The CLI, started as a process, answers the JAX package's
TeacherClient (dense and top-k). ``sharded_predict_fn`` over three CPU
replicas with 5 rows (one padded) matches the JAX function over a dp=3
mesh of the conftest's CPU devices, and the single-device path.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from edl_tpu_torch import bridge
from edl_tpu_torch.distill import sharded_teacher
from edl_tpu_torch.distill import teacher_server as tts
from edl_tpu_torch.models.bow import CNNClassifier
from edl_tpu_torch.models.mlp import MLP

ROOT = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(2)
SHAPE = (6, 6, 3)


def _teacher(kind: str, seed: int = 5):
    """(model, input shape, input dtype, feeds) of a CLI case."""
    if kind == "cnn":
        model = CNNClassifier(vocab_size=30000, embed_dim=128,
                              num_filters=128, num_classes=10,
                              device="cpu", seed=seed)
        ids = RNG.integers(0, 30000, (5, 16)).astype(np.int32)
        ids[:, 12:] = 0
        return model, (16,), "int32", ids
    model = MLP(10, in_features=int(np.prod(SHAPE)), device="cpu",
                seed=seed)
    pixels = RNG.integers(0, 256, (5,) + SHAPE).astype(np.uint8)
    return model, SHAPE, "float32", pixels


def _save(which: str, model, directory: Path) -> None:
    """A trainer's checkpoint of ``model`` with momentum, written by the
    JAX package's CheckpointManager or by the port's."""
    if which == "jax":
        import jax
        import optax

        from edl_tpu.train.checkpoint import CheckpointManager as JManager
        from edl_tpu.train.state import TrainState as JTrainState
        from edl_tpu.train.state import TrainStatus as JStatus

        v = jax.tree.map(np.array,
                         bridge.torch_to_flax_variables(model.state_dict()))
        state = JTrainState.create(apply_fn=None, params=v["params"],
                                   tx=optax.sgd(0.1, momentum=0.9),
                                   batch_stats=v.get("batch_stats"))
        mgr = JManager(str(directory))
        mgr.save(state, JStatus(epoch=2))
        mgr.close()
        return
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.classification import create_state
    from edl_tpu_torch.train.fused_opt import make_fused_tx
    from edl_tpu_torch.train.state import TrainStatus

    mgr = CheckpointManager(str(directory))
    mgr.save(create_state(model, make_fused_tx("sgdm", 0.1, "fp32",
                                               momentum=0.9)),
             TrainStatus(epoch=2))
    mgr.close()


def _fetch(out):
    return {k: np.asarray(v) for k, v in
            (out() if callable(out) else out).items()}


CASES = [("mlp", "imagenet", 0), ("mlp", "unit", 4), ("cnn", "", 0),
         ("cnn", "", 3)]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind,norm,topk", CASES,
                         ids=[f"{k}-{n or 'raw'}-top{t}" for k, n, t in CASES])
def test_build_model_predict_matches_jax(tmp_path, writer, kind, norm, topk):
    from edl_tpu.distill.teacher_server import \
        _build_model_predict as jbuild

    model, shape, dtype, feeds = _teacher(kind)
    _save(writer, model, tmp_path)
    name = "CNNClassifier" if kind == "cnn" else "mlp"
    args = (name, 10, str(tmp_path), "image", "logits", shape, dtype, topk,
            "", norm)
    jpredict, jmeta = jbuild(*args)
    predict, meta = tts._build_model_predict(*args, device="cpu")
    assert meta == jmeta
    want, got = _fetch(jpredict({"image": feeds})), \
        _fetch(predict({"image": feeds}))
    assert sorted(got) == sorted(want)
    if not topk:
        assert got["logits"].dtype == np.float32
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   atol=1e-5)
        with torch.no_grad():   # and the restored weights are the model's
            x = torch.from_numpy(feeds.astype(dtype))
            if norm:
                from edl_tpu_torch.ops.augment import normalize_image
                x = normalize_image(x, norm)
            np.testing.assert_allclose(got["logits"], model(x).numpy(),
                                       atol=1e-5)
        return
    np.testing.assert_array_equal(got["logits.idx"], want["logits.idx"])
    assert got["logits.val"].dtype == np.float16
    np.testing.assert_allclose(got["logits.val"].astype(np.float32),
                               np.asarray(want["logits.val"], np.float32),
                               atol=1e-3)


def test_without_params_the_seeded_init_serves():
    predict, meta = tts._build_model_predict(
        "mlp", 10, "", "image", "logits", (4, 4, 1), "float32", 20, "",
        "", device="cpu")
    assert meta == {"logits": {"topk": 10, "classes": 10, "values": "<f2"}}
    out = predict({"image": np.zeros((3, 4, 4, 1), np.float32)})()
    assert out["logits.idx"].shape == (3, 10)   # --serve-topk clamped


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_served_through_the_jax_client(tmp_path):
    """``python -m edl_tpu_torch.distill.teacher_server`` on the CPU,
    restoring a port checkpoint with --serve-topk 3, answers the JAX
    package's TeacherClient: a dense client scatter-expands the top-3
    (the rest at the wire's -1e30 fill),
    a sparse one reads (idx, val); both agree with the in-process
    predict."""
    from edl_tpu.distill.teacher_server import TeacherClient as JClient

    model, shape, dtype, feeds = _teacher("mlp", seed=9)
    _save("port", model, tmp_path / "ck")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("EDL_TPU_", "PALLAS_"))}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.distill.teacher_server",
         "--device", "cpu", "--model", "mlp", "--num-classes", "10",
         "--input-shape", ",".join(map(str, shape)), "--input-normalize",
         "unit", "--params", str(tmp_path / "ck"), "--serve-topk", "3",
         "--host", "127.0.0.1", "--port", str(port), "--max-batch", "8"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                dense = JClient(f"127.0.0.1:{port}", timeout=10.0)
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline
                time.sleep(0.2)
        sparse = JClient(f"127.0.0.1:{port}", timeout=10.0, expand=False)
        try:
            assert dense.ping()
            got_dense = dense.predict({"image": feeds})["logits"]
            got_sparse = sparse.predict({"image": feeds})
        finally:
            dense.close()
            sparse.close()
    finally:
        proc.kill()
        proc.wait()
    predict, _ = tts._build_model_predict(
        "mlp", 10, str(tmp_path / "ck"), "image", "logits", shape, dtype, 3,
        "", "unit", device="cpu")
    want = predict({"image": feeds})()
    np.testing.assert_array_equal(got_sparse["logits.idx"],
                                  want["logits.idx"])
    np.testing.assert_array_equal(got_sparse["logits.val"],
                                  want["logits.val"])
    assert got_dense.shape == (5, 10)
    rows = np.arange(5)[:, None]
    np.testing.assert_array_equal(got_dense[rows, want["logits.idx"]],
                                  want["logits.val"].astype(np.float32))
    assert (np.sort(got_dense, 1)[:, :-3] <= -1e30).all()   # the fill


@pytest.mark.parametrize("topk", [0, 3])
def test_sharded_predict_over_three_replicas_matches_jax_dp3(topk):
    import jax

    from edl_tpu.distill.sharded_teacher import \
        sharded_predict_fn as jsharded
    from edl_tpu.models.mlp import MLP as JMLP
    from edl_tpu.parallel import mesh as mesh_lib

    model = MLP(10, (16,), in_features=12, device="cpu", seed=4)
    v = jax.tree.map(np.array,
                     bridge.torch_to_flax_variables(model.state_dict()))
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec({"dp": 3}), n_devices=3)
    jmodel = JMLP(10, (16,))
    jpredict, jmeta = jsharded(
        lambda var, x: jmodel.apply(var, x, train=False),
        mesh_lib.replicate_host_tree(mesh, v), mesh, serve_topk=topk,
        classes=10)
    predict, meta = sharded_teacher.sharded_predict_fn(
        lambda m, x: m(x), model, devices=["cpu"] * 3, serve_topk=topk,
        classes=10)
    one, _ = sharded_teacher.sharded_predict_fn(
        lambda m, x: m(x), MLP(10, (16,), in_features=12, device="cpu",
                               seed=4), "cpu", serve_topk=topk, classes=10)
    assert meta == jmeta
    x = RNG.normal(size=(5, 2, 2, 3)).astype(np.float32)
    want, got, single = jpredict({"image": x}), predict({"image": x})(), \
        one({"image": x})()
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], single[k])
        if k.endswith(".idx"):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k].astype(np.float32),
                                       np.asarray(want[k], np.float32),
                                       atol=1e-5 if not topk else 1e-3)


def test_local_mesh_over_cpu_replicas_in_the_builder():
    predict, _ = tts._build_model_predict(
        "mlp", 10, "", "image", "logits", (4, 4, 1), "float32", 0, "dp=2",
        "", device="cpu")
    out = predict({"image": np.ones((5, 4, 4, 1), np.float32)})()
    assert out["logits"].shape == (5, 10)
    np.testing.assert_array_equal(out["logits"][0], out["logits"][4])


@pytest.mark.parametrize("spec,raises,match", [
    ("dp=2,tp=2", None, None),
    ("dp=1,sp=4", NotImplementedError, r"item 14\(d\)"),
    ("dp=3", None, None), ("dp=2,fsdp=2,tp=1", None, None)])
def test_parse_local_mesh(spec, raises, match):
    if raises is not None:
        with pytest.raises(raises, match=match):
            sharded_teacher.parse_local_mesh(spec, "cpu")
        return
    devs = sharded_teacher.parse_local_mesh(spec, "cpu")
    assert devs == [torch.device("cpu")] * int(np.prod(
        [int(p.split("=")[1]) for p in spec.split(",")]))


def test_parse_local_mesh_on_cuda_counts_the_cards():
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match="cards"):
            sharded_teacher.parse_local_mesh(f"dp={n + 1}")
        assert sharded_teacher.parse_local_mesh(f"dp={n}") == [
            torch.device("cuda", i) for i in range(n)]
    else:   # no quiet move to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            sharded_teacher.parse_local_mesh("dp=1")
