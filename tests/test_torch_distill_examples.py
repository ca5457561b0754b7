"""The port's distill entry points on the CPU: a student learning from a
served teacher (the JAX package's tests/test_distill_train.py case),
``imagenet_train --teachers`` on ResNetTiny at 32 px (dense, the sparse
``--distill-topk`` step over a top-k-serving teacher, a world of two
ranks under the SPMD world step, and the JAX CLI's three refusals),
``mnist_distill`` in its three modes (--all-in-one, --teachers,
--discovery), ``nlp_distill --all-in-one`` and ``reader_demo``, each at
a small size.
"""

import json

import numpy as np
import pytest
import torch

from edl_tpu_torch.data.pipeline import ArraySource, DataLoader
from edl_tpu_torch.distill.reader import DistillReader
from edl_tpu_torch.distill.sharded_teacher import sharded_predict_fn
from edl_tpu_torch.distill.teacher_server import (TeacherServer,
                                                  _build_model_predict)
from edl_tpu_torch.examples import (imagenet_train, mnist_distill,
                                    nlp_distill, reader_demo)
from edl_tpu_torch.models.mlp import MLP
from edl_tpu_torch.train.classification import (create_state,
                                                make_distill_step)
from edl_tpu_torch.train.state import adam
from test_torch_world import one_torch_thread  # noqa: F401
from test_torch_world import free_port, run_world

TINY_ARGV = ["--model", "ResNetTiny", "--image-size", "32",
             "--num-classes", "10", "--batch-size", "16", "--epochs", "2",
             "--rows-per-file", "32", "--warmup-epochs", "1", "--lr", "0.05",
             "--device", "cpu", "--no-augment", "--fused-opt", "fp32"]


def test_student_learns_from_served_teacher():
    """A fixed-weight MLP teacher behind a TeacherServer; data labeled by
    the teacher, so the KD objective is learnable: the student's
    agreement with the teacher climbs past max(0.5, first + 0.2), the
    JAX test's bar."""
    teacher = MLP(10, (32,), in_features=16, device="cpu", seed=42)
    predict, _ = sharded_predict_fn(lambda m, x: m(x), teacher, "cpu",
                                    output_key="teacher_logits")
    rng = np.random.default_rng(0)
    images = rng.normal(size=(512, 16)).astype(np.float32)
    with torch.no_grad():
        labels = teacher(torch.from_numpy(images)).argmax(1).numpy()
    loader = DataLoader(ArraySource({"image": images,
                                     "label": labels.astype(np.int32)}),
                        64, seed=0, num_workers=0)
    state = create_state(MLP(10, (32,), in_features=16, device="cpu"),
                         adam(1e-2))
    step = make_distill_step(10, temperature=2.0, hard_weight=0.0)
    accs = []
    with TeacherServer(predict, host="127.0.0.1") as srv:
        for epoch in range(16):
            dr = DistillReader(lambda e=epoch: loader.epoch(e),
                               feeds=["image"], predicts=["teacher_logits"],
                               teachers=[f"127.0.0.1:{srv.port}"],
                               teacher_batch_size=16)
            for batch in dr():
                state, m = step(state, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
                accs.append(float(m["acc1"]))
    first, last = np.mean(accs[:8]), np.mean(accs[-8:])
    assert last > max(0.5, first + 0.2), (first, last)


@pytest.fixture(scope="module")
def teachers():
    """Two ResNetTiny teachers through the zoo-teacher CLI's builder: one
    dense (a top-k client negotiates the compressed wire with it), one
    serving its device top-5."""
    servers = []
    for topk in (0, 5):
        predict, meta = _build_model_predict(
            "ResNetTiny", 10, "", "image", "logits", (32, 32, 3), "float16",
            topk, "", "", device="cpu")
        servers.append(TeacherServer(predict, host="127.0.0.1",
                                     compressed_meta=meta).start())
    yield [f"127.0.0.1:{s.port}" for s in servers]
    for s in servers:
        s.stop()


@pytest.mark.parametrize("how", ["dense", "topk_negotiated",
                                 "topk_served"])
def test_imagenet_train_teachers_on_the_cpu(tmp_path, capsys, teachers,
                                            monkeypatch, how):
    from edl_tpu_torch.distill import reader as reader_mod

    epochs = []
    call = reader_mod.DistillReader.__call__

    def counted(self):
        yield from call(self)
        epochs.append(self.last_epoch)

    monkeypatch.setattr(reader_mod.DistillReader, "__call__", counted)
    flags = {"dense": ["--teachers", teachers[0]],
             "topk_negotiated": ["--teachers", teachers[0],
                                 "--distill-topk", "5"],
             "topk_served": ["--teachers", ",".join(teachers),
                             "--distill-topk", "5"]}[how]
    rc = imagenet_train.main(["--data-dir", str(tmp_path),
                              "--make-synthetic", "2", *TINY_ARGV, *flags])
    assert rc == 0
    final = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("final_acc1=")]
    assert len(final) == 1 and 0.0 <= float(final[0].split("=")[1]) <= 1.0
    # one reader reused over both epochs, every row of each served
    assert epochs == [{"batches": 4, "tasks": 4, "served_rows": 64}] * 2


@pytest.mark.parametrize("flags,match", [
    (["--mixup-alpha", "0.2"], "--mixup-alpha is not supported with "
                               "--teachers"),
    (["--augment-device", "1"], "--augment-device is not supported with "
                                "--teachers"),
    (["--dcn-compress", "int8"], "--dcn-compress/--comm-bucket-mb are not "
                                 "supported"),
    (["--comm-bucket-mb", "4"], "--dcn-compress/--comm-bucket-mb are not "
                                "supported")])
def test_imagenet_train_teachers_refusals(tmp_path, flags, match):
    """The JAX CLI's refusals with --teachers, in its words, before any
    data is written."""
    data_dir = tmp_path / "never-written"
    with pytest.raises(SystemExit, match=match):
        imagenet_train.main(["--data-dir", str(data_dir), "--make-synthetic",
                             "2", *[a for a in TINY_ARGV
                                    if a != "--no-augment"],
                             "--teachers", "127.0.0.1:9", *flags])
    assert not data_dir.exists()


def test_imagenet_train_teachers_in_a_world_of_two(tmp_path, teachers):
    """Two gloo ranks, each reading its own loader shard through its own
    reader, under the SPMD world step: both finish, their states equal."""
    imagenet_train.make_synthetic_shards(str(tmp_path / "data"), 2, 32, 32,
                                         10, seed=0)
    argv = ["--data-dir", str(tmp_path / "data"), *TINY_ARGV, "--epochs",
            "1", "--teachers", teachers[0]]
    runs = [{"name": "kd", "argv": argv,
             "coordinator": f"127.0.0.1:{free_port()}"}]
    r0, r1 = run_world("imagenet", 2, tmp_path / "world",
                       {"runs": np.array(json.dumps(runs))}, tcp=True)
    for r in (r0, r1):
        assert int(r["kd/rc"]) == 0 and bool(r["kd/world_step"])
        assert len(r["kd/losses"]) == 4
        assert np.isfinite(r["kd/losses"]).all()
    np.testing.assert_array_equal(r0["kd/losses"], r1["kd/losses"])
    for k in (k for k in r0 if k.startswith("kd/sd/")):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def _final(out: str, key: str) -> float:
    line = [ln for ln in out.splitlines() if key in ln][-1]
    return dict(kv.split("=") for kv in line.split())[key]


SMALL_MNIST = ["--device", "cpu", "--samples", "512", "--epochs", "1",
               "--batch-size", "64"]


@pytest.mark.parametrize("mode", ["all_in_one", "teachers", "discovery"])
def test_mnist_distill_modes(capsys, mode):
    server = disco = reg = None
    try:
        if mode == "all_in_one":
            flags = ["--all-in-one"]
        else:
            server = TeacherServer(mnist_distill.make_teacher_predict("cpu"),
                                   host="127.0.0.1").start()
            ep = f"127.0.0.1:{server.port}"
            flags = ["--teachers", ep]
        if mode == "discovery":
            from edl_tpu_torch.coord.store import InMemStore
            from edl_tpu_torch.distill.discovery_server import \
                DiscoveryServer
            from edl_tpu_torch.distill.registrar import TeacherRegistrar

            store = InMemStore()
            reg = TeacherRegistrar(store, "mnist_teacher", ep,
                                   ttl=5.0).start()
            disco = DiscoveryServer(store, port=0, host="127.0.0.1",
                                    tick_interval=0.1).start()
            flags = ["--discovery", disco.endpoint]
        assert mnist_distill.main([*flags, *SMALL_MNIST]) == 0
    finally:
        for s in (disco, reg, server):
            if s is not None:
                s.stop()
    assert np.isfinite(float(_final(capsys.readouterr().out, "final_loss")))


def test_nlp_distill_all_in_one(capsys):
    rc = nlp_distill.main(["--all-in-one", "--device", "cpu", "--samples",
                           "512", "--epochs", "2", "--teacher-epochs", "2",
                           "--distill-extra", "512", "--batch-size", "128",
                           "--lr", "3e-3"])
    assert rc == 0
    out = capsys.readouterr().out
    for key in ("teacher_acc", "alone_acc", "distill_acc"):
        assert 0.0 <= float(_final(out, key)) <= 1.0


def test_example_data_is_the_jax_package_s():
    from edl_tpu.examples import mnist_distill as jmnist
    from edl_tpu.examples import nlp_distill as jnlp

    for ours, theirs in ((mnist_distill.synthetic_mnist(64, 3),
                          jmnist.synthetic_mnist(64, 3)),
                         (nlp_distill.synthetic_sentiment(64, 3),
                          jnlp.synthetic_sentiment(64, 3))):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_reader_demo_all_formats(capsys):
    assert reader_demo.main(["--format", "all"]) == 0
    assert capsys.readouterr().out.strip().endswith(
        "ok formats=sample_generator,sample_list_generator,batch_generator")


def test_example_mode_is_required():
    for mod in (mnist_distill, nlp_distill):
        with pytest.raises(SystemExit):
            mod.main(["--device", "cpu"])
