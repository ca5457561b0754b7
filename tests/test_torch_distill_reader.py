"""The port's DistillReader (edl_tpu_torch/distill/reader.py) through the
JAX package's reader cases (tests/test_distill_reader.py): order and
row re-assembly (D1, D2), flaky and dead teachers (D3, D6), the epoch's
end (D4), the deadman, the reference's three slot formats, and real TCP
teachers. The wire interoperates both ways: the port's reader reads the
JAX package's TeacherServer, and the JAX package's reader reads the
port's. Teachers compute a per-row function of their feeds, so a
slicing or re-assembly fault shows by value; the reassembled logits are
held to 1e-6 (the same float32 sums)."""

import threading
import time

import numpy as np
import pytest

from edl_tpu_torch.distill.reader import (DistillReader, EdlDistillError,
                                          _NopTeacherClient)
from edl_tpu_torch.distill.teacher_server import TeacherServer


def make_batches(n_batches=6, rows=32, feat=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(rows, feat)).astype(np.float32),
             "label": rng.integers(0, 10, size=(rows,)).astype(np.int32)}
            for _ in range(n_batches)]


def ref_logits(images: np.ndarray) -> np.ndarray:
    return np.stack([images.sum(axis=1), images.max(axis=1)], axis=1)


class _FnTeacherClient:
    """In-process fake teacher computing ref_logits."""

    def __init__(self, endpoint, delay=0.0, fail_every=0):
        self.endpoint, self.delay, self.fail_every = endpoint, delay, \
            fail_every
        self.calls = 0

    def predict(self, feeds):
        self.calls += 1
        if self.fail_every and self.calls % self.fail_every == 0:
            raise ConnectionError("injected teacher failure")
        if self.delay:
            time.sleep(self.delay)
        return {"teacher_logits": ref_logits(feeds["image"])}

    def close(self):
        pass


def check_epoch(batches, got):
    assert len(got) == len(batches)                       # D4
    for want, out in zip(batches, got):                   # D2 order
        np.testing.assert_array_equal(out["image"], want["image"])
        np.testing.assert_array_equal(out["label"], want["label"])
        np.testing.assert_allclose(out["teacher_logits"],
                                   ref_logits(want["image"]), rtol=1e-6)


def fn_reader(batches, teachers, **kw):
    kw.setdefault("client_factory", lambda ep: _FnTeacherClient(ep))
    return DistillReader(lambda: iter(batches), feeds=["image"],
                         predicts=["teacher_logits"], teachers=teachers,
                         **kw)


def test_nop_pipeline_shapes_and_order():
    batches = make_batches()
    dr = DistillReader(lambda: iter(batches), feeds=["image"],
                       predicts=["p"], teachers=["t0", "t1"],
                       teacher_batch_size=8,
                       client_factory=lambda ep: _NopTeacherClient(ep, ("p",)))
    got = list(dr())
    assert len(got) == len(batches)
    for want, out in zip(batches, got):
        np.testing.assert_array_equal(out["image"], want["image"])
        assert out["p"].shape == (32, 1)
    assert dr.last_epoch == {"batches": 6, "tasks": 24, "served_rows": 192}


@pytest.mark.parametrize("case", ["ragged", "out_of_order", "flaky"])
def test_batches_reassembled_in_order(case):
    """A ragged tail slice (30 rows by 8), teachers of very different
    latency (out-of-order completion), and a teacher failing every 3rd
    call (its task re-queued and re-served, D3): every epoch whole."""
    if case == "ragged":
        batches = make_batches(n_batches=5, rows=30)
        dr = fn_reader(batches, ["t0", "t1", "t2"], teacher_batch_size=8)
    elif case == "out_of_order":
        delays = {"fast": 0.0, "slow": 0.03}
        batches = make_batches(n_batches=8, rows=16)
        dr = fn_reader(batches, ["fast", "slow"], teacher_batch_size=4,
                       client_factory=lambda ep: _FnTeacherClient(
                           ep, delay=delays[ep]))
    else:
        batches = make_batches(n_batches=10, rows=16)
        dr = fn_reader(batches, ["good", "flaky"], teacher_batch_size=4,
                       manage_interval=0.05,
                       client_factory=lambda ep: _FnTeacherClient(
                           ep, fail_every=3 if ep == "flaky" else 0))
    check_epoch(batches, list(dr()))
    assert dr.last_epoch["served_rows"] == sum(len(b["label"])
                                               for b in batches)


def test_multiple_epochs_reuse():
    batches = make_batches(n_batches=3)
    dr = fn_reader(batches, ["t0"], teacher_batch_size=16)
    for _ in range(3):
        check_epoch(batches, list(dr()))


def test_all_teachers_failing_raises():
    batches = make_batches(n_batches=2, rows=8)
    dr = fn_reader(batches, ["bad"], teacher_batch_size=4, max_retries=2,
                   manage_interval=0.05,
                   client_factory=lambda ep: _FnTeacherClient(
                       ep, fail_every=1))
    with pytest.raises(EdlDistillError):
        list(dr())


def test_connect_dead_teacher_trips_deadman_fast():
    """A fixed teacher whose connect always fails: the deadman raises,
    naming it (D6), instead of hanging the epoch."""
    def refuse(ep):
        raise ConnectionRefusedError(f"connection to {ep} refused")

    dr = fn_reader(make_batches(n_batches=2, rows=8), ["203.0.113.9:9999"],
                   teacher_batch_size=4, manage_interval=0.05,
                   deadman_timeout=1.0, client_factory=refuse)
    t0 = time.monotonic()
    with pytest.raises(EdlDistillError) as ei:
        list(dr())
    assert time.monotonic() - t0 < 10.0
    assert "deadman" in str(ei.value)
    assert "203.0.113.9:9999" in str(ei.value)


def test_slow_but_live_teacher_does_not_trip_deadman():
    batches = make_batches(n_batches=2, rows=8)
    dr = fn_reader(batches, ["slow"], teacher_batch_size=8,
                   manage_interval=0.05, deadman_timeout=0.2,
                   client_factory=lambda ep: _FnTeacherClient(ep, delay=0.3))
    check_epoch(batches, list(dr()))


def test_empty_discovery_pool_waits_instead_of_tripping():
    batches = make_batches(n_batches=2, rows=8)
    dr = DistillReader(lambda: iter(batches), feeds=["image"],
                       predicts=["teacher_logits"], discovery="unused:0",
                       service="svc", teacher_batch_size=4,
                       manage_interval=0.05, deadman_timeout=0.3,
                       client_factory=lambda ep: _FnTeacherClient(ep))
    start = time.monotonic()
    dr._get_servers = lambda: ([] if time.monotonic() - start < 1.0
                               else ["t0"])
    check_epoch(batches, list(dr()))


def test_deadman_recovers_when_teacher_arrives_late():
    batches = make_batches(n_batches=3, rows=8)
    start = time.monotonic()

    def late_factory(ep):
        if time.monotonic() - start < 0.5:
            raise ConnectionRefusedError("not up yet")
        return _FnTeacherClient(ep)

    dr = fn_reader(batches, ["late"], teacher_batch_size=4,
                   manage_interval=0.05, deadman_timeout=2.0,
                   client_factory=late_factory)
    check_epoch(batches, list(dr()))


@pytest.mark.parametrize("kw,match", [
    ({"feeds": None, "teachers": ["t"]}, "feeds"),
    ({"sparse_predicts": True}, "compress_topk")])
def test_misconfigurations_rejected(kw, match):
    with pytest.raises(EdlDistillError, match=match):
        dr = DistillReader(lambda: iter([]), predicts=["p"], **kw)
        next(iter(dr()))


class TestSlotFormats:
    """The reference's three positional reader formats: each round-trips
    the original structure value for value with the predict slot
    appended."""

    N_BATCHES, BATCH, FEAT = 4, 10, 6

    def _samples(self):
        rng = np.random.default_rng(7)
        return [(rng.normal(size=(self.FEAT,)).astype(np.float32),
                 np.int64(i % 3)) for i in range(self.N_BATCHES * self.BATCH)]

    def _reader(self, **kw):
        kw.setdefault("teachers", ["t0", "t1"])
        kw.setdefault("teacher_batch_size", 4)
        kw.setdefault("client_factory", lambda ep: _FnTeacherClient(ep))
        return DistillReader(ins=["image", None],
                             predicts=["teacher_logits"], **kw)

    def test_sample_generator_roundtrip(self):
        samples = self._samples()
        got = list(self._reader().set_sample_generator(
            lambda: iter(samples))())
        assert len(got) == len(samples)
        for (img, label), out in zip(samples, got):
            assert len(out) == 3
            np.testing.assert_array_equal(out[0], img)
            np.testing.assert_array_equal(out[1], label)
            np.testing.assert_allclose(out[2], ref_logits(img[None])[0],
                                       rtol=1e-6)

    def test_sample_list_generator_roundtrip(self):
        samples = self._samples()
        lists = [samples[i * self.BATCH:(i + 1) * self.BATCH]
                 for i in range(self.N_BATCHES)]
        got = list(self._reader().set_sample_list_generator(
            lambda: iter(lists))())
        assert len(got) == self.N_BATCHES
        for want, out in zip(lists, got):
            assert len(out) == self.BATCH
            for (img, label), sample in zip(want, out):
                np.testing.assert_array_equal(sample[0], img)
                np.testing.assert_array_equal(sample[1], label)
                np.testing.assert_allclose(
                    sample[2], ref_logits(img[None])[0], rtol=1e-6)

    def test_batch_generator_roundtrip(self):
        rng = np.random.default_rng(8)
        batches = [(rng.normal(size=(self.BATCH, self.FEAT))
                    .astype(np.float32),
                    rng.integers(0, 3, size=(self.BATCH, 1)))
                   for _ in range(self.N_BATCHES)]
        got = list(self._reader().set_batch_generator(
            lambda: iter(batches))())
        assert len(got) == self.N_BATCHES
        for (img, label), out in zip(batches, got):
            np.testing.assert_array_equal(out[0], img)
            np.testing.assert_array_equal(out[1], label)
            np.testing.assert_allclose(out[2], ref_logits(img), rtol=1e-6)

    def test_reference_construction_order(self):
        samples = self._samples()[:8]
        dr = DistillReader(ins=["image", None], predicts=["teacher_logits"],
                           teacher_batch_size=4,
                           client_factory=lambda ep: _FnTeacherClient(ep))
        dr.set_fixed_teacher("t0,t1")
        dr.set_sample_generator(lambda: iter(samples))
        for _ in range(2):
            assert len(list(dr())) == len(samples)

    @pytest.mark.parametrize("what", ["needs_ins", "twice", "no_reader",
                                      "sparse"])
    def test_refusals(self, what):
        if what == "needs_ins":
            with pytest.raises(EdlDistillError, match="ins"):
                DistillReader(predicts=["p"], teachers=["t0"]
                              ).set_sample_generator(lambda: iter([]))
        elif what == "twice":
            dr = self._reader()
            dr.set_sample_generator(lambda: iter([]))
            with pytest.raises(EdlDistillError, match="already"):
                dr.set_batch_generator(lambda: iter([]))
        elif what == "no_reader":
            dr = DistillReader(ins=["x"], predicts=["p"], teachers=["t"])
            with pytest.raises(EdlDistillError, match="reader"):
                next(iter(dr()))
        else:
            dr = self._reader(compress_topk=2, sparse_predicts=True)
            with pytest.raises(EdlDistillError, match="dict-format"):
                dr.set_sample_generator(lambda: iter([]))


def _port_teacher(delay=0.0):
    def predict(feeds):
        if delay:
            time.sleep(delay)
        out = {"teacher_logits": ref_logits(feeds["image"])}
        return lambda: out
    return predict


def test_reader_against_the_port_s_server():
    with TeacherServer(_port_teacher(), host="127.0.0.1",
                       max_wait=0.001) as srv:
        batches = make_batches(n_batches=4, rows=24)
        dr = DistillReader(lambda: iter(batches), feeds=["image"],
                           predicts=["teacher_logits"],
                           teachers=[f"127.0.0.1:{srv.port}"],
                           teacher_batch_size=8)
        check_epoch(batches, list(dr()))


def test_reader_against_the_jax_package_s_server():
    """The JAX package's TeacherServer feeds the port's reader (its
    pipelined, sequence-tagged requests), dense and over the negotiated
    top-k wire kept sparse."""
    from edl_tpu.distill.teacher_server import TeacherServer as JServer

    def predict(feeds):
        return {"teacher_logits": ref_logits(feeds["image"])}

    with JServer(predict, host="127.0.0.1", max_wait=0.001) as srv:
        ep = f"127.0.0.1:{srv.port}"
        batches = make_batches(n_batches=4, rows=24)
        check_epoch(batches, list(DistillReader(
            lambda: iter(batches), feeds=["image"],
            predicts=["teacher_logits"], teachers=[ep],
            teacher_batch_size=8)()))
        sparse = list(DistillReader(
            lambda: iter(batches), feeds=["image"],
            predicts=["teacher_logits"], teachers=[ep],
            teacher_batch_size=8, compress_topk=1, sparse_predicts=True)())
    for want, out in zip(batches, sparse):
        ref = ref_logits(want["image"])
        np.testing.assert_array_equal(out["teacher_logits.idx"][:, 0],
                                      ref.argmax(1))
        np.testing.assert_allclose(out["teacher_logits.val"][:, 0],
                                   ref.max(1), rtol=1e-3)


def test_jax_package_s_reader_against_the_port_s_server():
    from edl_tpu.distill.reader import DistillReader as JReader

    with TeacherServer(_port_teacher(), host="127.0.0.1",
                       max_wait=0.001) as srv:
        batches = make_batches(n_batches=4, rows=24)
        got = list(JReader(lambda: iter(batches), feeds=["image"],
                           predicts=["teacher_logits"],
                           teachers=[f"127.0.0.1:{srv.port}"],
                           teacher_batch_size=8)())
    check_epoch(batches, got)


def test_teacher_killed_mid_epoch_survivor_finishes():
    s1 = TeacherServer(_port_teacher(0.01), host="127.0.0.1").start()
    s2 = TeacherServer(_port_teacher(0.01), host="127.0.0.1").start()
    eps = [f"127.0.0.1:{s1.port}", f"127.0.0.1:{s2.port}"]
    batches = make_batches(n_batches=12, rows=16)
    dr = DistillReader(lambda: iter(batches), feeds=["image"],
                       predicts=["teacher_logits"], teachers=eps,
                       teacher_batch_size=4, manage_interval=0.05)
    got = []
    it = dr()
    try:
        got.append(next(it))
        s2.stop()          # one teacher dies mid-epoch
        got.extend(it)
        check_epoch(batches, got)
    finally:
        s1.stop()


def test_reader_threads_end_with_the_epoch():
    batches = make_batches(n_batches=3, rows=8)
    before = threading.active_count()
    list(fn_reader(batches, ["t0"], teacher_batch_size=4)())
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
