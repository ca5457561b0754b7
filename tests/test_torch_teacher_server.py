"""Teacher serving in the port (edl_tpu_torch/distill/): the predict
function against the JAX single-device forward, the real TCP server, and
wire interop with the JAX package's client and server (the port's
tensor wire is a byte-identical copy).

Mirrors tests/test_sharded_teacher.py on one CPU device: a small fp32
transformer teacher whose params come from JAX's init through the bridge.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from edl_tpu.data import tensor_wire as jwire
from edl_tpu.distill import teacher_server as jts
from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu_torch.bridge import flax_to_torch
from edl_tpu_torch.data import tensor_wire as twire
from edl_tpu_torch.distill import teacher_server as tts
from edl_tpu_torch.distill.sharded_teacher import sharded_predict_fn
from edl_tpu_torch.models.transformer import Transformer, TransformerConfig

VOCAB, SEQ = 64, 128
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_len=SEQ)


def _toks(rows, seed=0):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (rows, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def teacher():
    jmodel = JTransformer(JConfig(**CFG, dtype=jnp.float32))
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(0), _toks(2), train=False)
    params = jax.tree.map(np.asarray, nn.unbox(variables["params"]))
    tmodel = Transformer(TransformerConfig(**CFG, dtype=torch.float32),
                         device="cpu")
    tmodel.load_state_dict(flax_to_torch(params))
    fwd = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False))

    def ref(toks):
        return np.asarray(fwd(params, toks))

    return tmodel, ref


def _apply(model, x):
    return model(x)


def _predict(model, **kw):
    return sharded_predict_fn(_apply, model, "cpu", input_key="tokens",
                              output_key="logits", **kw)


def _ref_topk(ref, k):
    idx = np.argsort(-ref, axis=-1)[..., :k]
    return idx, np.take_along_axis(ref, idx, axis=-1)


def test_dense_predictions_match_jax(teacher):
    model, ref = teacher
    predict, meta = _predict(model)
    assert meta is None
    toks = _toks(4)
    out = predict({"tokens": toks})()["logits"]
    assert out.shape == (4, SEQ, VOCAB) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref(toks), atol=2e-5)


def test_serve_topk_matches_jax(teacher):
    model, ref = teacher
    predict, meta = _predict(model, serve_topk=4, classes=VOCAB)
    assert meta == {"logits": {"topk": 4, "classes": VOCAB,
                               "values": "<f2"}}
    toks = _toks(2, seed=5)
    out = predict({"tokens": toks})()
    idx, val = out["logits.idx"], out["logits.val"]
    assert idx.shape == (2, SEQ, 4) and idx.dtype == np.int32
    assert val.dtype == np.float16
    ref_idx, ref_val = _ref_topk(ref(toks), 4)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(val.astype(np.float32), ref_val, atol=2e-3)


def test_topk_requires_classes(teacher):
    with pytest.raises(ValueError, match="classes"):
        _predict(teacher[0], serve_topk=4)


def test_topk_clamped_to_classes(teacher):
    predict, meta = _predict(teacher[0], serve_topk=VOCAB + 100,
                             classes=VOCAB)
    assert meta["logits"]["topk"] == VOCAB
    out = predict({"tokens": _toks(2)})()
    assert out["logits.idx"].shape == (2, SEQ, VOCAB)


def test_cuda_requested_without_a_card_raises(teacher, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded_predict_fn(_apply, teacher[0], "cuda")


def test_through_real_tcp_server(teacher):
    """Sparse and dense port clients against the port server."""
    model, ref = teacher
    predict, meta = _predict(model, serve_topk=4, classes=VOCAB)
    toks = _toks(2, seed=7)
    ref_idx, ref_val = _ref_topk(ref(toks), 4)
    with tts.TeacherServer(predict, host="127.0.0.1",
                           compressed_meta=meta) as srv:
        c = tts.TeacherClient(f"127.0.0.1:{srv.port}", expand=False)
        out = c.predict({"tokens": toks})
        np.testing.assert_array_equal(out["logits.idx"], ref_idx)
        c.close()
        dense_c = tts.TeacherClient(f"127.0.0.1:{srv.port}")
        dense = dense_c.predict({"tokens": toks})["logits"]
        assert dense.shape == (2, SEQ, VOCAB)
        np.testing.assert_allclose(np.take_along_axis(dense, ref_idx, -1),
                                   ref_val, atol=2e-3)
        assert dense_c.stats()["served_requests"] == 2
        dense_c.close()


def test_predict_must_return_a_fetch(teacher):
    """predict_fn launches and returns a fetch callable; one that returns
    the arrays themselves fails its request by name, and the server goes
    on answering."""
    predict, _ = _predict(teacher[0])

    def eager(feeds):
        return predict(feeds)()

    with tts.TeacherServer(eager, host="127.0.0.1") as srv:
        c = tts.TeacherClient(f"127.0.0.1:{srv.port}")
        with pytest.raises(twire.TensorWireError, match="fetch callable"):
            c.predict({"tokens": _toks(1)})
        assert c.ping()
        c.close()


def test_drain_rejects_with_retry_after(teacher):
    predict, meta = _predict(teacher[0], serve_topk=4, classes=VOCAB)
    with tts.TeacherServer(predict, host="127.0.0.1",
                           compressed_meta=meta) as srv:
        c = tts.TeacherClient(f"127.0.0.1:{srv.port}", expand=False)
        assert c.drain()
        with pytest.raises(tts.TeacherRejected) as rej:
            c.predict({"tokens": _toks(1)})
        assert rej.value.reason == "draining"
        assert rej.value.retry_after_ms > 0
        c.close()


def test_jax_client_against_port_server(teacher):
    """The JAX package's clients read the port server's sparse answers,
    and expand them, exactly as they read a JAX server's."""
    model, ref = teacher
    predict, meta = _predict(model, serve_topk=4, classes=VOCAB)
    toks = _toks(3, seed=11)
    ref_idx, ref_val = _ref_topk(ref(toks), 4)
    with tts.TeacherServer(predict, host="127.0.0.1",
                           compressed_meta=meta) as srv:
        sparse = jts.TeacherClient(f"127.0.0.1:{srv.port}", expand=False)
        out = sparse.predict({"tokens": toks})
        np.testing.assert_array_equal(out["logits.idx"], ref_idx)
        np.testing.assert_allclose(out["logits.val"].astype(np.float32),
                                   ref_val, atol=2e-3)
        assert sparse.ping()
        sparse.close()
        dense = jts.TeacherClient(f"127.0.0.1:{srv.port}")
        logits = dense.predict({"tokens": toks})["logits"]
        assert logits.shape == (3, SEQ, VOCAB)
        np.testing.assert_allclose(np.take_along_axis(logits, ref_idx, -1),
                                   ref_val, atol=2e-3)
        dense.close()


def test_port_client_against_jax_server(teacher):
    """The port's clients against a JAX TeacherServer: dense logits
    arrive bit-for-bit, and a negotiated top-k compression of a 2-D
    output comes back sparse or expanded."""
    _, ref = teacher

    def jpredict(feeds):
        logits = ref(feeds["tokens"])
        return {"logits": logits, "last": logits[:, -1]}

    toks = _toks(2, seed=13)
    want = ref(toks)
    last_idx, last_val = _ref_topk(want[:, -1], 4)
    with jts.TeacherServer(jpredict, host="127.0.0.1") as srv:
        dense = tts.TeacherClient(f"127.0.0.1:{srv.port}")
        np.testing.assert_array_equal(
            dense.predict({"tokens": toks})["logits"], want)
        dense.close()
        sparse = tts.TeacherClient(f"127.0.0.1:{srv.port}",
                                   compress_topk=4, expand=False)
        out = sparse.predict({"tokens": toks})
        np.testing.assert_array_equal(out["last.idx"], last_idx)
        np.testing.assert_allclose(out["last.val"].astype(np.float32),
                                   last_val, atol=2e-3)
        sparse.close()
        expanding = tts.TeacherClient(f"127.0.0.1:{srv.port}",
                                      compress_topk=4)
        last = expanding.predict({"tokens": toks})["last"]
        assert last.shape == (2, VOCAB)
        assert np.sum(last > tts.EXPAND_FILL) == 2 * 4
        expanding.close()


def _frame_bytes(wire, meta, tensors):
    a, b = socket.socketpair()
    try:
        wire.send_tensors(a, meta, tensors)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            chunks.append(chunk)
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


def test_wire_frames_are_byte_identical():
    rng = np.random.default_rng(0)
    meta = {"op": "predict", "seq": 3, "compress": {"topk": 2}}
    tensors = {"tokens": rng.integers(0, 9, (2, 5)).astype(np.int32),
               "val": rng.standard_normal((2, 5, 2)).astype(np.float16),
               "scalar": np.float32(1.5)}
    port = _frame_bytes(twire, meta, tensors)
    ref = _frame_bytes(jwire, meta, tensors)
    assert port == ref
    a, b = socket.socketpair()
    try:
        a.sendall(ref)
        got_meta, got = twire.recv_tensors(b)
    finally:
        a.close()
        b.close()
    assert got_meta == meta
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k], v)


def test_server_stats_register_with_the_metrics_registry(teacher):
    from edl_tpu_torch.obs import metrics
    predict, meta = _predict(teacher[0], serve_topk=4, classes=VOCAB)
    srv = tts.TeacherServer(predict, host="127.0.0.1", compressed_meta=meta)
    with srv:
        c = tts.TeacherClient(f"127.0.0.1:{srv.port}", expand=False)
        c.predict({"tokens": _toks(3)})
        c.close()
        sources = metrics._REGISTRY.snapshot()["sources"]
        served = [v["served_rows"] for k, v in sources.items()
                  if k.startswith("teacher/")]
        assert 3 in served
        assert metrics.Histogram.quantile(
            srv.batcher.stats()["latency_hist_ms"], 0.5) is not None
    assert not any(v.get("served_rows") == 3 for v in
                   metrics._REGISTRY.snapshot()["sources"].values())


def test_jax_client_trace_continues_in_port_server(teacher, monkeypatch,
                                                   tmp_path):
    """A JAX client inside a span sends its context in-band; the port
    server's admission span joins that trace as its child."""
    from edl_tpu.obs import trace as jtrace
    from edl_tpu_torch.obs import trace as ttrace
    monkeypatch.setenv("EDL_TPU_TRACE", str(tmp_path))
    jtrace.reconfigure()
    ttrace.reconfigure()
    try:
        predict, meta = _predict(teacher[0], serve_topk=4, classes=VOCAB)
        with tts.TeacherServer(predict, host="127.0.0.1",
                               compressed_meta=meta) as srv:
            c = jts.TeacherClient(f"127.0.0.1:{srv.port}", expand=False,
                                  tenant="student-a")
            with jtrace.span("student.step") as parent:
                c.predict({"tokens": _toks(2)})
            c.close()
        admits = ttrace.finished("serve.admit")
        assert len(admits) == 1
        assert admits[0]["tid"] == parent.trace_id
        assert admits[0]["parent"] == parent.span_id
        assert admits[0]["attrs"]["tenant"] == "student-a"
        assert admits[0]["attrs"]["admitted"] is True
    finally:
        monkeypatch.delenv("EDL_TPU_TRACE")
        jtrace.reconfigure()
        ttrace.reconfigure()
