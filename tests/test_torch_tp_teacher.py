"""The one-process tp teacher (``distill/sharded_teacher.py``) against
the JAX package's ``{dp: 2, tp: 4}`` teacher of
``tests/test_sharded_teacher.py``.

The same 2-layer, d=32, 4-head, vocab-64, S=16 fp32 transformer (the JAX
init, carried over with the bridge) is served by the JAX package over a
``{dp: 2, tp: 4}`` mesh of 8 CPU devices and by the port over 8 CPU
shards laid out the same way: 2 data groups of 4 tp shards, each shard
one head, a quarter of the MLP, of the vocab and of the token table's
columns, in its own thread, the shards of a group meeting at a
``LocalComm``. Dense logits agree within the JAX test's 2e-5; the top-k
indices are equal (each shard's top-k of its vocab slice merged with
global indices), with a tie planted across two shards' slices to pin
the merge order (the lower index first, as ``lax.top_k``); ragged rows
pad to the data groups and are trimmed; the teacher serves through a
real TCP ``TeacherServer``. The merge itself is held against
``lax.top_k`` on rows full of ties.
"""

import numpy as np
import pytest
import torch

from test_torch_world import one_torch_thread  # noqa: F401

VOCAB, SEQ = 64, 16
MESH = {"dp": 2, "tp": 4}
# two ids given one lm_head column: 5 and 37 lie in tp shards 0 and 2
TIE = (5, 37)


def _toks(rows, seed=0):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (rows, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def teachers():
    """The JAX teacher over its {dp: 2, tp: 4} mesh (init_sharded, with
    the tie planted) and the port's over 8 CPU shards, each a
    (predict with serve_topk=0, predict with serve_topk=4) pair, and the
    host weights."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from edl_tpu.distill.sharded_teacher import \
        sharded_predict_fn as j_predict_fn
    from edl_tpu.models.transformer import Transformer as JTransformer
    from edl_tpu.models.transformer import TransformerConfig as JConfig
    from edl_tpu.parallel import mesh as jmesh
    from edl_tpu.parallel import sharding as jshd
    from edl_tpu_torch import bridge
    from edl_tpu_torch.distill.sharded_teacher import sharded_predict_fn
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)

    mesh = jmesh.make_mesh(jmesh.MeshSpec(MESH))
    cfg = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2,
               d_ff=64, max_len=SEQ)
    jmodel = JTransformer(JConfig(**cfg, dtype=jnp.float32))
    init = jshd.init_sharded(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(_toks(2)), train=False), mesh)
    host = jax.tree.map(np.array, nn.unbox(jax.device_get(init)))
    # the tied ids read only hidden unit 0, which ln_final lifts by 10:
    # their logits are equal in both packages and rank first
    head = host["params"]["lm_head"]["kernel"]
    head[:, TIE[0]] = head[:, TIE[1]] = np.eye(32, dtype=np.float32)[0]
    host["params"]["ln_final"]["bias"][0] = 10.0
    variables = jax.device_put(host, nn.unbox(jshd.param_shardings(
        mesh, init)))

    def japply(v, x):
        return jmodel.apply(v, x, train=False)

    model = Transformer(TransformerConfig(**cfg, dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(bridge.flax_to_torch(host["params"]))

    def apply(m, x):
        return m(x)

    kw = dict(input_key="tokens", output_key="logits")
    jax_side = [j_predict_fn(japply, variables, mesh, batch_axes=("dp",),
                             **kw, **topk)[0]
                for topk in ({}, dict(serve_topk=4, classes=VOCAB))]
    port = [sharded_predict_fn(apply, model, "cpu", devices=["cpu"] * 8,
                               mesh=MESH, **kw, **topk)
            for topk in ({}, dict(serve_topk=4, classes=VOCAB))]
    return {"jax": jax_side, "port": port, "host": host,
            "dense": lambda toks: np.asarray(jmodel.apply(
                host, toks, train=False))}


@pytest.mark.parametrize("rows,seed", [(4, 0), (5, 3), (1, 9)])
def test_dense_logits_match_the_jax_tp_teacher(teachers, rows, seed):
    """4 rows, and 5 and 1 (ragged: they pad to the 2 data groups and
    the pad rows are trimmed)."""
    toks = _toks(rows, seed)
    want = teachers["jax"][0]({"tokens": toks})["logits"]
    got = teachers["port"][0][0]({"tokens": toks})()["logits"]
    assert got.shape == (rows, SEQ, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, teachers["dense"](toks), atol=2e-5)


def test_topk_over_the_vocab_parallel_head_is_the_jax_teacher_s(teachers):
    """The served top-4 of 5 rows: indices equal to the JAX teacher's,
    values within its fp16 packing. The planted tie ranks first at every
    position, lower index first."""
    predict, meta = teachers["port"][1]
    assert meta == {"logits": {"topk": 4, "classes": VOCAB,
                               "values": "<f2"}}
    toks = _toks(5, seed=5)
    want = teachers["jax"][1]({"tokens": toks})
    got = predict({"tokens": toks})()
    assert got["logits.idx"].shape == (5, SEQ, 4)
    assert got["logits.idx"].dtype == np.int32
    assert got["logits.val"].dtype == np.float16
    dense = teachers["port"][0][0]({"tokens": toks})()["logits"]
    tied = dense[..., TIE[0]] == dense[..., TIE[1]]
    assert tied.all()
    np.testing.assert_array_equal(got["logits.idx"], want["logits.idx"])
    np.testing.assert_array_equal(
        got["logits.idx"][..., :2],
        np.broadcast_to(np.array(TIE, np.int32), (5, SEQ, 2)))
    np.testing.assert_allclose(got["logits.val"].astype(np.float32),
                               want["logits.val"].astype(np.float32),
                               atol=2e-3)


def test_merge_breaks_ties_as_lax_top_k():
    """topk_lower_first over 4 slices of rows full of ties, merged: the
    values and indices of lax.top_k over the whole rows."""
    import jax

    from edl_tpu_torch.distill.sharded_teacher import (merge_topk,
                                                       topk_lower_first)

    x = np.random.default_rng(1).integers(0, 4, (6, 32)).astype(np.float32)
    want_val, want_idx = jax.lax.top_k(x, 5)
    t = torch.from_numpy(x)
    parts = [topk_lower_first(t[:, i * 8:(i + 1) * 8], 5) for i in range(4)]
    val, idx = merge_topk([v for v, _ in parts],
                          [i + 8 * n for n, (_, i) in enumerate(parts)], 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(want_val))
    v1, i1 = topk_lower_first(t, 5)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(want_idx))


def test_tp_teacher_through_a_real_tcp_server(teachers):
    """The port's tp teacher behind TeacherServer: a JAX sparse client
    reads idx/val, and a dense client's scatter-expanded rows hold the
    JAX teacher's logits at the served indices."""
    from edl_tpu.distill.teacher_server import TeacherClient
    from edl_tpu_torch.distill.teacher_server import TeacherServer

    predict, meta = teachers["port"][1]
    toks = _toks(2, seed=7)
    ref = teachers["jax"][0]({"tokens": toks})["logits"]
    with TeacherServer(predict, host="127.0.0.1",
                       compressed_meta=meta) as srv:
        c = TeacherClient(f"127.0.0.1:{srv.port}", expand=False)
        out = c.predict({"tokens": toks})
        c.close()
        dense_c = TeacherClient(f"127.0.0.1:{srv.port}")
        dense = dense_c.predict({"tokens": toks})["logits"]
        dense_c.close()
    idx = out["logits.idx"]
    assert idx.shape == (2, SEQ, 4)
    np.testing.assert_array_equal(
        idx, np.argsort(-ref, axis=-1, kind="stable")[..., :4])
    assert dense.shape == (2, SEQ, VOCAB)
    # the served values are fp16: half a unit in the last place
    np.testing.assert_allclose(np.take_along_axis(dense, idx, axis=-1),
                               np.take_along_axis(ref, idx, axis=-1),
                               atol=2e-3, rtol=2 ** -11)


def test_a_tp_teacher_needs_whole_tp_groups_and_a_module():
    from edl_tpu_torch.distill.sharded_teacher import sharded_predict_fn
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)

    model = Transformer(TransformerConfig(vocab_size=VOCAB, d_model=32,
                                          n_heads=4, n_layers=1, d_ff=64,
                                          max_len=SEQ), device="cpu")
    with pytest.raises(ValueError, match="tp groups of 4"):
        sharded_predict_fn(lambda m, x: m(x), model, devices=["cpu"] * 6,
                           mesh="dp=2,tp=4")
    with pytest.raises(ValueError, match="module"):
        sharded_predict_fn(lambda m, x: m(x), {"w": 1}, devices=["cpu"] * 2,
                           mesh={"tp": 2})
    with pytest.raises(NotImplementedError, match=r"item 14\(d\)"):
        sharded_predict_fn(lambda m, x: m(x), model, devices=["cpu"] * 2,
                           mesh={"dp": 1, "sp": 2})


def test_the_cli_s_local_mesh_with_tp_answers_what_dp_answers():
    """The teacher CLI's --local-mesh over dp=2,tp=2 on a zoo model (the
    JAX CLI's flavor: parameters replicated, rows split over dp only)
    serves what dp=2 serves, bit for bit."""
    from edl_tpu_torch.distill import teacher_server as tts

    kw = ("mlp", 10, "", "image", "logits", (4, 4, 1), "float32", 0)
    dp, _ = tts._build_model_predict(*kw, "dp=2", "", device="cpu")
    tp, _ = tts._build_model_predict(*kw, "dp=2,tp=2", "", device="cpu")
    x = np.random.default_rng(0).random((5, 4, 4, 1)).astype(np.float32)
    got = tp({"image": x})()["logits"]
    assert got.shape == (5, 10)
    np.testing.assert_array_equal(got, dp({"image": x})()["logits"])


def test_a_failing_shard_fails_the_predict_and_the_next_one_serves():
    """One shard raising mid-forward: its peer, waiting at the exchange,
    raises too instead of hanging, the predict raises the shard's own
    error, and the exchange serves the next predict."""
    import threading

    from edl_tpu_torch.distill.sharded_teacher import sharded_predict_fn
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
    from edl_tpu_torch.parallel.sharding import tp_spec

    model = Transformer(TransformerConfig(vocab_size=VOCAB, d_model=32,
                                          n_heads=4, n_layers=1, d_ff=64,
                                          max_len=SEQ, dtype=torch.float32),
                        device="cpu")
    armed = {"on": True}
    lock = threading.Lock()

    def apply(m, x):
        with lock:
            fire = armed["on"] and tp_spec(
                m.block0.attn.query.weight).index == 1
            if fire:
                armed["on"] = False
        if fire:
            raise RuntimeError("shard 1 failed")
        return m(x)

    predict, _ = sharded_predict_fn(apply, model, devices=["cpu"] * 2,
                                    mesh={"tp": 2}, input_key="tokens")
    toks = _toks(2)
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        predict({"tokens": toks})
    with torch.no_grad():
        want = model(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(predict({"tokens": toks})()["logits"], want,
                               atol=2e-5)
