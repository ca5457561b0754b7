"""The port's checkpoints against the JAX package's, and the checkpoint
manager's contract.

Bytes: ``serialization.to_bytes`` of the port's TrainState tree
(``bridge.state_to_flax``) equals ``flax.serialization.to_bytes`` of the
JAX TrainState of the same run, byte for byte, for fused momentum-SGD
(fp32, int8, fp8 momentum), fused Adam (fp32, int8), and the unfused
torch.optim SGD and AdamW mapped onto optax's chains. The JAX state takes
2 steps (ResNetTiny at 32 px, or a 2-layer LM) from the port's init; the
port's state is then written from its bytes (``bridge.flax_to_state``)
and serialized back. The msgpack encoder is held to the ``msgpack``
package on every encoding it uses.

Both directions: a checkpoint the JAX package's ``CheckpointManager``
wrote restores in the port bit for bit, and one the port wrote restores
in the JAX package bit for bit (every leaf's dtype, shape and bytes).

The manager, as tests/test_checkpoint.py, test_async_checkpoint.py and
test_fs.py state it for the JAX package: versions and GC, a temp dir
never visible, async = sync bytes, an async snapshot unaffected by steps
taken after it, drop-to-latest, a write error on the next call, the
``file://`` mirror with fetch, the corrupt-chunk fallback.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser

from edl_tpu.models.resnet import ResNetTiny as JTiny
from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu.models.transformer import lm_loss_fn as j_lm_loss_fn
from edl_tpu.train import checkpoint as jckpt
from edl_tpu.train import classification as jcls
from edl_tpu.train import fused_opt as jfo
from edl_tpu.train.state import TrainState as JTrainState
from edl_tpu.train.state import TrainStatus as JTrainStatus
from edl_tpu.train.step import make_train_step as j_make_train_step
from edl_tpu_torch import bridge
from edl_tpu_torch.models.resnet import ResNetTiny
from edl_tpu_torch.models.transformer import Transformer, TransformerConfig
from edl_tpu_torch.train import classification as tcls
from edl_tpu_torch.train import fused_opt as tfo
from edl_tpu_torch.train import serialization as tser
from edl_tpu_torch.train import state as tstate
from edl_tpu_torch.train.checkpoint import (CheckpointManager,
                                            CheckpointWriteError)
from edl_tpu_torch.train.state import TrainStatus
from edl_tpu_torch.utils.exceptions import EdlCheckpointCorrupt
from test_torch_world import one_torch_thread  # noqa: F401

LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_len=16)
# (model, optimizer, --fused-opt mode): every tree the port writes
CASES = [("resnet", "sgdm", "fp32"), ("resnet", "sgdm", "int8"),
         ("resnet", "sgdm", "fp8"), ("resnet", "sgdm", "off"),
         ("lm", "adam", "fp32"), ("lm", "adam", "int8"),
         ("lm", "adam", "off")]
IDS = [f"{m}-{o}-{q}" for m, o, q in CASES]


def _txs(opt: str, mode: str):
    """The JAX package's tx and the port's for one case (constant LR)."""
    if opt == "sgdm":
        if mode == "off":
            return (optax.chain(optax.add_decayed_weights(1e-4),
                                optax.sgd(lambda c: 0.05, momentum=0.9,
                                          nesterov=False)),
                    tstate.sgd(lambda c: 0.05, momentum=0.9,
                               weight_decay=1e-4))
        kw = dict(momentum=0.9, weight_decay=1e-4)
        return (jfo.make_fused_tx("sgdm", lambda c: 0.05, mode, **kw),
                tfo.make_fused_tx("sgdm", lambda c: 0.05, mode, **kw))
    if mode == "off":
        return (optax.adamw(lambda c: 1e-3, weight_decay=0.01),
                tstate.adamw(lambda c: 1e-3, weight_decay=0.01))
    return (jfo.make_fused_tx("adam", lambda c: 1e-3, mode,
                              weight_decay=0.01),
            tfo.make_fused_tx("adam", lambda c: 1e-3, mode,
                              weight_decay=0.01))


def port_state(model_kind: str, opt: str, mode: str, seed: int = 0):
    """A fresh port TrainState (its own seeded init) for one case."""
    _, ttx = _txs(opt, mode)
    if model_kind == "resnet":
        model = ResNetTiny(num_classes=10, vd=True, dtype=torch.float32,
                           device="cpu", seed=seed)
        return tcls.create_state(model, ttx)
    model = Transformer(TransformerConfig(**LM, dtype=torch.float32),
                        device="cpu", seed=seed)
    return tstate.TrainState.create(
        model=model, tx=ttx, params=bridge.flax_named_parameters(model))


def port_batch(model_kind: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if model_kind == "resnet":
        return {"image": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 8).astype(np.int32)}
    return {"tokens": rng.integers(0, LM["vocab_size"],
                                   (4, LM["max_len"])).astype(np.int32)}


def jax_state(model_kind: str, opt: str, mode: str, steps: int = 2):
    """The JAX TrainState after ``steps`` steps from the port's seed-0
    init, on port_batch (host numpy leaves)."""
    jtx, _ = _txs(opt, mode)
    init = port_state(model_kind, opt, mode).model
    if model_kind == "resnet":
        v = bridge.torch_to_flax_variables(init.state_dict())
        st = JTrainState.create(apply_fn=JTiny(num_classes=10,
                                               vd=True).apply,
                                params=v["params"], tx=jtx,
                                batch_stats=v["batch_stats"])
        step = jcls.make_classification_step(10, smoothing=0.1,
                                             donate=False)
    else:
        params = bridge.torch_to_flax(init.state_dict(), LM["n_heads"])
        st = JTrainState.create(
            apply_fn=JTransformer(JConfig(**LM, dtype=jnp.float32)).apply,
            params=params, tx=jtx)
        step = j_make_train_step(j_lm_loss_fn, donate=False)
    for i in range(steps):
        st, _ = step(st, port_batch(model_kind, i))
    return jax.device_get(st)


def jax_bytes(host) -> bytes:
    return fser.to_bytes(host)


def leaves_equal(a, b) -> list:
    """Paths of two state dicts whose leaves differ in dtype, shape or
    bits (None = equal)."""
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    bad = []
    for path, x in fa:
        y = fb.get(path)
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape \
                or x.tobytes() != y.tobytes():
            bad.append(jax.tree_util.keystr(path))
    assert len(fa) == len(fb)
    return bad


@pytest.fixture(scope="module")
def jax_states():
    return {c: jax_state(*c) for c in CASES}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_bytes_are_flax_bytes(case, jax_states):
    """The encoder on the JAX tree, and the port's own tree after taking
    the JAX state in: flax's bytes, byte for byte."""
    host = jax_states[case]
    want = jax_bytes(host)
    assert tser.msgpack_serialize(fser.to_state_dict(host)) == want
    state = port_state(*case[:3], seed=1)
    bridge.flax_to_state(tser.msgpack_restore(want), state)
    tree = bridge.state_to_flax(state)
    assert tser.to_bytes(tree) == want
    # keys, nesting and dtypes: flax's own view of the port's tree
    got = fser.msgpack_restore(tser.to_bytes(tree))
    assert jax.tree.structure(got) == jax.tree.structure(
        fser.to_state_dict(host))
    assert not leaves_equal(got, fser.to_state_dict(host))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1,
    -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    True, False, None, 1.5, -0.0, "", "a" * 31, "a" * 32, "a" * 255,
    "a" * 256, "é" * 40, b"", b"x" * 255, b"x" * 256, b"x" * 70000,
    {"a": 1, "b": {"c": 2.5}}, {str(i): i for i in range(20)}],
    ids=lambda v: f"{type(v).__name__}-{len(v) if hasattr(v, '__len__') else v}")
def test_encodings_are_msgpack_s(value):
    """Every encoding the payload uses, against the msgpack package
    (flax's packer: use_bin_type, strict types)."""
    want = msgpack.packb(value, use_bin_type=True, strict_types=True)
    assert tser.msgpack_serialize(value) == want
    got = tser.msgpack_restore(want)
    assert got == value and type(got) is type(value)


@pytest.mark.parametrize("dtype", ["float32", "float16", "float64", "int8",
                                   "uint8", "int16", "int32", "int64",
                                   "uint32", "bool"])
def test_arrays_and_scalars_are_flax_s(dtype):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=(3, 5)) * 50).astype(dtype)
    tree = {"a": arr, "s": arr.reshape(-1)[0], "z": np.zeros((0, 2), dtype),
            "d": np.asarray(arr[0, 0])}
    data = fser.to_bytes(tree)
    assert tser.to_bytes(tree) == data
    got = tser.msgpack_restore(data)
    for k, v in tree.items():
        assert got[k].dtype == np.asarray(v).dtype
        assert np.asarray(got[k]).tobytes() == np.asarray(v).tobytes()
    assert isinstance(got["s"], np.generic)


def test_chunked_arrays_round_trip(monkeypatch):
    """Leaves above the size limit take flax's chunked form both ways."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(70, dtype=np.float32).reshape(7, 10),
            "b": np.arange(3, dtype=np.int8)}
    data = fser.to_bytes(tree)
    assert tser.to_bytes(tree) == data
    got = tser.msgpack_restore(data)
    assert np.array_equal(got["w"], tree["w"])
    assert got["w"].shape == (7, 10)


@pytest.mark.parametrize("name,torch_dtype", [
    ("bfloat16", torch.bfloat16), ("float8_e4m3fn", torch.float8_e4m3fn),
    ("float8_e5m2", torch.float8_e5m2)])
def test_numpy_less_dtypes_restore_as_torch_views(name, torch_dtype):
    """bfloat16 and fp8 leaves (ml_dtypes on the JAX side) restore as CPU
    torch tensors over the raw bytes, and write the same bytes back."""
    import ml_dtypes
    x = np.linspace(-3, 3, 12, dtype=np.float32).astype(
        getattr(ml_dtypes, name)).reshape(3, 4)
    data = fser.to_bytes({"x": x})
    got = tser.msgpack_restore(data)["x"]
    assert got.dtype == torch_dtype and tuple(got.shape) == (3, 4)
    assert np.array_equal(got.view(torch.uint8 if got.element_size() == 1
                                   else torch.int16).numpy().tobytes(),
                          x.tobytes())
    assert tser.to_bytes({"x": got}) == data


def test_unknown_dtype_names_raise():
    payload = msgpack.packb(((2,), "float99", b"\0" * 8), use_bin_type=True)
    data = msgpack.packb({"x": msgpack.ExtType(1, payload)},
                         use_bin_type=True)
    with pytest.raises(ValueError, match="float99"):
        tser.msgpack_restore(data)
    with pytest.raises(ValueError, match="truncated"):
        tser.msgpack_restore(fser.to_bytes({"x": np.ones(4)})[:-3])
    with pytest.raises(TypeError):
        tser.to_bytes({"x": object()})


def test_from_bytes_fills_the_target_structure():
    target = {"a": (np.zeros(2), np.zeros(3)), "b": {"c": np.zeros(1)}}
    src = {"a": (np.ones(2), np.full(3, 2.0)), "b": {"c": np.full(1, 3.0)}}
    got = tser.from_bytes(target, tser.to_bytes(src))
    assert isinstance(got["a"], tuple) and np.array_equal(got["a"][1],
                                                          src["a"][1])
    with pytest.raises(ValueError):
        tser.from_bytes({"x": np.zeros(1)}, tser.to_bytes(src))


# -- both directions ---------------------------------------------------------

DIR_CASES = [("resnet", "sgdm", "fp32"), ("resnet", "sgdm", "int8"),
             ("resnet", "sgdm", "off"), ("lm", "adam", "int8")]
DIR_IDS = [f"{m}-{o}-{q}" for m, o, q in DIR_CASES]


@pytest.mark.parametrize("case", DIR_CASES, ids=DIR_IDS)
def test_jax_checkpoint_restores_in_the_port(case, jax_states, tmp_path):
    host = jax_states[case]
    jstatus = JTrainStatus(epoch=1, step=2, step_in_epoch=0,
                           samples_seen=16, world_size=1)
    mgr = jckpt.CheckpointManager(str(tmp_path), process_index=0)
    mgr.save(host, jstatus)
    mgr.close()
    state = port_state(*case, seed=3)
    out = CheckpointManager(str(tmp_path)).restore(state)
    assert out is not None
    _, status = out
    assert status == TrainStatus(**jstatus.to_dict())
    with open(tmp_path / "ckpt-0" / "state.msgpack", "rb") as f:
        assert tser.to_bytes(bridge.state_to_flax(state)) == f.read()


@pytest.mark.parametrize("case", DIR_CASES, ids=DIR_IDS)
def test_port_checkpoint_restores_in_jax(case, jax_states, tmp_path):
    host = jax_states[case]
    state = port_state(*case, seed=3)
    bridge.flax_to_state(fser.to_state_dict(host), state)
    status = TrainStatus(epoch=0, step=2, step_in_epoch=2, samples_seen=16)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(state, status) == 0
    mgr.close()
    target = jax_state(*case, steps=0)
    got, jstatus = jckpt.CheckpointManager(
        str(tmp_path), process_index=0).restore(target)
    assert jstatus.to_dict() == status.to_dict()
    assert not leaves_equal(fser.to_state_dict(got),
                            fser.to_state_dict(host))


# -- the manager -------------------------------------------------------------


def _resnet_state(seed: int = 0):
    return port_state("resnet", "sgdm", "fp32", seed)


def _train(state, steps: int = 1, seed: int = 0):
    step = tcls.make_classification_step(10, smoothing=0.1)
    for i in range(steps):
        b = port_batch("resnet", seed + i)
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    return state


def _payload(directory, version: int) -> bytes:
    with open(os.path.join(directory, f"ckpt-{version}",
                           "state.msgpack"), "rb") as f:
        return f.read()


def test_versions_gc_and_status(tmp_path):
    state = _resnet_state()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_version() is None
    assert mgr.restore(state) is None
    for i in range(4):
        assert mgr.save(state, TrainStatus(epoch=i, step=10 * i)) == i
    assert mgr.versions() == [2, 3]
    with open(tmp_path / "ckpt-3" / "meta.json") as f:
        meta = json.load(f)
    assert meta == {"version": 3, "status": TrainStatus(
        epoch=3, step=30).to_dict()}
    _, status = mgr.restore(_resnet_state(seed=5))
    assert status.epoch == 3 and status.step == 30
    _, status = mgr.restore(_resnet_state(seed=5), version=2)
    assert status.epoch == 2
    mgr.close()


def test_a_temp_dir_is_never_a_version(tmp_path):
    (tmp_path / ".tmp-ckpt-abc").mkdir()
    (tmp_path / ".tmp-ckpt-abc" / "state.msgpack").write_bytes(b"torn")
    (tmp_path / "ckpt-x").mkdir()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.versions() == [] and mgr.restore(_resnet_state()) is None
    mgr.gc_stale_tmp()
    assert not (tmp_path / ".tmp-ckpt-abc").exists()
    mgr.save(_resnet_state(), TrainStatus())
    assert sorted(os.listdir(tmp_path)) == ["ckpt-0", "ckpt-x"]
    mgr.close()


def test_restored_state_trains_on_bit_for_bit(tmp_path):
    """A restored fused-optimizer state lives in the optimizer's buckets:
    a step after the restore equals the same step without it."""
    state = _train(_resnet_state(), 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, TrainStatus(step=2))
    other = _resnet_state(seed=9)
    mgr.restore(other)
    assert other.step == 2 and other.opt_state.count == 2
    a = bridge.state_to_flax(_train(state, 1, seed=7))
    b = bridge.state_to_flax(_train(other, 1, seed=7))
    assert tser.to_bytes(a) == tser.to_bytes(b)
    mgr.close()


def test_async_saves_write_the_sync_bytes(tmp_path):
    state = _train(_resnet_state(), 1)
    sync = CheckpointManager(str(tmp_path / "sync"))
    sync.save(state, TrainStatus(step=1))
    asy = CheckpointManager(str(tmp_path / "async"))
    asy.save_async(state, TrainStatus(step=1))
    asy.wait()
    assert _payload(tmp_path / "sync", 0) == _payload(tmp_path / "async", 0)
    assert asy.stats()["saves_async"] == 1 and asy.stats()["writes"] == 1
    sync.close()
    asy.close()


def test_async_snapshot_is_not_touched_by_later_steps(tmp_path):
    """PyTorch updates in place: one async save, then three steps at once,
    gives the bytes of a sync save taken before those steps."""
    state = _train(_resnet_state(), 1)
    sync = CheckpointManager(str(tmp_path / "sync"))
    sync.save(state, TrainStatus(step=1))
    asy = CheckpointManager(str(tmp_path / "async"))
    gate = threading.Event()
    original = asy._write

    def slow_write(job):
        gate.wait(30)
        return original(job)

    asy._write = slow_write
    asy.save_async(state, TrainStatus(step=1))
    _train(state, 3, seed=4)
    gate.set()
    asy.wait()
    assert _payload(tmp_path / "sync", 0) == _payload(tmp_path / "async", 0)
    sync.close()
    asy.close()


def test_drop_to_latest(tmp_path):
    """A snapshot queued behind a busy writer is superseded by a newer
    one; the write in flight is never dropped."""
    state = _resnet_state()
    mgr = CheckpointManager(str(tmp_path))
    gate = threading.Event()
    started = threading.Event()
    original = mgr._write

    def slow_write(job):
        started.set()
        gate.wait(30)
        return original(job)

    mgr._write = slow_write
    mgr.save_async(state, TrainStatus(step=1))
    assert started.wait(30)
    mgr.save_async(state, TrainStatus(step=2))
    mgr.save_async(state, TrainStatus(step=3))
    gate.set()
    mgr.wait()
    steps = []
    for v in mgr.versions():
        with open(tmp_path / f"ckpt-{v}" / "meta.json") as f:
            steps.append(json.load(f)["status"]["step"])
    assert steps == [1, 3]
    assert mgr.stats()["superseded"] == 1
    mgr.close()


def test_a_write_error_surfaces_on_the_next_call(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def broken(tree, status):
        raise OSError("disk full")

    mgr._write_tree = broken
    mgr.save_async(_resnet_state(), TrainStatus())
    with pytest.raises(CheckpointWriteError):
        mgr.wait()
    mgr.wait()   # raised once
    mgr.save_async(_resnet_state(), TrainStatus())
    with pytest.raises(CheckpointWriteError):
        mgr.close()
    assert mgr.stats()["errors"] == 2


def test_a_corrupt_chunk_falls_back_to_the_previous_version(tmp_path):
    state = _train(_resnet_state(), 1)
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(state, TrainStatus(step=1))
    _train(state, 1, seed=3)
    mgr.save(state, TrainStatus(step=2))
    chunk = sorted(p for p in os.listdir(tmp_path / "ckpt-1")
                   if p.endswith(".npy"))[3]
    path = tmp_path / "ckpt-1" / chunk
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(EdlCheckpointCorrupt):
        mgr.restore(_resnet_state(), version=1)
    _, status = mgr.restore(_resnet_state())
    assert status.step == 1 and mgr.last_restored_version == 0
    mgr.close()


def test_file_mirror_and_fetch(tmp_path):
    """Rank 0 mirrors each sealed version to file://; a pod with an empty
    local dir fetches the mirror's LATEST before restoring, and a cold
    writer numbers its next save above the mirror's."""
    remote = f"file://{tmp_path / 'remote'}"
    state = _train(_resnet_state(), 1)
    mgr = CheckpointManager(str(tmp_path / "a"), remote=remote)
    mgr.save(state, TrainStatus(step=1))
    mgr.save(state, TrainStatus(step=2))
    mgr.close()
    assert (tmp_path / "remote" / "LATEST").read_text() == "1"
    assert (tmp_path / "remote" / "ckpt-1" / "COMPLETE").exists()
    cold = CheckpointManager(str(tmp_path / "b"), remote=remote)
    other = _resnet_state(seed=4)
    _, status = cold.restore(other)
    assert status.step == 2 and cold.versions() == [1]
    assert tser.to_bytes(bridge.state_to_flax(other)) == tser.to_bytes(
        bridge.state_to_flax(state))
    fresh = CheckpointManager(str(tmp_path / "c"), remote=remote)
    assert fresh.save(state, TrainStatus(step=3)) == 2
    assert (tmp_path / "remote" / "LATEST").read_text() == "2"
    cold.close()
    fresh.close()


def test_restore_raw_reads_either_format(tmp_path):
    state = _train(_resnet_state(), 1)
    for sharded in (False, True):
        mgr = CheckpointManager(str(tmp_path / str(sharded)),
                                sharded=sharded)
        mgr.save(state, TrainStatus(step=1))
        raw, status = mgr.restore_raw()
        assert status.step == 1
        assert not leaves_equal(raw, tser.to_state_dict(
            bridge.state_to_flax(state)))
        mgr.close()


def test_a_mismatched_optimizer_is_refused(tmp_path):
    state = _train(_resnet_state(), 1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, TrainStatus())
    with pytest.raises(ValueError, match="moment format"):
        mgr.restore(port_state("resnet", "sgdm", "int8"))
    with pytest.raises(ValueError):
        mgr.restore(port_state("resnet", "sgdm", "off"))
    mgr.close()


def test_lm_params_take_their_flax_layout():
    """The attention projections' (heads, head_dim) split survives the
    checkpoint tree both ways."""
    state = port_state("lm", "adam", "fp32")
    tree = bridge.state_to_flax(state)
    q = tree.params["block0"]["attn"]["query"]["kernel"]
    assert q.shape == (LM["d_model"], LM["n_heads"],
                       LM["d_model"] // LM["n_heads"])
    other = port_state("lm", "adam", "fp32", seed=2)
    bridge.flax_to_state(tser.to_state_dict(tree), other)
    for (n, a), (_, b) in zip(state.model.named_parameters(),
                              other.model.named_parameters()):
        assert torch.equal(a, b), n


def test_timeline_spans_of_the_writer(tmp_path, monkeypatch):
    """With EDL_TPU_TRACE on, the manager's snapshot and write become
    finished spans (utils/timeline -> obs/trace)."""
    from edl_tpu_torch.obs import trace

    monkeypatch.setenv("EDL_TPU_TRACE", str(tmp_path / "spans"))
    trace.reconfigure()
    try:
        mgr = CheckpointManager(str(tmp_path / "ck"))
        mgr.save_async(_resnet_state(), TrainStatus())
        mgr.close()
        names = [s["name"] for s in trace.finished("ckpt.")]
    finally:
        monkeypatch.delenv("EDL_TPU_TRACE")
        trace.reconfigure()
    assert names == ["ckpt.snapshot", "ckpt.write"]
