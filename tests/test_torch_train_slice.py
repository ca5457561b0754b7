"""The training slice as a whole: the port's lm_train step (model, loss,
flash backward, fused Adam with fp32 or quantized moments, schedule,
data) against the JAX package's, and the port's lm_train entry point on
the CPU.

A 2-layer, d=64, vocab-256, S=128 fp32 transformer starts from the JAX
init (bridged), reads the same synthetic shards through each package's
loader, and takes 3 steps of `make_train_step(lm_loss_fn)` with
`make_fused_tx("adam", cosine_with_warmup(...), "fp32", weight_decay=0.01)`
on each side, attention "flash" (the plain blockwise versions here, XLA's
blockwise scan on JAX's side). Tolerances: losses, gradients and the
parameters after each step within 1e-5 absolute (fp32 sums in another
order; the gaps measured at these sizes stay under 1e-6). Adam divides
each gradient by its own magnitude, so an element whose gradient were
within rounding of zero could move further; none is at these sizes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from edl_tpu.data import pipeline as jpipe
from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu.models.transformer import lm_loss_fn as j_lm_loss_fn
from edl_tpu.ops import opt_kernels as jok
from edl_tpu.train import fused_opt as jfo
from edl_tpu.train import lr as jlr
from edl_tpu.train.state import TrainState as JTrainState
from edl_tpu.train.step import make_train_step as j_make_train_step
from edl_tpu_torch import bridge
from edl_tpu_torch.data import pipeline as tpipe
from edl_tpu_torch.examples import lm_train
from edl_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              lm_loss_fn)
from edl_tpu_torch.ops import opt_kernels as tok
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.train import fused_opt as tfo
from edl_tpu_torch.train import lr as tlr
from edl_tpu_torch.train.comm import CommConfig, CommTrainStep
from edl_tpu_torch.train.loop import LoopConfig, TrainLoop
from edl_tpu_torch.train.state import TrainState
from edl_tpu_torch.train.step import make_train_step
from edl_tpu_torch.utils.exceptions import EdlError

SMALL = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_len=128)
TINY_ARGV = ["--make-synthetic", "1", "--rows-per-file", "48",
             "--vocab", "256", "--seq-len", "128", "--d-model", "64",
             "--n-heads", "2", "--n-layers", "2", "--d-ff", "128",
             "--batch-size", "8", "--epochs", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def flax_params():
    init = jax.jit(JTransformer(JConfig(**SMALL)).init,
                   static_argnames="train")
    variables = init(jax.random.PRNGKey(1), jnp.zeros((1, 128), jnp.int32),
                     train=False)
    return jax.tree.map(np.asarray, nn.unbox(variables["params"]))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    lm_train.make_synthetic_shards(str(d), 1, 24, 128, 256, seed=0)
    return sorted(str(d / f) for f in os.listdir(d) if f.startswith("train"))


def _model(params, attention="flash"):
    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32,
                                          attention=attention), device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    return model.train()


def _close(got_tree, want_tree, atol):
    for a, b in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


def _three_steps(flax_params, shards, fused_opt, param_atol,
                 grad_atol=1e-5):
    schedule_args = (3e-3, 4, 1)
    jmodel = JTransformer(JConfig(**SMALL, dtype=jnp.float32,
                                  attention="flash"))
    jtx = jfo.make_fused_tx("adam", jlr.cosine_with_warmup(*schedule_args),
                            fused_opt, weight_decay=0.01)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=flax_params,
                                tx=jtx)
    jstep = j_make_train_step(j_lm_loss_fn, donate=False)
    jgrad = jax.jit(jax.grad(lambda p, s, b: j_lm_loss_fn(s, p, b)[0]))

    model = _model(flax_params)
    ttx = tfo.make_fused_tx("adam", tlr.cosine_with_warmup(*schedule_args),
                            fused_opt, weight_decay=0.01)
    state = TrainState.create(model=model, tx=ttx,
                              params=bridge.flax_named_parameters(model))
    step = make_train_step(lm_loss_fn)

    jbatches = jpipe.DataLoader(jpipe.FileSource(shards), 8, seed=0,
                                num_workers=0).epoch(0)
    tbatches = tpipe.DataLoader(tpipe.FileSource(shards), 8, seed=0,
                                num_workers=0).epoch(0)
    for jb, tb in zip(jbatches, tbatches):
        assert np.array_equal(jb["tokens"], tb["tokens"])
        want_grads = jgrad(jstate.params, jstate, jb)
        jstate, jm = jstep(jstate, jb)
        state, tm = step(state, {"tokens": torch.from_numpy(tb["tokens"])})
        assert isinstance(tm["loss"], torch.Tensor)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(tm["ppl"]), float(jm["ppl"]),
                                   rtol=1e-5)
        _close(bridge.grads_to_flax(model, SMALL["n_heads"]), want_grads,
               grad_atol)
        _close(bridge.torch_to_flax(model.state_dict(), SMALL["n_heads"]),
               jstate.params, param_atol)
    assert state.step == int(jstate.step) == 3
    return state, jstate


def test_three_train_steps_match_jax(flax_params, shards):
    _three_steps(flax_params, shards, "fp32", 1e-5)


def test_three_int8_train_steps_match_jax(flax_params, shards, monkeypatch):
    """lm_train's quantized path: fused Adam with int8 m and fp8 v planes
    (K7's plain version here, JAX's Pallas kernel in interpret mode). The
    residual codes may differ by one step where XLA contracts an fma.
    Where a small v falls below the fp8 grid's smallest step (its scale
    follows the bucket's largest v), v reassembles to 0 and Adam's update
    is m / eps: there a one-step difference in m moves the parameter far,
    and that is the reference's algorithm (its own int8 run parts from
    its fp32 run by 5.08 on such an element at these sizes). So the
    parameters are held within 1e-3 (measured 3.7e-4, at 4 of 107,136
    elements above 1e-4), and 99.5% of them within 1e-6 (measured
    99.83%); the losses as in the fp32 test, and the gradients, which a
    step later see those few parameters apart, within 1e-4 (measured
    1.2e-5)."""
    # JAX's fused update through its Pallas kernels (interpret mode)
    monkeypatch.setattr(jok, "_FORCE_INTERPRET", True)
    state, jstate = _three_steps(flax_params, shards, "int8", 1e-3,
                                 grad_atol=1e-4)
    assert all(isinstance(m, tok.QPlane) for m in state.opt_state.m)
    gaps = np.concatenate([
        np.abs(np.asarray(a) - np.asarray(b)).ravel() for a, b in zip(
            jax.tree.leaves(bridge.torch_to_flax(state.model.state_dict(),
                                                 SMALL["n_heads"])),
            jax.tree.leaves(jstate.params))])
    assert np.mean(gaps <= 1e-6) >= 0.995
    assert tfo.opt_state_bytes(state.opt_state) * 1.8 <= sum(
        4 * 2 * p.numel() for p in state.opt_state.p)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_lm_loss_and_grads_match_jax(flax_params, attention):
    toks = np.random.default_rng(0).integers(0, 256, (2, 128)).astype(
        np.int32)
    jmodel = JTransformer(JConfig(**SMALL, dtype=jnp.float32,
                                  attention=attention))
    state = JTrainState.create(apply_fn=jmodel.apply, params=flax_params,
                               tx=jfo.fused_adam(1e-3))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_lm_loss_fn(state, p, {"tokens": toks}),
        has_aux=True))(flax_params)
    model = _model(flax_params, attention)
    loss, aux = lm_loss_fn(model, {"tokens": torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    np.testing.assert_allclose(aux["ppl"].item(), float(jaux["ppl"]),
                               rtol=1e-5)
    _close(bridge.grads_to_flax(model, SMALL["n_heads"]), jgrads, 1e-5)


@pytest.mark.parametrize("fused_opt", ["fp32", "off", "int8", "fp8"])
def test_lm_train_main_on_the_cpu(tmp_path, capsys, fused_opt):
    rc = lm_train.main(["--data-dir", str(tmp_path), *TINY_ARGV,
                        "--fused-opt", fused_opt, "--lr", "3e-3",
                        "--warmup-steps", "1"])
    assert rc == 0
    final = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("final_eval_loss=")]
    assert len(final) == 1
    loss = float(final[0].split("=")[1])
    assert np.isfinite(loss) and loss < np.log(256) + 0.5


@pytest.mark.parametrize("flags,item", [
    (["--moe"], 14), (["--mesh", "fsdp"], 10), (["--fsdp"], 10),
    (["--mesh", "sp"], 14), (["--dcn-compress", "int8"], 11),
    (["--comm-bucket-mb", "4"], 11), (["--fp16"], 4),
    (["--fused-loss"], 14), (["--remat", "on"], 6), (["--remat", "auto"], 6),
    (["--ckpt-dir", "ckpt"], 8), (["--loader-workers", "2"], 8),
    (["--profile", "trace"], 8)])
def test_unported_flags_exit_before_any_work(tmp_path, flags, item):
    data_dir = tmp_path / "never-written"
    with pytest.raises(SystemExit, match=f"item {item}"):
        lm_train.main(["--data-dir", str(data_dir), *TINY_ARGV, *flags])
    assert not data_dir.exists()


def test_unported_env_knobs_exit(tmp_path, monkeypatch):
    monkeypatch.setenv("EDL_TPU_DCN_COMPRESS", "topk")
    with pytest.raises(SystemExit, match="item 11"):
        lm_train.main(["--data-dir", str(tmp_path), *TINY_ARGV])
    monkeypatch.delenv("EDL_TPU_DCN_COMPRESS")
    monkeypatch.setenv("EDL_TPU_LOADER_WORKERS", "2")
    with pytest.raises(SystemExit, match="item 8"):
        lm_train.main(["--data-dir", str(tmp_path), *TINY_ARGV])


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_moments_refuse_fp16_with_the_jax_message(tmp_path,
                                                            quant):
    """The JAX package's refusal, before the port's fp16 (amp) exit."""
    data_dir = tmp_path / "never-written"
    with pytest.raises(SystemExit, match="not supported with --fp16"):
        lm_train.main(["--data-dir", str(data_dir), *TINY_ARGV, "--fp16",
                       "--fused-opt", quant])
    assert not data_dir.exists()


def test_world_of_two_needs_a_coordinator(monkeypatch):
    assert distributed.init_from_env().world_size == 1
    monkeypatch.setenv("EDL_TPU_WORLD_SIZE", "2")
    with pytest.raises(EdlError, match="EDL_TPU_COORDINATOR"):
        distributed.init_from_env(device="cpu")
    assert not distributed.is_initialized()


def test_lm_train_refuses_a_world_above_one(tmp_path, monkeypatch):
    """lm_train's world comes with item 11; it exits before any work."""
    monkeypatch.setenv("EDL_TPU_WORLD_SIZE", "2")
    data_dir = tmp_path / "never-written"
    with pytest.raises(SystemExit, match="item 11"):
        lm_train.main(["--data-dir", str(data_dir), *TINY_ARGV])
    assert not data_dir.exists()


@pytest.mark.parametrize("kw,item", [({"ckpt_dir": "c"}, 8),
                                     ({"profile_dir": "p"}, 8),
                                     ({"prefetch_batches": 2}, 8)])
def test_unported_loop_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        LoopConfig(**kw)


def test_step_options_and_dropout_raise():
    with pytest.raises(NotImplementedError, match="item 4"):
        make_train_step(lm_loss_fn, loss_scale=True)
    step = make_train_step(lm_loss_fn, comm=CommConfig(compress="int8"))
    assert isinstance(step, CommTrainStep) and step.config.compress == "int8"
    model = Transformer(TransformerConfig(**SMALL, dropout=0.1),
                        device="cpu")
    toks = torch.zeros((1, 128), dtype=torch.int32)
    assert model(toks).shape == (1, 128, 256)      # eval: dropout is identity
    with pytest.raises(NotImplementedError, match="dropout"):
        model.train()(toks)


def test_loop_logs_through_hooks_and_runs_eval():
    """The loop places host batches, counts steps and samples, reads the
    metrics back only at its log points and calls eval each epoch."""
    seen, evals = [], []

    def step_fn(state, batch):
        assert isinstance(batch["x"], torch.Tensor)
        return state + 1, {"loss": batch["x"].float().mean()}

    def data_fn(epoch):
        return ({"x": np.full((4, 2), epoch * 10 + i, np.int32)}
                for i in range(5))

    loop = TrainLoop(step_fn, 0, device="cpu",
                     config=LoopConfig(num_epochs=2, log_every_steps=2),
                     eval_fn=lambda s, e: evals.append((s, e)) or {},
                     hooks=[lambda lp, e, s, m: seen.append((e, s, m))])
    status = loop.run(data_fn)
    assert (status.epoch, status.step, status.samples_seen) == (1, 10, 40)
    assert loop.state == 10 and evals == [(5, 0), (10, 1)]
    assert [(e, s) for e, s, _ in seen] == [(0, 2), (0, 4), (1, 6), (1, 8),
                                            (1, 10)]
    assert seen[0][2] == {"loss": 1.0}
