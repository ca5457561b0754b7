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

import dataclasses
import json
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
from edl_tpu.models.transformer import lm_loss_fused as j_lm_loss_fused
from edl_tpu.ops import opt_kernels as jok
from edl_tpu.train import amp as jamp
from edl_tpu.train import fused_opt as jfo
from edl_tpu.train import lr as jlr
from edl_tpu.train.state import TrainState as JTrainState
from edl_tpu.train.step import make_train_step as j_make_train_step
from edl_tpu_torch import bridge
from edl_tpu_torch.data import pipeline as tpipe
from edl_tpu_torch.examples import lm_train
from edl_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              lm_loss_fn, lm_loss_fused)
from edl_tpu_torch.ops import opt_kernels as tok
from edl_tpu_torch.parallel import distributed
from edl_tpu_torch.train import amp
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


def _model(params, attention="flash", remat=False, dtype=torch.float32):
    model = Transformer(TransformerConfig(**SMALL, dtype=dtype,
                                          attention=attention, remat=remat),
                        device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    return model.train()


def _close(got_tree, want_tree, atol):
    for a, b in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


def _three_steps(flax_params, shards, fused_opt, param_atol,
                 grad_atol=1e-5, fused_loss=False, remat=False):
    schedule_args = (3e-3, 4, 1)
    jmodel = JTransformer(JConfig(**SMALL, dtype=jnp.float32,
                                  attention="flash", remat=remat))
    jtx = jfo.make_fused_tx("adam", jlr.cosine_with_warmup(*schedule_args),
                            fused_opt, weight_decay=0.01)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=flax_params,
                                tx=jtx)
    jloss = j_lm_loss_fused if fused_loss else j_lm_loss_fn
    jstep = j_make_train_step(jloss, donate=False)
    jgrad = jax.jit(jax.grad(lambda p, s, b: jloss(s, p, b)[0]))

    model = _model(flax_params, remat=remat)
    ttx = tfo.make_fused_tx("adam", tlr.cosine_with_warmup(*schedule_args),
                            fused_opt, weight_decay=0.01)
    state = TrainState.create(model=model, tx=ttx,
                              params=bridge.flax_named_parameters(model))
    step = make_train_step(lm_loss_fused if fused_loss else lm_loss_fn)

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


@pytest.mark.parametrize("fused_loss,remat", [(True, False), (False, True),
                                              (True, True)])
def test_three_fused_loss_and_remat_steps_match_jax(flax_params, shards,
                                                    fused_loss, remat):
    """lm_loss_fused (the streamed-vocab loss) and remat blocks on both
    sides: the same bounds as the plain steps."""
    _three_steps(flax_params, shards, "fp32", 1e-5, fused_loss=fused_loss,
                 remat=remat)


# fp16 activations, loss-scaled: the losses within FP16_LOSS_ATOL of
# JAX's, and the parameters after each step within FP16_PARAM_ATOL, with
# all but FP16_PARAM_FRAC of the elements within 1e-4 (measured: losses
# 6e-5 apart; 2 of 107,136 elements more than 1e-3 apart). fp16 rounds
# the residual stream and each projection at places that differ between
# the frameworks, and Adam's early steps move an element by about lr
# whatever its gradient's size, so an element whose gradient is within
# fp16 rounding of zero may step the other way (2 lr = 6e-3). Tighter
# than the bf16 bounds (6e-2 on logits).
FP16_LOSS_ATOL = 5e-4
FP16_PARAM_ATOL = 1e-2
FP16_PARAM_FRAC = 1e-3


@pytest.mark.parametrize("fused_loss", [False, True])
def test_three_fp16_train_steps_match_jax(flax_params, shards, fused_loss):
    """Three loss-scaled fp16 steps of the tiny LM (fused Adam with fp32
    moments) against the JAX package's make_train_step(loss_scale=True):
    the loss, the finite flag, the loss scale and the parameters."""
    schedule_args = (3e-3, 4, 1)
    jmodel = JTransformer(JConfig(**SMALL, dtype=jnp.float16,
                                  attention="flash"))
    jstate = JTrainState.create(
        apply_fn=jmodel.apply, params=flax_params,
        tx=jfo.make_fused_tx("adam", jlr.cosine_with_warmup(*schedule_args),
                             "fp32", weight_decay=0.01))
    jstep = j_make_train_step(j_lm_loss_fused if fused_loss
                              else j_lm_loss_fn, donate=False,
                              loss_scale=True)
    model = _model(flax_params, dtype=torch.float16)
    state = TrainState.create(
        model=model, params=bridge.flax_named_parameters(model),
        tx=tfo.make_fused_tx("adam", tlr.cosine_with_warmup(*schedule_args),
                             "fp32", weight_decay=0.01))
    step = make_train_step(lm_loss_fused if fused_loss else lm_loss_fn,
                           loss_scale=True)
    ls, jls = amp.DynamicLossScale.create(), jamp.DynamicLossScale.create()
    jbatches = jpipe.DataLoader(jpipe.FileSource(shards), 8, seed=0,
                                num_workers=0).epoch(0)
    tbatches = tpipe.DataLoader(tpipe.FileSource(shards), 8, seed=0,
                                num_workers=0).epoch(0)
    for jb, tb in zip(jbatches, tbatches):
        jstate, jm, jls = jstep(jstate, jb, jls)
        state, tm, ls = step(state, {"tokens": torch.from_numpy(tb["tokens"])},
                             ls)
        assert bool(tm["finite"]) == bool(jm["finite"]) is True
        assert float(tm["loss_scale"]) == float(jm["loss_scale"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=FP16_LOSS_ATOL)
        diffs = np.concatenate([
            np.abs(np.asarray(a) - np.asarray(b)).ravel() for a, b in zip(
                jax.tree.leaves(bridge.torch_to_flax(model.state_dict(),
                                                     SMALL["n_heads"])),
                jax.tree.leaves(jstate.params))])
        assert diffs.max() <= FP16_PARAM_ATOL, diffs.max()
        assert np.mean(diffs > 1e-4) <= FP16_PARAM_FRAC
    assert state.step == int(jstate.step) == 3
    assert model.block0.attn.query.weight.dtype == torch.float32


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


def _run_lm_train(tmp_path, capsys, monkeypatch, flags):
    """lm_train.main with ``flags`` on the CPU, recording the config the
    model was built with, every loss function a step or the eval ran and
    the loss-scaled steps. Returns (final eval loss, record)."""
    seen = {"losses": set()}
    built = Transformer.__init__

    def record_init(self, cfg, **kw):
        seen["cfg"] = cfg
        built(self, cfg, **kw)

    def record(fn, name):
        def wrapped(*args, **kw):
            seen["losses"].add(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(Transformer, "__init__", record_init)
    monkeypatch.setattr(lm_train, "lm_loss_fn", record(lm_loss_fn, "dense"))
    monkeypatch.setattr(lm_train, "lm_loss_fused",
                        record(lm_loss_fused, "fused"))
    reads = amp.read_finite.reads
    rc = lm_train.main(["--data-dir", str(tmp_path), *TINY_ARGV,
                        "--fused-opt", "fp32", "--lr", "3e-3",
                        "--warmup-steps", "1", *flags])
    seen["scaled"] = amp.read_finite.reads - reads
    assert rc == 0
    final = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("final_eval_loss=")]
    assert len(final) == 1
    return float(final[0].split("=")[1]), seen


@pytest.mark.parametrize("flags", [
    ["--fp16"], ["--fused-loss"], ["--remat", "on"], ["--remat", "auto"],
    ["--fp16", "--fused-loss", "--remat", "on"]])
def test_lm_train_new_paths_on_the_cpu(tmp_path, capsys, monkeypatch, flags):
    """--fp16 (fp16 activations, a loss-scaled step: 6 steps, each reading
    its finite flag once), --fused-loss (the streamed loss, for training
    and eval: the dense loss never runs), --remat on|auto (auto: the tiny
    model's activations fit 16 GiB, no remat)."""
    loss, seen = _run_lm_train(tmp_path, capsys, monkeypatch, flags)
    assert np.isfinite(loss) and loss < np.log(256) + 0.5
    cfg = seen["cfg"]
    assert cfg.dtype == (torch.float16 if "--fp16" in flags
                         else torch.float32)
    assert seen["scaled"] == (6 if "--fp16" in flags else 0)
    assert seen["losses"] == ({"fused"} if "--fused-loss" in flags
                              else {"dense"})
    assert cfg.remat == ("on" in flags)


def test_lm_train_remat_auto_follows_choose_remat(tmp_path, capsys,
                                                  monkeypatch):
    """--remat auto takes auto_remat's choice for the local batch."""
    monkeypatch.setattr(lm_train, "auto_remat",
                        lambda cfg, bs, device: dataclasses.replace(
                            cfg, remat=bs == 8 and device.type == "cpu"))
    _, seen = _run_lm_train(tmp_path, capsys, monkeypatch,
                            ["--remat", "auto"])
    assert seen["cfg"].remat


@pytest.mark.parametrize("flags,match", [
    (["--moe", "--mesh", "fsdp"], "--moe owns the ep mesh"),
    (["--moe", "--mesh", "sp"], "--mesh sp conflicts"),
    (["--moe", "--fp16"], "--moe is not supported with --fp16"),
    (["--moe", "--fused-loss"], "--fused-loss has no MoE variant"),
    (["--moe", "--dcn-compress", "int8"], "under --moe the wire knob"),
    (["--moe", "--ckpt-sharded"], r"item 14\(d\)"),
    (["--fsdp", "--mesh", "sp"], "legacy alias of --mesh fsdp"),
    (["--mesh", "fsdp", "--dcn-compress", "int8"],
     "own the dp gradient reduction"),
    (["--fsdp", "--comm-bucket-mb", "4"], "own the dp gradient reduction"),
    (["--fp16", "--dcn-compress", "topk"], "not supported with --fp16")])
def test_unported_flags_exit_before_any_work(tmp_path, flags, match):
    """The JAX CLI's conflicts of --moe, --mesh sp and the world flags
    exit with its words, and --moe --ckpt-sharded (ep-sharded expert
    chunks) names item 14(d); all before any work."""
    data_dir = tmp_path / "never-written"
    with pytest.raises(SystemExit, match=match):
        lm_train.main(["--data-dir", str(data_dir), *TINY_ARGV, *flags])
    assert not data_dir.exists()


@pytest.mark.parametrize("flags", [["--moe", "--moe-top-k", "1"],
                                   ["--mesh", "sp"]])
def test_moe_and_sp_train_in_a_world_of_one(tmp_path, capsys, monkeypatch,
                                            flags):
    """--moe (E = 2 experts, the default 2 x world) and --mesh sp (a ring
    of one rank: the plain model) train and evaluate on one rank."""
    loss, seen = _run_lm_train(tmp_path, capsys, monkeypatch, flags)
    assert np.isfinite(loss)
    assert seen["cfg"].moe == ("--moe" in flags)
    if "--moe" in flags:
        assert (seen["cfg"].n_experts, seen["cfg"].moe_top_k) == (2, 1)
    assert not seen["cfg"].use_ring


def test_unported_env_knobs_exit(tmp_path, monkeypatch, capsys):
    """The gradient path's env knobs: with --mesh fsdp they exit with the
    JAX CLI's conflict before any work; alone, in a world of one, they
    train through the comm step (its accounting in the benchmark log)."""
    data_dir = tmp_path / "never-written"
    for knob, value in (("EDL_TPU_DCN_COMPRESS", "topk"),
                        ("EDL_TPU_COMM_BUCKET_MB", "4")):
        monkeypatch.setenv(knob, value)
        with pytest.raises(SystemExit, match="own the dp gradient"):
            lm_train.main(["--data-dir", str(data_dir), *TINY_ARGV,
                           "--mesh", "fsdp"])
        assert not data_dir.exists()
        blog = tmp_path / f"blog-{knob}"
        assert lm_train.main(["--data-dir", str(tmp_path / "data"),
                              *TINY_ARGV, "--fused-opt", "fp32",
                              "--benchmark-log", str(blog)]) == 0
        with open(blog / "log_0.json") as f:
            log = json.load(f)
        assert log["comm_steps"] > 0 and log["world_size"] == 1
        assert log["dcn_compress"] == ("topk" if knob.endswith("COMPRESS")
                                       else "off")
        monkeypatch.delenv(knob)
    assert "final_eval_loss=" in capsys.readouterr().out


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
    """A world above one now trains (tests/test_torch_lm_world.py); one
    without a coordinator still exits before any work, with
    init_from_env's typed error."""
    monkeypatch.setenv("EDL_TPU_WORLD_SIZE", "2")
    data_dir = tmp_path / "never-written"
    with pytest.raises(EdlError, match="EDL_TPU_COORDINATOR"):
        lm_train.main(["--data-dir", str(data_dir), *TINY_ARGV])
    assert not data_dir.exists()
    assert not distributed.is_initialized()


def test_step_options_and_dropout_raise():
    """loss_scale and comm exclude each other, as in the JAX package;
    train-mode dropout raises."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(lm_loss_fn, loss_scale=True,
                        comm=CommConfig(compress="int8"))
    assert callable(make_train_step(lm_loss_fn, loss_scale=True))
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
