"""The port's fused optimizer (ops/opt_kernels.py, train/comm.py bucket
planner, train/fused_opt.py) and the unfused AdamW against the JAX
package's (the quantized moments: tests/test_torch_opt_quant.py).

On the CPU the bucket updates run their plain versions; the CUDA kernels
K4-K7 are held against them bit for bit on the card by chip_smoke.py. Tolerances:
- the update math: rtol 1e-6 / atol 1e-8 against the jitted XLA
  expressions — same expression order, but XLA contracts a multiply-add
  into one fma (one rounding instead of two, ~1 ulp);
- three fused Adam steps: 1e-5, the JAX package's own gate
  (`update_parity_gate`) for fused Adam against optax;
- torch.optim.AdamW against optax.adamw: atol 1e-6 on parameters of
  size ~0.1 after three steps at lr ~1e-2 (same update, another rounding
  order and bias-correction pow);
- the bucket plan and pack/unpack: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from edl_tpu.models.transformer import Transformer as JTransformer
from edl_tpu.models.transformer import TransformerConfig as JConfig
from edl_tpu.ops import opt_kernels as jok
from edl_tpu.train import comm as jcomm
from edl_tpu.train import fused_opt as jfo
from edl_tpu_torch import bridge
from edl_tpu_torch.models.transformer import Transformer, TransformerConfig
from edl_tpu_torch.ops import opt_kernels as tok
from edl_tpu_torch.train import comm as tcomm
from edl_tpu_torch.train import fused_opt as tfo
from edl_tpu_torch.train import state as tstate
from test_torch_world import one_torch_thread  # noqa: F401

SMALL = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_len=128)


def _buffers(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    p, g, m = (rng.normal(0, 0.1, n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.normal(0, 0.01, n)).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_math_matches_jax(wd):
    p, g, m, v = _buffers()
    want = jok._adam_xla_fp32(*(jnp.asarray(a) for a in (p, g, m, v)),
                              jnp.float32(3e-4), jnp.float32(0.1),
                              jnp.float32(1e-3), b1=0.9, b2=0.999, eps=1e-8,
                              wd=wd)
    got = tok._adam_math(*(torch.from_numpy(a) for a in (p, g, m, v)),
                         torch.tensor(3e-4), torch.tensor(0.1),
                         torch.tensor(1e-3), 0.9, 0.999, 1e-8, wd)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_sgdm_math_matches_jax(wd):
    p, g, m, _ = _buffers(seed=1)
    want = jok._sgdm_xla_fp32(*(jnp.asarray(a) for a in (p, g, m)),
                              jnp.float32(0.1), mu=0.9, wd=wd)
    got = tok._sgdm_math(*(torch.from_numpy(a) for a in (p, g, m)),
                         torch.tensor(0.1), 0.9, wd)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("rel_err", [2.0 ** -34, 2.0 ** -30],
                         ids=["2^-34", "2^-30"])
def test_root_is_correctly_rounded_from_an_inexact_sqrt(rel_err,
                                                        monkeypatch):
    """The plain Adam's root stays numpy's correctly rounded fp32 root
    when torch's float64 sqrt is off by ``rel_err``, as its CPU kernel is
    on some first calls in a process (about 2^-34): that made the update
    parity gate's first Adam update an ulp off at a few elements, and
    ``adam_off_kernel_bitwise`` false now and then."""
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(0, 1, 200_000)).astype(np.float32) \
        * np.float32(2.0) ** rng.integers(-40, 40, 200_000).astype(np.float32)
    x[:4] = (0.0, 1.0, 4.0, np.float32(2.0) ** -149)
    sqrt = torch.sqrt
    wobble = torch.from_numpy(rng.uniform(-rel_err, rel_err, x.size))

    def inexact(t):
        out = sqrt(t)
        return out * (1 + wobble) if t.dtype == torch.float64 else out
    monkeypatch.setattr(torch, "sqrt", inexact)
    got = tok._sqrt_rn(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))


def _adam_numpy(p, g, m, v, lr, c1, c2, b1, b2, eps, wd):
    """The Adam update in numpy's fp32, each operation correctly rounded,
    in the JAX package's expression order."""
    f = np.float32
    m_new = f(1 - b1) * g + f(b1) * m
    v_new = f(1 - b2) * (g * g) + f(b2) * np.maximum(v, f(0))
    u = (m_new / f(c1)) / (np.sqrt(v_new / f(c2)) + f(eps))
    if wd:
        u = u + f(wd) * p
    return p + u * -f(lr), m_new, v_new


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_plain_updates_are_steady_across_threads_and_offsets(threads):
    """The plain Adam and momentum-SGD give one result for a bucket
    stepped whole or in slices that start at odd offsets, under any
    intra-op thread count (a CPU kernel's SIMD body and scalar tail split
    where its chunks end, which moves with all three), equal to numpy's
    correctly rounded fp32 bit for bit; and the update parity gate holds
    under that thread count."""
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        rng = np.random.default_rng(threads)
        n = 70_001          # above one chunk of a CPU kernel's range
        p, g, m = (rng.normal(0, s, n).astype(np.float32)
                   for s in (0.1, 0.02, 0.02))
        v = (rng.normal(0, 0.02, n) ** 2).astype(np.float32)
        args = (3e-4, 0.1, 1e-3, 0.9, 0.999, 1e-8, 1e-4)
        want = _adam_numpy(p, g, m, v, *np.float32(args[:3]), *args[3:])
        cuts = [0, 1, 4_099, 32_771, n]     # odd offsets, odd lengths
        whole = [torch.from_numpy(a.copy()) for a in (p, g, m, v)]
        sliced = [torch.from_numpy(a.copy()) for a in (p, g, m, v)]
        with torch.no_grad():
            tok._adam_plain(*whole, *args, "off")
            for lo, hi in zip(cuts, cuts[1:]):
                tok._adam_plain(*(t[lo:hi] for t in sliced), *args, "off")
        for w, a, b in zip(want, whole[:1] + whole[2:],
                           sliced[:1] + sliced[2:]):
            assert np.array_equal(w.view(np.int32), a.numpy().view(np.int32))
            assert tfo.bitwise_equal(a, b)
        sg_whole = [torch.from_numpy(a.copy()) for a in (p, g, m)]
        sg_sliced = [torch.from_numpy(a.copy()) for a in (p, g, m)]
        with torch.no_grad():
            tok._sgdm_plain(*sg_whole, 0.1, 0.9, 1e-4, "off")
            for lo, hi in zip(cuts, cuts[1:]):
                tok._sgdm_plain(*(t[lo:hi] for t in sg_sliced), 0.1, 0.9,
                                1e-4, "off")
        gd = g + np.float32(1e-4) * p
        m_want = gd + np.float32(0.9) * m
        p_want = p + m_want * -np.float32(0.1)
        for w, a, b in zip((p_want, m_want), sg_whole[:1] + sg_whole[2:],
                           sg_sliced[:1] + sg_sliced[2:]):
            assert np.array_equal(w.view(np.int32), a.numpy().view(np.int32))
            assert tfo.bitwise_equal(a, b)
        assert tfo.update_parity_gate(device="cpu")["ok"]
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def flax_params():
    init = jax.jit(JTransformer(JConfig(**SMALL)).init,
                   static_argnames="train")
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 128), jnp.int32),
                     train=False)
    return jax.tree.map(np.asarray, nn.unbox(variables["params"]))


def _model(params):
    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params))
    return model


@pytest.mark.parametrize("bucket_mb", [0.01, 4.0])
def test_plan_matches_jax_on_the_transformer(flax_params, bucket_mb):
    """Same leaves in each bucket, same payload and padded sizes."""
    named = bridge.flax_named_parameters(_model(flax_params))
    got = tcomm.plan_buckets([p for _, p in named], bucket_mb, align=128)
    want = jcomm.plan_buckets(flax_params, bucket_mb, align=128)
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(flax_params)[0]]
    assert [bridge.flax_path(n) for n, _ in named] == paths
    assert got.n_buckets == want.n_buckets > 0
    for gb, wb in zip(got.buckets, want.buckets):
        assert (gb.size, gb.padded) == (wb.size, wb.padded)
        assert [(s.leaf, s.offset, s.size) for s in gb.slots] == \
            [(s.leaf, s.offset, s.size) for s in wb.slots]
    if bucket_mb < 1:
        assert got.n_buckets > 3


def test_pack_unpack_round_trip_is_bitwise(flax_params):
    leaves = [p for _, p in bridge.flax_named_parameters(_model(flax_params))]
    plan = tcomm.plan_buckets(leaves, 0.01, align=128)
    bufs = tcomm.pack_buckets(leaves, plan)
    assert all(b.numel() % 128 == 0 for b in bufs)
    for b, bucket in zip(bufs, plan.buckets):
        assert not b[bucket.size:].any()
    back = tcomm.unpack_buckets(bufs, plan)
    for p, q in zip(leaves, back):
        assert q.shape == p.shape and torch.equal(q, p)


def _schedule(step):
    return 1e-2 * (step + 1) / 3


def test_fused_adam_matches_jax_over_three_steps(flax_params):
    """Params and both moments, bucket by bucket, after 3 fused fp32 Adam
    steps from the same params and gradients."""
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda p: rng.normal(0, 0.02, p.shape)
                         .astype(np.float32), flax_params)
    jtx = jfo.make_fused_tx("adam", _schedule, "fp32", weight_decay=0.01,
                            bucket_mb=0.01)
    jparams, jstate = flax_params, jtx.init(flax_params)
    for _ in range(3):
        jparams, jstate = jtx.fused_apply(grads, jstate, jparams)

    model = _model(flax_params)
    named = bridge.flax_named_parameters(model)
    tgrads = bridge.flax_to_torch(grads)
    ttx = tfo.make_fused_tx("adam", _schedule, "fp32", weight_decay=0.01,
                            bucket_mb=0.01)
    tstate_ = ttx.init(named)
    for _ in range(3):
        _, tstate_ = ttx.fused_apply([tgrads[n] for n, _ in named], tstate_,
                                     named)
    assert tstate_.count == int(jstate.count) == 3
    got = bridge.torch_to_flax(model.state_dict(), SMALL["n_heads"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    plan = ttx.plan(named)
    names = [n for n, _ in named]
    for mine, theirs in ((tstate_.m, jstate.m), (tstate_.v, jstate.v)):
        flat = bridge.buckets_to_flax(mine, plan, names, SMALL["n_heads"])
        for a, b in zip(flat, theirs):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_params_live_in_the_buckets(flax_params):
    model = _model(flax_params)
    named = bridge.flax_named_parameters(model)
    tx = tfo.fused_adam(1e-2, bucket_mb=0.01)
    state = tx.init(named)
    plan = tx.plan(named)
    for buf, bucket in zip(state.p, plan.buckets):
        for s in bucket.slots:
            assert named[s.leaf][1].data_ptr() == buf.data_ptr() + 4 * s.offset
    # a step moves the module's own weights, padding stays zero
    before = model.lm_head.weight.detach().clone()
    grads = [torch.full_like(p, 0.5) for _, p in named]
    tx.fused_apply(grads, state, named)
    assert not torch.equal(model.lm_head.weight, before)
    for buf, bucket in zip(state.p + state.m + state.v, plan.buckets * 3):
        assert not buf[bucket.size:].any()
    # a parameter moved after init is refused, not silently skipped
    model.lm_head.weight.data = model.lm_head.weight.data.clone()
    with pytest.raises(RuntimeError, match="no longer lives"):
        tx.fused_apply(grads, state, named)
    with pytest.raises(NotImplementedError, match="fused_apply"):
        tx.update(grads, state, named)


def test_torch_adamw_matches_optax():
    """The unfused tx (torch.optim.AdamW with the schedule) against
    optax.adamw, over the JAX package's gate world (a ragged param tree)
    and three steps of fresh gradients."""
    named, _ = tfo._gate_world()
    jparams = {n: p.detach().numpy().copy() for n, p in named}
    rng = np.random.default_rng(3)
    grads = [{n: rng.normal(0, 0.02, p.shape).astype(np.float32)
              for n, p in named} for _ in range(3)]
    otx = optax.adamw(_schedule, weight_decay=0.01)

    @jax.jit
    def one(params, ostate, g):
        updates, ostate = otx.update(g, ostate, params)
        return optax.apply_updates(params, updates), ostate

    ostate = otx.init(jparams)
    for g in grads:
        jparams, ostate = one(jparams, ostate, g)

    model = torch.nn.Module()
    for i, (_, p) in enumerate(named):
        model.register_parameter(f"p{i}", p)
    state = tstate.TrainState.create(
        model=model, tx=tstate.adamw(_schedule, weight_decay=0.01),
        params=named)
    for g in grads:
        for n, p in named:
            p.grad = torch.from_numpy(g[n])
        state.apply_gradients()
    assert state.step == 3
    for n, p in named:
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]),
                                   atol=1e-6)


def test_update_parity_gate_runs_on_the_cpu():
    """On the CPU both sides of the gate are the plain version; on a card
    (chip_smoke.py) one side is K5."""
    report = tfo.update_parity_gate(device="cpu")
    assert report["ok"] and report["adam_off_kernel_bitwise"]
    assert all(report[f"{o}_{q}_kernel_bitwise"] for o in ("sgdm", "adam")
               for q in ("off", "int8", "fp8"))


def test_fused_scalars_follow_the_jax_package():
    """lr from the schedule and c = 1 - b^t, both in fp32."""
    tx = tfo.fused_adam(_schedule)
    for count in range(4):
        lr, c1, c2 = tx.scalars(count)
        t = jnp.float32(count + 1)
        assert lr == float(np.float32(_schedule(count)))
        assert c1 == pytest.approx(float(1.0 - jnp.float32(0.9) ** t),
                                   rel=1e-6)
        assert c2 == pytest.approx(float(1.0 - jnp.float32(0.999) ** t),
                                   rel=1e-6)


@pytest.mark.parametrize("quant", ["off", "int8", "fp8"])
def test_buckets_run_plain_on_the_cpu_and_refuse_other_devices(quant):
    """A CPU bucket runs the plain version (here: the same as calling it
    directly); a bucket on any device but cpu or cuda raises (on cuda the
    kernel launches or raises: no quiet fallback)."""
    p, g, m = (torch.from_numpy(a) for a in _buffers(seed=2)[:3])
    if quant == "off":
        state, ref = m.clone(), m.clone()
    else:
        state = tok.quant_plane(m, quant)
        ref = tok.QPlane(*(t.clone() for t in state))
    p_ref = p.clone()
    tok._sgdm_plain(p_ref, g, ref, 0.1, 0.9, 1e-4, quant)
    tok.sgdm_bucket(p, g, state, 0.1, mu=0.9, wd=1e-4, quant=quant)
    assert torch.equal(p, p_ref)
    for a, b in zip(state if quant != "off" else [state],
                    ref if quant != "off" else [ref]):
        assert torch.equal(a, b)
    meta = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tok.sgdm_bucket(meta, meta, meta, 0.1, mu=0.9, wd=0.0, quant=quant)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tok.adam_bucket(meta, meta, meta, meta, 1e-3, 0.1, 0.1, b1=0.9,
                        b2=0.999, eps=1e-8, wd=0.0, quant=quant)


def test_bucket_checks_and_state_bytes():
    z = torch.zeros(100)
    with pytest.raises(ValueError, match="multiple of 128"):
        tok.adam_bucket(z, z, z, z, 1e-3, 0.1, 0.1, b1=0.9, b2=0.999,
                        eps=1e-8, wd=0.0)
    params, _ = tfo._gate_world()
    state = tfo.fused_adam(0.1, bucket_mb=0.05).init(params)
    assert tfo.opt_state_bytes(state) == 2 * 4 * sum(
        b.numel() for b in state.p)


def test_build_flags_are_per_source_and_in_the_digest(monkeypatch):
    """The optimizer kernels alone are built without fma contraction; a
    library's name (the digest) changes with its own flags, and no other
    source's."""
    from edl_tpu_torch.ops import _build

    for name in ("adam_fp32", "sgdm", "adam_q"):
        assert "-fmad=false" in _build.flags(name)
    assert _build.flags("flash_fwd") == _build.NVCC_FLAGS
    adam, fwd = (_build.library_path(n) for n in ("adam_fp32", "flash_fwd"))
    monkeypatch.setitem(_build.SOURCE_FLAGS, "adam_fp32", ("-fmad=true",))
    assert _build.library_path("adam_fp32") != adam
    assert _build.library_path("flash_fwd") == fwd


@pytest.mark.parametrize("source", ["adam_fp32", "flash_bwd", "sgdm",
                                    "adam_q"])
def test_kernel_build_failure_raises(monkeypatch, tmp_path, source):
    """A build that cannot run raises: no fallback to a plain version."""
    from edl_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises((RuntimeError, OSError)):
        _build.load(source)
    assert not list(tmp_path.glob("*.so"))


def test_shared_header_is_in_the_digest(monkeypatch, tmp_path):
    """sgdm.cu and adam_q.cu include csrc/quant.cuh: an edited header
    must not load a library built from the old one."""
    import shutil

    from edl_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in ("sgdm", "adam_q")}
    with open(csrc / "quant.cuh", "a") as f:
        f.write("// edited\n")
    for name, path in before.items():
        assert _build.library_path(name) != path


# -- the convergence smoke and the smoke CLI ---------------------------------

# the report's keys, the JAX package's (edl_tpu/train/fused_opt.py,
# convergence_smoke)
SMOKE_KEYS = {"quant", "steps", "envelope", "world", "cnn_sgdm",
              "transformer_adam", "ok"}
SMOKE_RUN_KEYS = {"loss_initial", "loss_dense", "loss_quant", "delta_rel",
                  "opt_bytes_dense", "opt_bytes_quant", "learned",
                  "within_envelope"}


@pytest.fixture(scope="module")
def jax_smoke_problems():
    """The JAX package's smoke problems on one device: {name: (loss_fn,
    state, batch, the state's variables bridged to the port)}."""
    from edl_tpu.parallel import mesh as jmesh

    mesh = jmesh.make_mesh(jmesh.MeshSpec({"dp": -1}),
                           devices=jax.devices()[:1])
    out = {}
    for name, (loss_fn, state, batch) in (
            ("cnn_sgdm", jcomm._smoke_cnn(1)),
            ("transformer_adam", jcomm._smoke_transformer(1, mesh))):
        host = jax.tree.map(np.asarray, jax.device_get(state))
        sd = (bridge.flax_to_torch(host.params) if name == "transformer_adam"
              else bridge.flax_variables_to_torch(
                  {"params": host.params, "batch_stats": host.batch_stats}))
        out[name] = (loss_fn, state, batch, sd)
    return out


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_convergence_smoke_on_the_cpu_from_the_jax_weights(
        jax_smoke_problems, quant):
    """From the JAX package's init: both problems learn, the quantized
    runs stay within the 0.25 envelope with the state cut >= 1.8x, the
    report has the JAX package's keys, and each run's first loss is the
    JAX loss function's on the same weights and batch (rounded to 4
    places, as both reports round it)."""
    weights = {n: p[3] for n, p in jax_smoke_problems.items()}
    report = tfo.convergence_smoke(quant, weights=weights, device="cpu")
    assert report.keys() == SMOKE_KEYS
    assert report["ok"] and report["world"] == 1 and report["quant"] == quant
    for name, (loss_fn, state, batch, _) in jax_smoke_problems.items():
        run = report[name]
        assert run.keys() == SMOKE_RUN_KEYS
        assert run["learned"] and run["within_envelope"]
        assert run["opt_bytes_dense"] >= 1.8 * run["opt_bytes_quant"]
        assert run["delta_rel"] <= 0.25
        want = float(loss_fn(state, state.params, batch)[0])
        assert abs(run["loss_initial"] - want) <= 1e-4, (name, want)


def test_convergence_smoke_asks_for_cuda_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tfo.convergence_smoke(steps=1)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tfo._main(["smoke", "--steps", "1"])


def test_opt_state_bytes_of_an_unfused_optimizer():
    p = torch.nn.Parameter(torch.zeros(10))
    opt = torch.optim.SGD([p], lr=0.1, momentum=0.9)
    assert tfo.opt_state_bytes(opt) == 0          # made at the first step
    p.grad = torch.ones(10)
    opt.step()
    assert tfo.opt_state_bytes(opt) == 40


def test_smoke_cli_on_the_cpu():
    """python -m edl_tpu_torch.train.fused_opt smoke --device cpu: the
    gate and the convergence smoke, one JSON line, exit 0."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.train.fused_opt", "smoke",
         "--device", "cpu", "--quant", "fp8"], capture_output=True,
        text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])["fused_opt_smoke"]
    assert report["ok"] and report["kernel_gate"]["ok"]
    assert report["convergence"]["quant"] == "fp8"
    assert report["convergence"].keys() == SMOKE_KEYS


def test_smoke_cli_exits_nonzero_when_a_gate_fails(monkeypatch, capsys):
    monkeypatch.setattr(tfo, "update_parity_gate",
                        lambda device: {"ok": False, "device": str(device)})
    monkeypatch.setattr(tfo, "convergence_smoke",
                        lambda **kw: {"ok": True, "steps": kw["steps"]})
    assert tfo._main(["smoke", "--device", "cpu"]) == 1
    line = capsys.readouterr().out.strip()
    assert '"fused_opt_smoke"' in line and '"ok": false' in line
