"""chip_smoke.py's build gate for the bf16 flash kernels (the forward K1
and the backward K2/K3), and its launch gates of the main paths, on the
CPU.

On a card the gate reads ptxas's log and the SASS of each built library
(cuobjdump) and fails unless each bf16 wgmma body holds wgmma (HGMMA) and
TMA loads (UTMALDG), spills nothing, and never writes a register that a
wgmma reads as its A operand before the product, or the next turn of its
loop, has read it. Its parsers are plain Python, so they are held here to
logs and SASS written by hand in the tools' formats (an HGMMA marked gsb0
closes a commit group, as in cuobjdump's output), including the
clobbering patterns the gate exists for.
"""

import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

K2 = ("_ZN45_GLOBAL__N__da1476e7_12_flash_bwd_cu_a119745d17dkdv_wgmma_kernel"
      "ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iifi")
K3 = ("_ZN45_GLOBAL__N__da1476e7_12_flash_bwd_cu_a119745d13dq_fma_kernel"
      "ILi128EEEvPKfS2_S2_S2_S2_S2_PfS3_iiNS_7StridesEfi")
K1 = ("_ZN45_GLOBAL__N__418534f1_12_flash_fwd_cu_71b00afc22flash_fwd_wgmma_"
      "kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiifi")


@pytest.mark.parametrize("mangled,name", [
    (K2, "dkdv_wgmma_kernel<64>"),
    (K3, "dq_fma_kernel<128>"),
    (K1, "flash_fwd_wgmma_kernel<64>"),
    ("_Z16adam_fp32_kernelPfS_", "adam_fp32_kernel"),
    ("_Z3foov", "_Z3foov"),
    # a kernel in a namespace nested in the file's anonymous one, with
    # int and bool template arguments (K6's passes)
    ("_ZN39_GLOBAL__N__3d1c2e41_7_sgdm_cu_8c1f2a122k613sgdm_q_kernel"
     "ILi2ELb1ELb0EEEvNS0_5TableENS_5HyperE", "sgdm_q_kernel<2,1,0>"),
    ("_ZN39_GLOBAL__N__0a1b2c3d_7_pack_cu_4e5f607111pack_kernelILb1ELb1EEEv"
     "NS_5TableE", "pack_kernel<1,1>"),
])
def test_kernel_name(mangled, name):
    assert cs.kernel_name(mangled) == name


def test_ptxas_kernels_reads_registers_and_spills_per_kernel():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{K2}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        f"ptxas info    : Compiling entry function '{K3}' for 'sm_90a'",
        "    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    assert cs.ptxas_kernels(log) == {
        "dkdv_wgmma_kernel<64>": {"spill_bytes": 0, "registers": 168},
        "dq_fma_kernel<128>": {"spill_bytes": 28, "registers": 128},
    }


def test_ptxas_kernels_reads_the_forward_s_wgmma_body():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{K1}' for 'sm_90a'",
        f"ptxas info    : Function properties for {K1}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
    ])
    assert cs.ptxas_kernels(log) == {
        "flash_fwd_wgmma_kernel<64>": {"spill_bytes": 0, "registers": 168}}


def _sass(body: list[str], mangled: str = K2) -> str:
    """cuobjdump's layout: a function header, then one instruction a line
    at 16-byte addresses, each followed by its encoding comment."""
    lines = [f"\t\tFunction : {mangled}"]
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     "   /* 0x000000000000 */")
        lines.append("                                            "
                     "/* 0x000000000000 */")
    return "\n".join(lines)


# A K2-like loop: the head at 0x10, the tile's first product (S) and, as
# the last group, its second product, which reads its A operand from
# R8..R11 and is covered by the wait in the next turn of the loop (one
# group, S, closes after it).
_LOOP = [
    "LDSM.16.M88.4 R20, [R1]",                                      # 0x00
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR9], R8",                 # 0x10 head
    "HGMMA.64x64x16.F32.BF16 R56, gdesc[UR16], RZ, !UPT, gsb0",     # 0x20
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",                                # 0x30
    "F2FP.BF16.F32.PACK_AB R8, R57, R56",                           # 0x40
    "HGMMA.64x64x16.F32.BF16 R88, R8, gdesc[UR8].tnspB, R88, gsb0", # 0x50
    "IADD3 R2, R2, 0x1, RZ",                                        # 0x60
    "@!P0 BRA 0x10",                                                # 0x70
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",                                # 0x80
    "EXIT",                                                         # 0x90
]

# K1's loop as ptxas builds it: this tile's S, then the last tile's
# O += P V (A operand R120..R123, made at the end of the last turn) as
# two groups; the softmax runs between the wait for S and the wait for
# P V; then the next turn's P is packed into R120.. and carried over the
# back edge.
_FWD_LOOP = [
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R21+UR9], R24",                # 0x00 head
    "WARPGROUP.ARRIVE",                                                  # 0x10
    "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT, gsb0",         # 0x20
    "HGMMA.64x64x16.F32.BF16 R88, R120, gdesc[UR20].tnspB, R88, gsb0",   # 0x30
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",                                     # 0x40
    "FMUL R29, R29, R9",                                                 # 0x50
    "MUFU.EX2 R30, R29",                                                 # 0x60
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",                                     # 0x70
    "FMUL R88, R88, R4",                                                 # 0x80
    "F2FP.BF16.F32.PACK_AB R120, R25, R24",                              # 0x90
    "F2FP.BF16.F32.PACK_AB R121, R27, R26",                              # 0xa0
    "@!P0 BRA 0x0",                                                      # 0xb0
    "EXIT",                                                              # 0xc0
]


def _hazards(body, mangled=K2, name="dkdv_wgmma_kernel<64>"):
    (got, ins), = cs.sass_functions(_sass(body, mangled)).items()
    assert got == name
    return cs.wgmma_a_hazards(ins)


def _fwd_hazards(body):
    return _hazards(body, K1, "flash_fwd_wgmma_kernel<64>")


def test_sass_functions_counts_instructions():
    (_, ins), = cs.sass_functions(_sass(_LOOP)).items()
    assert [a for a, _ in ins] == [16 * i for i in range(len(_LOOP))]
    assert sum("HGMMA" in t for _, t in ins) == 2


def test_no_hazard_when_the_operand_is_written_before_its_product():
    assert _hazards(_LOOP) == []


def test_write_after_issue_and_before_the_wait_is_a_hazard():
    """The A operand R8..R11 is overwritten after its product is issued,
    before the wait that covers it (at the loop head's next turn)."""
    body = list(_LOOP)
    body[6] = "IADD3 R9, R2, 0x1, RZ"
    assert _hazards(body) == [("0x60", "IADD3 R9, R2, 0x1, RZ")]


def test_loop_invariant_operand_written_in_the_loop_is_a_hazard():
    """The pattern ptxas produced: an A operand loaded once before the
    loop (R20, by ldmatrix) and overwritten later in the loop, so the next
    turn's product reads another value."""
    body = list(_LOOP)
    body[2] = "HGMMA.64x64x16.F32.BF16 R56, R20, gdesc[UR16], RZ, !UPT, gsb0"
    body[4] = "F2FP.BF16.F32.PACK_AB R20, R57, R56"
    body[5] = "HGMMA.64x64x16.F32.BF16 R88, R20, gdesc[UR8].tnspB, R88, gsb0"
    assert _hazards(body) == [("0x40", "F2FP.BF16.F32.PACK_AB R20, R57, R56")]


def test_pipelined_operand_made_for_the_next_turn_is_no_hazard():
    """K1's P, packed after the wait that covers the product reading it
    and carried unread over the back edge, is the next turn's operand."""
    (_, ins), = cs.sass_functions(_sass(_FWD_LOOP, K1)).items()
    assert sum("HGMMA" in t for _, t in ins) == 2
    assert _fwd_hazards(_FWD_LOOP) == []


def test_write_while_the_later_group_runs_is_a_hazard():
    """The wait for S (LE 0x1) does not cover O += P V, committed after
    it: a softmax write into R121 before the wait for P V (LE 0x0)
    clobbers the operand in flight. A first-wait rule would miss it."""
    body = list(_FWD_LOOP)
    body[5] = "FMUL R121, R29, R9"
    assert _fwd_hazards(body) == [("0x50", "FMUL R121, R29, R9")]


def test_pipelined_operand_read_before_the_back_edge_is_a_hazard():
    """A value packed into R120 and read by something else before the
    back edge was made for another use: the next turn's product would
    read it as its operand."""
    body = list(_FWD_LOOP)
    body[10] = "FADD R5, R120, R3"
    assert _fwd_hazards(body) == [
        ("0x90", "F2FP.BF16.F32.PACK_AB R120, R25, R24")]


def test_operand_register_reused_after_its_wait_then_rewritten_is_no_hazard():
    """ptxas borrows R120 for a barrier's address once the wait for
    O += P V (LE 0x0) has returned, then packs the next turn's P into it:
    the value the next turn reads is the last one, unread before the back
    edge."""
    body = list(_FWD_LOOP)
    body[8] = "@!P0 IMAD R120, R176, 0x8, R183"
    body[9] = "@!P0 SYNCS.ARRIVE.TRANS64.A1T0 RZ, [R120+URZ], RZ"
    body.insert(10, "F2FP.BF16.F32.PACK_AB R120, R25, R24")
    body[-2] = "@!P0 BRA 0x0"
    assert _fwd_hazards(body) == []
    # the same borrowing before that wait clobbers the operand in flight
    early = list(body)
    early[5], early[8] = early[8], early[5]
    assert _fwd_hazards(early) == [("0x50", "@!P0 IMAD R120, R176, 0x8, R183")]


def test_sass_operands_split_the_destination_from_the_sources():
    assert cs.sass_operands("F2FP.BF16.F32.PACK_AB R120, R25, R24") == (
        "R120", ["R25", "R24"])
    assert cs.sass_operands("@!P0 IADD3 R9, R2, 0x1, RZ") == ("R9", ["R2"])
    assert cs.sass_operands(
        "HGMMA.64x64x16.F32.BF16 R88, R120, gdesc[UR20].tnspB, R88, gsb0"
    ) == (None, ["R88", "R120", "R88"])
    assert cs.sass_operands("STS.128 [R3], R8") == (None, ["R3", "R8"])
    assert cs.sass_operands("SHFL.BFLY PT, R121, R4, 0x1, 0x1f") == (
        "R121", ["R4"])
    assert cs.sass_operands("ISETP.GE.AND P0, PT, R2, R3, PT") == (
        None, ["R2", "R3"])
    assert cs.FLASH_LIBS == ("flash_fwd", "flash_bwd")


def test_bwd_tflops_counts_the_visible_pairs():
    # B=1, H=1, S=4, D=64, causal: 10 visible pairs; 4 products of
    # 2 * 64 flops a pair in 1 ms is 5.12e6 flop/s
    assert cs.bwd_tflops(4, 1.0, 1, 4, 1, 64, True) == pytest.approx(5.12e-6)
    assert cs.bwd_tflops(4, 1.0, 1, 4, 1, 64, False) == pytest.approx(8.192e-6)
    # the products each backward computes, as bound and TFLOP/s count them
    assert cs.BWD_PRODUCTS == {"flash_bwd_dkdv": 4, "flash_bwd_dq": 5,
                               "sdpa_bwd": 5}


# -- the launch gates --------------------------------------------------------


def test_resnet_runs_want_one_optimizer_call_a_step():
    """imagenet_train on one card: one K4 launch a step (fp32 momentum)
    or one K6 entry call a step (int8), whatever the bucket count, and no
    other counted launch."""
    counters = {"sgdm_fp32": None, "sgdm_q": None}
    assert cs.resnet_want(counters, "sgdm_fp32") == {"sgdm_fp32": 1,
                                                     "sgdm_q": 0}
    assert cs.resnet_want(counters, "sgdm_q") == {"sgdm_fp32": 0,
                                                  "sgdm_q": 1}


def _rank(rank: int, launches: dict, steps: int) -> dict:
    step = {"ms": 100.0, "reduce_ms": 60.0, "reduce_extra_bytes": 2**20,
            "launches": launches}
    losses = np.linspace(7.0, 6.0, steps)
    return {"rank": rank, "rc": 0, "digest": "d" * 64, "wall_s": 1.0,
            "peak_gib": 1.5 + rank,
            "steps": [dict(step, loss=float(x)) for x in losses],
            "launches": {n: v * steps for n, v in launches.items()},
            "comm_buckets": 24, "compressed_buckets": 24, "opt_buckets": 24,
            "stats": {}, "topology": [2, 1], "fp32_leg_bytes": 1}


@pytest.mark.parametrize("name", ["int8", "dense"])
def test_world_runs_want_one_pack_call_a_step_a_rank(name, tmp_path,
                                                     capsys):
    """The world runs: one K8 call a step a rank over every compressed
    bucket in the int8 run (none dense), one K4 a step; a rank that
    launched K8 once per compressed bucket fails the run."""
    want = cs.world_want(name)
    assert want == {"pack_int8": int(name == "int8"), "sgdm_fp32": 1}
    (tmp_path / "log_0.json").write_text(json.dumps({"final": {}}))
    steps = 3 * cs.RESNET_STEPS_PER_EPOCH
    out = cs.world_summary(name, [_rank(r, want, steps) for r in range(2)],
                           tmp_path)
    assert out["launches_per_step_per_rank"] == want
    assert out["peak_gib"] == [1.5, 2.5]
    assert out["reduce_extra_mib_max"] == 1.0
    assert out["launches"]["pack_int8"] == 2 * steps * int(name == "int8")
    per_bucket = dict(want, pack_int8=24 if name == "int8" else 1)
    with pytest.raises(SystemExit):
        cs.world_summary(name, [_rank(r, per_bucket, steps)
                                for r in range(2)], tmp_path)
    assert "launched" in capsys.readouterr().err


# -- the resume phase --------------------------------------------------------


def test_the_resume_phase_is_documented_and_run():
    """Phase 10 is in the module docstring and main() drives it, after
    the world runs, with every earlier phase."""
    import ast
    import inspect

    assert "10. resume" in cs.__doc__
    calls = [n.func.id for n in ast.walk(ast.parse(inspect.getsource(
        cs.main))) if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Name)]
    assert calls.index("phase_resume") > calls.index(
        "phase_train_resnet_world") > calls.index("phase_train_resnet")
    argv = cs.RESUME_ARGV
    assert "--no-augment" not in argv
    for flag, value in (("--data-format", "packed"),
                        ("--augment-device", "1")):
        assert argv[argv.index(flag) + 1] == value
    for flag in ("--model", "--image-size", "--num-classes", "--batch-size"):
        assert argv[argv.index(flag) + 1] == \
            cs.RESNET_ARGV[cs.RESNET_ARGV.index(flag) + 1]


@pytest.mark.parametrize("cores,want", [(8, 7), (32, 8), (2, 1), (1, 1)])
def test_resume_loader_workers(cores, want):
    assert cs.loader_workers(cores) == want


def test_tree_mismatches_and_opt_bytes():
    from edl_tpu_torch import bridge

    q = bridge.QPlaneTree(np.zeros(8, np.int8), np.float32(1),
                          np.zeros(8, np.int8), np.float32(2))
    a = bridge.TrainStateTree(np.asarray(3, np.int32),
                              {"w": np.ones(4, np.float32)},
                              bridge.FusedOptTree(np.asarray(3, np.int32),
                                                  (q,), ()), None)
    assert cs.tree_mismatches(a, a) == []
    b = a._replace(params={"w": -np.zeros(4, np.float32) + 1})
    assert cs.tree_mismatches(a, b) == []
    c = a._replace(params={"w": np.array([1, 1, 1, -0.0 + 1.5],
                                         np.float32)})
    assert cs.tree_mismatches(a, c) == [".params['w']"]
    d = a._replace(params={"w": np.ones(4, np.float64)})
    assert cs.tree_mismatches(a, d) == [".params['w']"]
    assert cs.opt_bytes(a) == 4 + 8 + 4 + 8 + 4


def test_version_at_reads_meta(tmp_path):
    for v, step in ((3, 15), (4, 20)):
        d = tmp_path / f"ckpt-{v}"
        d.mkdir()
        (d / "meta.json").write_text(json.dumps(
            {"version": v, "status": {"step": step}}))
    (tmp_path / ".tmp-ckpt-x").mkdir()
    assert cs.version_at(str(tmp_path), 15) == 3
    assert cs.version_at(str(tmp_path), 5) is None


# -- the fp16 bodies ---------------------------------------------------------

K1_F16 = ("_ZN45_GLOBAL__N__418534f1_12_flash_fwd_cu_71b00afc22flash_fwd_"
          "wgmma_kernelI6__halfLi128EEEv14CUtensorMap_stS2_S2_PT_Pfiiifi")
K1_BF16 = ("_ZN45_GLOBAL__N__418534f1_12_flash_fwd_cu_71b00afc22flash_fwd_"
           "wgmma_kernelI13__nv_bfloat16Li64EEEv14CUtensorMap_stS2_S2_PT_"
           "Pfiiifi")
K2_F16 = ("_ZN45_GLOBAL__N__da1476e7_12_flash_bwd_cu_a119745d17dkdv_wgmma_"
          "kernelI6__halfLi64EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PT_S6_iifi")


@pytest.mark.parametrize("mangled,name", [
    (K1_F16, "flash_fwd_wgmma_kernel<__half,128>"),
    (K1_BF16, "flash_fwd_wgmma_kernel<__nv_bfloat16,64>"),
    (K2_F16, "dkdv_wgmma_kernel<__half,64>"),
    # a truncated argument list keeps the plain name
    ("_ZN1a6kernelI", "kernel"),
    ("_ZN1a6kernelI6__hal", "kernel"),
])
def test_kernel_name_of_a_type_template(mangled, name):
    assert cs.kernel_name(mangled) == name


# A wgmma loop of each body: the tile's product, its wait, the pack of
# the next A operand (fp16 or bf16) and its product, a TMA load.
def _body(pack="F2FP.F16.F32.PACK_AB"):
    return ["UTMALDG.4D [UR8], [UR14]",
            "HGMMA.64x64x16.F32 R56, gdesc[UR16], RZ, !UPT, gsb0",
            "WARPGROUP.DEPBAR.LE gsb0, 0x0",
            f"{pack} R8, R57, R56",
            "HGMMA.64x64x16.F32 R88, R8, gdesc[UR8].tnspB, R88, gsb0",
            "WARPGROUP.DEPBAR.LE gsb0, 0x0",
            "EXIT"]


def _ptxas(*mangled, spill=0):
    return "\n".join(
        line for m in mangled for line in (
            f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'",
            f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes "
            "spill loads", "ptxas info    : Used 168 registers"))


class _FakeBuild:
    def __init__(self, tmp_path):
        self.tmp = tmp_path

    def nvcc(self):
        return str(self.tmp / "nvcc")

    def library_path(self, name):
        return self.tmp / f"lib{name}.so"


def _flash_build(monkeypatch, tmp_path, functions: dict, spill=0):
    """flash_build on canned SASS: each library of FLASH_LIBS holds
    ``functions`` ({mangled: body})."""
    sass = "\n".join(_sass(body, m) for m, body in functions.items())
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **kw:
                        type("Out", (), {"stdout": sass})())
    logs = {lib: _ptxas(*functions, spill=spill) for lib in cs.FLASH_LIBS}
    return cs.flash_build(_FakeBuild(tmp_path), logs)


def test_flash_build_passes_with_both_types(monkeypatch, tmp_path, capsys):
    reports = _flash_build(monkeypatch, tmp_path, {
        K1_F16: _body(), K1_BF16: _body("F2FP.BF16.F32.PACK_AB")})
    for lib in cs.FLASH_LIBS:
        assert reports[lib]["ok"]
        assert reports[lib]["types"] == ["__half", "__nv_bfloat16"]
        k = reports[lib]["kernels"]["flash_fwd_wgmma_kernel<__half,128>"]
        assert k["HGMMA"] == 2 and k["UTMALDG"] == 1
        assert k["a_operand_hazards"] == [] and k["spill_bytes"] == 0


@pytest.mark.parametrize("case", ["bf16_only", "fp16_hazard", "fp16_spill",
                                  "fp16_no_tma"])
def test_flash_build_fails_without_a_sound_fp16_body(monkeypatch, tmp_path,
                                                     capsys, case):
    """No fp16 instantiation, or an fp16 body that writes its wgmma's A
    operand while the product runs, spills, or holds no TMA load: the
    build phase fails, as it does for a bf16 body."""
    body = _body()
    if case == "fp16_hazard":      # R9 written while the product reads it
        body.insert(5, "IADD3 R9, R2, 0x1, RZ")
    if case == "fp16_no_tma":
        body = body[1:]
    functions = ({K1_BF16: _body("F2FP.BF16.F32.PACK_AB")}
                 if case == "bf16_only"
                 else {K1_F16: body, K1_BF16: _body("F2FP.BF16.F32.PACK_AB")})
    with pytest.raises(SystemExit):
        _flash_build(monkeypatch, tmp_path, functions,
                     spill=8 if case == "fp16_spill" else 0)
    assert "16-bit flash bodies" in capsys.readouterr().err


# -- the LM runs of this slice -----------------------------------------------


def test_lm_want_counts_each_run_s_launches():
    from edl_tpu_torch.ops import opt_kernels

    base = {"flash_fwd": 8, "flash_bwd_dkdv": 8, "flash_bwd_dq": 8}
    assert cs.lm_want(opt_kernels, 60) == {**base, "adam_fp32": 1,
                                           "adam_q": 0}
    assert cs.lm_want(opt_kernels, 60, quant=True) == {
        **base, "adam_fp32": 0, "adam_q": 1}
    # remat: each block's forward again in the backward
    assert cs.lm_want(opt_kernels, 60, k1=16)["flash_fwd"] == 16
    # a skipped fp16 step launches the flash kernels and no optimizer
    assert cs.lm_want(opt_kernels, 60, optimizer=False) == {
        **base, "adam_fp32": 0, "adam_q": 0}
    many = opt_kernels.ADAM_TABLE_MAX + 1
    assert cs.lm_want(opt_kernels, many)["adam_fp32"] == 2


def test_the_new_lm_runs_take_the_train_phase_s_argv():
    from edl_tpu_torch.examples import lm_train

    for argv, flags in ((cs.TRAIN_FP16_ARGV, ["--fp16"]),
                        (cs.TRAIN_FUSED_LOSS_ARGV, ["--bf16",
                                                    "--fused-loss"]),
                        (cs.TRAIN_REMAT_ARGV, ["--bf16", "--remat", "on"])):
        assert [a for a in argv if a not in flags] == [
            a for a in cs.TRAIN_ARGV if a != "--bf16"]
        assert all(f in argv for f in flags)
        assert argv[argv.index("--fused-opt") + 1] == "fp32"
    assert "--bf16" not in cs.TRAIN_FP16_ARGV
    # every flag is one lm_train takes (the parser errors otherwise)
    with pytest.raises(SystemExit, match="0"):
        lm_train.main(["--data-dir", "x", *cs.TRAIN_FP16_ARGV,
                       "--fused-loss", "--remat", "auto", "--help"])


def test_the_new_phases_are_documented_and_run():
    """Phases 11-14 are in the module docstring; main() drives them after
    every earlier phase, from the train phase's result."""
    import ast
    import inspect

    for phase in ("11. train_fp16", "12. train_fused_loss",
                  "13. train_remat", "14. fused_opt_smoke"):
        assert phase in cs.__doc__
    line = {n.func.id: n.lineno for n in ast.walk(ast.parse(
        inspect.getsource(cs.main))) if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Name)}
    order = [line[f] for f in (
        "phase_train", "phase_train_int8", "phase_resume",
        "phase_train_fp16", "phase_train_fused_loss", "phase_train_remat",
        "phase_fused_opt_smoke")]
    assert order == sorted(order)
    assert cs.FLASH_KERNELS == ("flash_fwd", "flash_bwd_dkdv",
                                "flash_bwd_dq")
    assert cs.WGMMA_TYPES == ("__nv_bfloat16", "__half")
    assert cs.ATOL[torch.float16] == cs.ATOL[torch.bfloat16]


# -- the elastic phase --------------------------------------------------------

def test_the_elastic_worker_s_argv():
    """Every generation runs imagenet_train at RESNET_ARGV's model, size,
    classes and batch (64 images a rank at world 2) for ELASTIC_EPOCHS,
    with K4 (--fused-opt fp32), the int8 wire and the shared checkpoint
    dir; the flags are imagenet_train's."""
    from edl_tpu_torch.examples import imagenet_train

    argv = cs.elastic_argv("D", "C")
    for flag, value in (("--data-dir", "D"), ("--ckpt-dir", "C"),
                        ("--fused-opt", "fp32"), ("--dcn-compress", "int8"),
                        ("--epochs", str(cs.ELASTIC_EPOCHS)),
                        ("--batch-size", "128")):
        assert argv[argv.index(flag) + 1] == value
    for flag in ("--model", "--image-size", "--num-classes", "--bf16"):
        i = cs.RESNET_ARGV.index(flag)
        assert argv[argv.index(flag):argv.index(flag) + 2] == \
            cs.RESNET_ARGV[i:i + 2]
    assert "--make-synthetic" not in argv
    args = imagenet_train._parser().parse_args(argv)
    assert args.model == "ResNet50_vd" and args.batch_size // 2 == 64
    assert cs.ELASTIC_ENV["EDL_TPU_RESIZE_P2P"] == "0"
    assert cs.ELASTIC_WORLDS == [2, 1, 2]
    live = cs.ELASTIC_LIVE_ENV
    assert live["EDL_TPU_RESIZE_P2P"] == "1"
    assert {k: v for k, v in live.items() if k in cs.ELASTIC_ENV
            and k != "EDL_TPU_RESIZE_P2P"} == {
        k: v for k, v in cs.ELASTIC_ENV.items() if k != "EDL_TPU_RESIZE_P2P"}
    # longer than a generation's start on the card (PERF.md: 13.6-15.6 s)
    for knob in ("EDL_TPU_DONOR_LINGER", "EDL_TPU_ADOPT_TIMEOUT",
                 "EDL_TPU_REFORM_MESH_S"):
        assert float(live[knob]) >= 60


# the pods of a 2 -> 1 -> 2 job: the leaver holds rank 0 of v1, the
# survivor rank 1 of v1, rank 0 of v2 and rank 1 of v3, the newcomer
# rank 0 of v3
PODS = {(1, 0): "podA", (1, 1): "podB", (2, 0): "podB", (3, 0): "podC",
        (3, 1): "podB"}


def _gen_records(worlds=(2, 1, 2), epochs=((0,), (1,), (2,)),
                 first_losses=(6.9, 6.0, 5.0)):
    """Worker records of a 2 -> 1 -> 2 job (versions 1, 2, 3), rank 0's
    sealed epochs as given, three steps a rank with elastic_want's
    launches; the survivor's v3 record its v2 trainer's, adopted."""
    recs = []
    for v, (world, eps, loss) in enumerate(zip(worlds, epochs,
                                               first_losses), start=1):
        for rank in range(world):
            steps = [{"ms": 150.0 + i, "loss": loss - 0.1 * i,
                      "launches": cs.elastic_want(world)} for i in range(3)]
            pod = PODS.get((v, rank), f"pod{v}{rank}")
            recs.append({"version": v, "rank": rank, "world": world,
                         "pod": pod, "pid": 1000 * v + rank,
                         "adopted": False, "first_sha256": f"h{v}",
                         "epochs": list(eps), "steps": steps,
                         "t_first_step": 100.0 * v})
    survivor = [r for r in recs if r["pod"] == "podB"]
    survivor[-1].update(pid=survivor[-2]["pid"], adopted=True)
    return recs


DOCS = [(1, 2), (2, 1), (3, 2)]


def test_elastic_gates_pass_a_two_one_two_job():
    gens = cs.elastic_gates(_gen_records(), DOCS)
    assert [g["world"] for g in gens] == [2, 1, 2]
    summary = cs.generation_summary(gens[0])
    assert summary["launches"] == {"sgdm_fp32": 6, "pack_int8": 6}
    assert summary["step_ms_median"] == 151.5
    assert cs.generation_summary(gens[1])["launches"] == {
        "sgdm_fp32": 3, "pack_int8": 0}
    assert cs.elastic_want(1) == {"sgdm_fp32": 1, "pack_int8": 0}


@pytest.mark.parametrize("case", [
    "repeated_epoch", "missing_epoch", "restarted", "worlds",
    "falling_version", "k8_in_world_of_one", "no_k8", "lost_rank",
    "nan", "empty_generation"])
def test_elastic_gates_fail(case, capsys):
    recs, docs = _gen_records(), list(DOCS)
    if case == "repeated_epoch":
        recs = _gen_records(epochs=((0,), (0, 1), (2,)))
    elif case == "missing_epoch":
        recs = _gen_records(epochs=((0,), (2,), (2,)))
    elif case == "restarted":          # the last generation began afresh
        recs = _gen_records(first_losses=(6.9, 6.0, 6.95))
    elif case == "worlds":
        recs = _gen_records(worlds=(2, 2, 2))
        docs = [(1, 2), (2, 2), (3, 2)]
    elif case == "falling_version":
        docs = [(3, 2), (2, 1), (1, 2)]
    elif case == "k8_in_world_of_one":
        recs[2]["steps"][1]["launches"] = cs.elastic_want(2)
    elif case == "no_k8":
        recs[0]["steps"][2]["launches"] = cs.elastic_want(1)
    elif case == "lost_rank":
        recs = [r for r in recs if not (r["version"] == 3
                                        and r["rank"] == 1)]
    elif case == "nan":
        recs[4]["steps"][0]["loss"] = float("nan")
    elif case == "empty_generation":
        recs = _gen_records(epochs=((0, 1), (), (2,)))
    with pytest.raises(SystemExit):
        cs.elastic_gates(recs, docs)
    assert "elastic" in capsys.readouterr().err


def test_the_elastic_phase_is_documented_and_run():
    """Phases 15 and 16 are in the docstring; main() drives them last, in
    that order, on one data dir, before the kernels line, whose paths
    gain ``elastic`` and ``elastic_live``; the script re-enters itself as
    the launchers' trainer, under the port's store server."""
    import ast
    import inspect

    assert "15. elastic" in cs.__doc__ and "16. elastic_live" in cs.__doc__
    src = inspect.getsource(cs.main)
    calls = [n.func.id for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert calls.index("phase_elastic") > calls.index(
        "phase_fused_opt_smoke")
    assert calls.index("phase_elastic_live") > calls.index("phase_elastic")
    assert src.index("phase_elastic_live(") < src.index('"kernels": kernels')
    main_src = Path(cs.__file__).read_text()
    assert '["--elastic-worker"]' in main_src
    assert "edl_tpu_torch.coord.server" in inspect.getsource(cs.ElasticJob.__init__)
    for phase in (cs.phase_elastic, cs.phase_elastic_live):
        assert "ElasticJob(" in inspect.getsource(phase)
    assert "edl_tpu.coord" not in main_src


def test_the_elastic_job_id_is_this_run_s_alone():
    """The phase finds and kills its processes by their job id, so the id
    names this process and is new on every call: two runs on one host
    never match each other's processes."""
    import inspect
    import os

    a, b = cs.elastic_job_id(), cs.elastic_job_id("solo")
    assert a.startswith(f"chip-elastic-{os.getpid()}-")
    assert b.startswith(f"solo-{os.getpid()}-") and a != cs.elastic_job_id()
    src = inspect.getsource(cs.ElasticJob.__init__)
    assert "self.job = elastic_job_id()" in src and "chip-elastic" not in src
    assert cs.pids_with_env(EDL_TPU_JOB_ID=a) == []


# -- phase 16: elastic_live's gates on fake records ----------------------------

DOCS_LIVE = [(1, 2), (2, 1), (3, 2)]


def _live_inputs():
    """A passing 2 -> 1 -> 2 live job: records, the survivor's adoption
    ack and the two peer restores' acks, the donors' adverts."""
    recs = _gen_records()
    reform = {"generation": 3, "result": "in-place", "restore": "peers",
              "error": None, "phases": [{"phase": p, "s": 0.5, "ok": True}
                                        for p in cs.REFORM_PHASES]}
    acks = [{"pod_id": "podB", "mode": "peers", "generation": 2,
             "version": 4, "pid": 2000, "bytes_from_peers": 205_000_000,
             "restore_s": 0.4, "ts": 1.0},
            {"pod_id": "podB", "mode": "adopted", "generation": 3,
             "version": None, "pid": 2000, "bytes_from_peers": 205_000_000,
             "downtime_s": 16.0, "reform": reform, "ts": 2.0},
            {"pod_id": "podC", "mode": "peers", "generation": 3,
             "version": 7, "pid": 3000, "bytes_from_peers": 205_000_000,
             "restore_s": 0.5, "ts": 2.1}]
    adverts = [{"pod_id": "podA", "version": 4, "nbytes": 205_000_000},
               {"pod_id": "podB", "version": 7, "nbytes": 205_000_000}]
    for r in recs:
        if r["version"] == 3:
            r["first_sha256"] = "same"
    return recs, acks, adverts


def test_elastic_live_gates_pass_an_in_place_grow():
    recs, acks, adverts = _live_inputs()
    facts = cs.elastic_live_gates(recs, DOCS_LIVE, acks, adverts, "podB")
    assert facts["adopted"]["pid"] == 2000
    assert [a["pod_id"] for a in facts["peers"]] == ["podB", "podC"]
    assert facts["params_sha256"] == "same"
    assert [g["version"] for g in facts["generations"]] == [1, 2, 3]


@pytest.mark.parametrize("case", [
    "respawned", "not_adopted", "no_adoption_ack", "stale_adoption_ack",
    "adoption_by_another_pid", "downgraded", "phase_order", "no_peers",
    "short_transfer", "empty_transfer", "params_differ", "elastic_gate"])
def test_elastic_live_gates_fail(case, capsys):
    recs, acks, adverts = _live_inputs()
    grown = next(r for r in recs if r["version"] == 3 and r["pod"] == "podB")
    if case == "respawned":           # a new process took the grown world
        grown["pid"] = 4242
    elif case == "not_adopted":
        grown["adopted"] = False
    elif case == "no_adoption_ack":
        acks = [a for a in acks if a["mode"] != "adopted"]
    elif case == "stale_adoption_ack":
        acks[1]["generation"] = 2
    elif case == "adoption_by_another_pid":
        acks[1]["pid"] = 4242
    elif case == "downgraded":
        acks[1]["reform"]["result"] = "stop-resume"
    elif case == "phase_order":
        acks[1]["reform"]["phases"].reverse()
    elif case == "no_peers":
        acks = [a for a in acks if a["mode"] != "peers"]
    elif case == "short_transfer":
        acks[2]["bytes_from_peers"] -= 4
    elif case == "empty_transfer":
        for a in acks:
            a["bytes_from_peers"] = 0
        for a in adverts:
            a["nbytes"] = 0
    elif case == "params_differ":
        next(r for r in recs if r["version"] == 3
             and r["rank"] == 0)["first_sha256"] = "other"
    elif case == "elastic_gate":      # phase 15's gates run first
        recs[2]["steps"][1]["launches"] = cs.elastic_want(2)
    with pytest.raises(SystemExit):
        cs.elastic_live_gates(recs, DOCS_LIVE, acks, adverts, "podB")
    assert "elastic" in capsys.readouterr().err


# -- phases 17 and 18: the world step on the card, on fake records -----------


def _lm_rank(rank: int, name: str, buckets: int = 60, digest: str = "d" * 64,
             param_elems: int = cs.BASE_LM_ELEMS, losses=None) -> dict:
    from edl_tpu_torch.ops import opt_kernels as ok_mod
    want = {**cs.lm_want(ok_mod, buckets), "pack_int8": int(name == "int8")}
    losses = (np.linspace(10.4, 9.0, cs.LM_WORLD_STEPS) if losses is None
              else losses)
    return {"rank": rank, "rc": 0, "wall_s": 30.0, "peak_gib": 20.0,
            "steps": [{"ms": 900.0, "reduce_ms": 400.0, "launches": want,
                       "loss": float(x)} for x in losses],
            "launches": {n: v * cs.LM_WORLD_STEPS for n, v in want.items()},
            "digest": digest, "param_elems": param_elems,
            "moment_elems": param_elems + 64, "buckets": buckets}


def _lm_runs(capsys=None, **override) -> dict:
    from edl_tpu_torch.ops import opt_kernels as ok_mod
    half = cs.BASE_LM_REPLICATED + cs.BASE_LM_SHARDED // 2
    runs = {}
    for name in ("dp", "fsdp", "int8"):
        kw = {"param_elems": half} if name == "fsdp" else {}
        kw.update(override.get(name, {}))
        runs[name] = cs.lm_world_summary(
            name, [_lm_rank(r, name, **kw) for r in range(2)], ok_mod)
    return runs


def test_the_lm_world_runs_take_the_base_config():
    argv = cs.LM_WORLD_ARGV
    for flag, value in (("--vocab", "32768"), ("--d-model", "1024"),
                        ("--n-heads", "16"), ("--n-layers", "8"),
                        ("--d-ff", "4096"), ("--seq-len", "1024"),
                        ("--batch-size", "16"), ("--fused-opt", "fp32")):
        assert argv[argv.index(flag) + 1] == value
    assert "--bf16" in argv
    # 160 rows of 16 a step: the epoch is LM_WORLD_STEPS steps
    assert int(argv[argv.index("--rows-per-file") + 1]) // 16 == \
        cs.LM_WORLD_STEPS
    runs = dict(cs.LM_WORLD_RUNS)
    assert runs["fsdp"] == ["--mesh", "fsdp", "--ckpt-sharded"]
    assert runs["int8"][-4:] == ["--dcn-compress", "int8",
                                 "--comm-bucket-mb", "4"]
    assert cs.BASE_LM_REPLICATED + cs.BASE_LM_SHARDED == cs.BASE_LM_ELEMS


def test_k8_is_held_at_the_lm_comm_plan_s_shapes():
    """The kernels phase packs every compressed bucket of the base LM's
    comm plan at world 2, each alone and as one table, and counts
    them."""
    import inspect
    src = inspect.getsource(cs.phase_kernels_pack)
    assert "lm_comm_buckets(gen)" in src
    assert 'pack_bitwise(pack_mod, f"base LM bucket {i}", buf)' in src
    assert "pack_table_bitwise(pack_mod, \"the base LM's" in src
    lm = inspect.getsource(cs.lm_comm_buckets)
    assert "plan_buckets([p for _, p in named], 4.0, align=world)" in lm
    assert "_needs_residual(b, 1, world, config)" in lm


def test_the_world_worker_runs_each_phase_s_rank():
    import inspect
    src = inspect.getsource(cs.world_worker)
    for fn in ("lm_world_train(**", "spmd_world_train(", "world_train(",
               "world_gate("):
        assert fn in src
    assert "lm_world_restore(restore_from)" in inspect.getsource(
        cs.lm_world_train)


def test_lm_world_gates_pass(capsys):
    runs = _lm_runs()
    out = cs.lm_world_gates(runs, [{"digest": "d" * 64, "step": 10,
                                    "restore_s": 1.0}] * 2,
                            {"digest": "d" * 64, "step": 10,
                             "restore_s": 2.0})
    assert out["fsdp_losses_bitwise_dp"]
    assert round(out["fsdp_share"], 4) == 0.5995
    assert runs["int8"]["launches_per_step_per_rank"]["pack_int8"] == 1


@pytest.mark.parametrize("case", [
    "launch", "ranks_differ", "rising", "fsdp_loss", "elems", "restore",
    "int8_envelope"])
def test_lm_world_gates_fail(case, capsys):
    from edl_tpu_torch.ops import opt_kernels as ok_mod
    restored = [{"digest": "d" * 64, "step": 10, "restore_s": 1.0}] * 2
    one = {"digest": "d" * 64, "step": 10, "restore_s": 1.0}
    with pytest.raises(SystemExit):
        if case == "launch":
            ranks = [_lm_rank(r, "dp") for r in range(2)]
            ranks[1]["steps"][3]["launches"] = dict(
                ranks[1]["steps"][3]["launches"], flash_fwd=7)
            cs.lm_world_summary("dp", ranks, ok_mod)
        elif case == "ranks_differ":
            cs.lm_world_summary("dp", [_lm_rank(0, "dp"),
                                       _lm_rank(1, "dp", digest="e" * 64)],
                                ok_mod)
        elif case == "rising":
            cs.lm_world_summary("dp", [_lm_rank(
                r, "dp", losses=np.linspace(9.0, 10.0, 10))
                for r in range(2)], ok_mod)
        elif case == "fsdp_loss":
            runs = _lm_runs(fsdp={"losses": np.linspace(10.5, 9.1, 10)})
            cs.lm_world_gates(runs, restored, one)
        elif case == "elems":
            runs = _lm_runs(fsdp={"param_elems": cs.BASE_LM_ELEMS})
            cs.lm_world_gates(runs, restored, one)
        elif case == "restore":
            cs.lm_world_gates(_lm_runs(), restored,
                              dict(one, digest="e" * 64))
        else:
            runs = _lm_runs(int8={"losses": np.linspace(10.4, 10.2, 10)})
            cs.lm_world_gates(runs, restored, one)
    assert "lm_world" in capsys.readouterr().err


def _spmd_rank(rank: int, name: str, losses=None, digest="d" * 64,
               ratio=0.0101) -> dict:
    want = {"sgdm_fp32": int(name == "spmd"), "pack_int8": 0}
    n = 2 * cs.RESNET_STEPS_PER_EPOCH if name == "spmd" \
        else cs.RESNET_STEPS_PER_EPOCH
    losses = np.linspace(7.0, 6.5, n) if losses is None else losses
    return {"rank": rank, "rc": 0, "wall_s": 20.0, "peak_gib": 12.0,
            "fp32_loss": 7.0 if name == "spmd" else None,
            "steps": [{"ms": 300.0, "reduce_ms": 100.0, "launches": want,
                       "loss": float(x)} for x in losses],
            "launches": {k: v * n for k, v in want.items()},
            "digest": digest,
            "dgc_ratio": ratio if name == "spmd_dgc" else None}


def test_the_spmd_runs_take_no_comm_flag():
    for _, flags in cs.SPMD_RUNS:
        assert "--dcn-compress" not in flags
        assert "--comm-bucket-mb" not in flags
    runs = dict(cs.SPMD_RUNS)
    assert "--fused-opt" not in runs["spmd_dgc"]
    assert runs["spmd_dgc"][:4] == ["--dgc-sparsity", "0.99",
                                    "--dgc-rampup-epochs", "0"]


def _world_of_one(**grad_rel) -> dict:
    """resnet_world_of_one's numbers for a sound world: its loss 7.0, the
    per-rank statistics' control 1e-4 away, the gradients' distances."""
    return {"loss": 7.0, "local_stats_loss": 7.0007, "fp32_loss": 7.0,
            "fp32_local_stats_loss": 7.0007,
            "grad_rel": {"world": 8e-4, "local_stats": 0.07,
                         "local_backward": 0.7,
                         "native_convolutions": 8e-4, **grad_rel},
            "grad_elems": 25_600_000}


def test_spmd_gates_pass(capsys):
    results = {n: cs.spmd_summary(n, [_spmd_rank(r, n) for r in range(2)])
               for n in ("spmd", "spmd_dgc")}
    cs.spmd_gates(results, _world_of_one())
    assert results["spmd"]["launches"] == {"sgdm_fp32": 40, "pack_int8": 0}
    gates = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert gates["fp32_first_grads_rel"]["local_backward"] == 0.7
    assert gates["fp32_first_loss"] == {"world": 7.0, "world_of_one": 7.0,
                                        "local_stats": 7.0007}
    assert cs.SPMD_FIRST_LOSS_REL == 3e-5 and cs.SPMD_GRAD_REL == 1e-2


@pytest.mark.parametrize("case", [
    "launch", "ranks_differ", "first_loss", "local_stats_loss", "grads",
    "local_stats_grads", "local_backward_grads", "rising", "ratio"])
def test_spmd_gates_fail(case, capsys):
    ranks = {n: [_spmd_rank(r, n) for r in range(2)]
             for n in ("spmd", "spmd_dgc")}
    one = _world_of_one()
    if case == "launch":
        ranks["spmd"][0]["steps"][0]["launches"] = {"sgdm_fp32": 0,
                                                    "pack_int8": 0}
    elif case == "ranks_differ":
        ranks["spmd"][1]["digest"] = "e" * 64
    elif case == "first_loss":
        # the world's first loss is 7.0: 1e-4 relative from this one's
        one = dict(one, loss=7.0007)
    elif case == "local_stats_loss":
        # per-rank statistics' loss within the gate: it tells nothing
        one = dict(one, local_stats_loss=7.0001)
    elif case == "grads":
        one = _world_of_one(world=0.036)
    elif case == "local_stats_grads":
        one = _world_of_one(local_stats=5e-3)
    elif case == "local_backward_grads":
        one = _world_of_one(local_backward=5e-3)
    elif case == "rising":
        ranks["spmd"] = [_spmd_rank(r, "spmd", np.linspace(6.5, 7.0, 20))
                         for r in range(2)]
    else:
        ranks["spmd_dgc"] = [_spmd_rank(r, "spmd_dgc", ratio=0.05)
                             for r in range(2)]
    with pytest.raises(SystemExit):
        results = {n: cs.spmd_summary(n, rk) for n, rk in ranks.items()}
        cs.spmd_gates(results, one)
    err = capsys.readouterr().err
    assert "spmd" in err or "launched" in err


def test_phases_17_and_18_are_documented_and_run():
    import ast
    import inspect

    assert "17. lm_world" in cs.__doc__
    assert "18. resnet_spmd_world" in cs.__doc__
    src = inspect.getsource(cs.main)
    calls = [n.func.id for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert {"phase_lm_world", "phase_resnet_spmd_world",
            "phase_kernels_shards"} <= set(calls)
    assert (src.index("phase_elastic_live(") < src.index("phase_lm_world(")
            < src.index("phase_resnet_spmd_world("))
    assert src.index("phase_kernels_shards(") < src.index("phase_serve(")
    assert src.index("phase_resnet_spmd_world(") < src.index(
        '"kernels": kernels')
    assert "spawn_world(" in inspect.getsource(cs.phase_lm_world)
    assert "spawn_world(" in inspect.getsource(cs.phase_resnet_spmd_world)


# -- phase 19: distill --------------------------------------------------------

def test_phase_19_is_documented_and_run():
    import ast
    import inspect

    assert "19. distill" in cs.__doc__
    src = inspect.getsource(cs.main)
    calls = [n.func.id for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert "phase_distill" in calls
    # the teachers serve phase 10's checkpoint, the students phase 9's
    # shards, after every earlier phase and before the kernels line
    assert "phase_resume(ok_mod, card, teacher_ckpt)" in src
    assert (src.index("phase_resnet_spmd_world(") < src.index(
        "phase_distill(") < src.index('"kernels": kernels'))
    body = inspect.getsource(cs.phase_distill)
    for part in ('"--local-mesh", "dp=1"', '"--serve-topk"', "params=False",
                 '"sgdm_fp32"', '"sgdm_q"', "phase_distill_discovery(",
                 "phase_distill_examples(", "DistillPool("):
        assert part in body, part


def test_logit_bound_and_topk_check():
    ref = np.array([[3.0, 1.0, 0.99, -1.0, 2.0],
                    [0.5, 0.51, 0.2, 0.1, 0.0]], np.float32)
    bound = cs.logit_bound(ref)
    assert bound == pytest.approx(cs.DISTILL_LOGIT_REL * 3.0)
    idx = np.argsort(-ref, 1)[:, :3]
    val = np.take_along_axis(ref, idx, 1).astype(np.float16)
    ok = cs.topk_check(ref, idx, val, bound)
    assert ok["indices_wrong"] == 0 and ok["val_max_abs_err"] < 1e-3
    # row 0: 3.0 and 2.0 stand apart, 1.0 and 0.99 do not; row 1: 0.51
    # and 0.5 do not, 0.2 does
    assert ok["indices_checked"] == 3
    bad = idx.copy()
    bad[0, 0] = 3
    assert cs.topk_check(ref, bad, val, bound)["indices_wrong"] == 1
    ties = idx.copy()
    ties[0, 2], ties[1, 0] = 2, 1   # ambiguous ranks are not held
    assert cs.topk_check(ref, ties, val, bound)["indices_wrong"] == 0
    off = val.astype(np.float32) + 0.5
    assert cs.topk_check(ref, idx, off, bound)["val_max_abs_err"] > bound


def test_distill_pool_reaps_its_processes(tmp_path, capsys):
    """Every process the phase starts carries its job id and its own
    session; leaving the block kills and reaps all of them, on the
    success path and on a failure; wait_ready fails when one exits."""
    (tmp_path / "sleeper.py").write_text("import time\ntime.sleep(300)\n")
    (tmp_path / "quitter.py").write_text("raise SystemExit(3)\n")
    with cs.DistillPool(tmp_path, tmp_path / "ck") as pool:
        pool.env["PYTHONPATH"] += os.pathsep + str(tmp_path)
        pool.spawn("a", "sleeper")
        pool.spawn("b", "sleeper")
        assert pool.job.startswith(f"chip-distill-{os.getpid()}-")
        deadline = time.monotonic() + 30
        while (len(cs.pids_with_env(EDL_TPU_JOB_ID=pool.job)) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert len(cs.pids_with_env(EDL_TPU_JOB_ID=pool.job)) == 2
        pool.kill("a")
        assert pool.procs["a"].returncode == -9
    assert all(p.poll() is not None for p in pool.procs.values())
    assert cs.pids_with_env(EDL_TPU_JOB_ID=pool.job) == []
    with pytest.raises(SystemExit):
        with cs.DistillPool(tmp_path, tmp_path / "ck") as pool:
            pool.env["PYTHONPATH"] += os.pathsep + str(tmp_path)
            pool.spawn("q", "quitter")
            pool.ports["q"] = 1
            pool.wait_ready("q")
    assert "q exited 3" in capsys.readouterr().err


def test_reader_probe_and_the_order_gate(tmp_path, capsys):
    """imagenet_train --teachers on the CPU under ReaderProbe: a wait on
    the reader and one on the loader, and the labels of each batch in
    loader_labels' order, each epoch's counts, the answers' bytes, the
    hook after its batch."""
    from edl_tpu_torch.distill.teacher_server import (TeacherServer,
                                                      _build_model_predict)
    from edl_tpu_torch.examples import imagenet_train

    data = tmp_path / "data"
    imagenet_train.make_synthetic_shards(str(data), 2, 32, 32, 10, seed=0)
    predict, _ = _build_model_predict("ResNetTiny", 10, "", "image",
                                      "logits", (32, 32, 3), "float16", 0,
                                      "", "", device="cpu")
    hooked = []
    probe = cs.ReaderProbe(3, lambda: hooked.append(len(probe.labels)))
    with TeacherServer(predict, host="127.0.0.1") as srv, probe:
        assert imagenet_train.main([
            "--data-dir", str(data), "--model", "ResNetTiny",
            "--image-size", "32", "--num-classes", "10", "--batch-size",
            "16", "--epochs", "2", "--no-augment", "--device", "cpu",
            "--teachers", f"127.0.0.1:{srv.port}"]) == 0
    from edl_tpu_torch.distill.reader import DistillReader
    assert DistillReader.__call__ is probe.call   # restored
    assert hooked == [3] and len(probe.waits) == 8
    assert len(probe.loader_waits) == 8   # the reader thread's, a batch
    order = cs.loader_labels(data, 2, batch=16)
    assert len(order) == 8
    assert all(np.array_equal(a, b) for a, b in zip(probe.labels, order))
    assert probe.epochs == [{"batches": 4, "tasks": 4,
                             "served_rows": 64}] * 2
    assert probe.answer_bytes == [16 * 10 * 4] * 8


def test_discovery_stats_reads_the_server():
    from edl_tpu_torch.coord.store import InMemStore
    from edl_tpu_torch.distill.discovery_server import DiscoveryServer

    with DiscoveryServer(InMemStore(), port=0, host="127.0.0.1") as srv:
        srv.table.register("c0", cs.DISTILL_SERVICE)
        stats = cs.discovery_stats(srv.endpoint)
    assert stats[cs.DISTILL_SERVICE]["clients"] == 1
