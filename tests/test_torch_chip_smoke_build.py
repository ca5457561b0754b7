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


def test_lm_world_runs_sp_and_moe_with_their_launches():
    from edl_tpu_torch.ops import opt_kernels as ok_mod
    runs = dict(cs.LM_WORLD_RUNS)
    assert runs["sp"] == ["--mesh", "sp"]
    assert runs["moe"] == ["--moe", "--n-experts", "4", "--moe-dispatch",
                           "hier", "--moe-compress", "int8"]
    base = cs.lm_want(ok_mod, 60)
    # rank r of a ring of 2 attends r past blocks and its diagonal
    for r in (0, 1):
        sp = cs.lm_world_want(ok_mod, "sp", r, 60)
        assert sp["flash_fwd"] == sp["flash_bwd_dq"] == 8 * (r + 1)
        assert sp["pack_int8"] == 0 and sp["adam_fp32"] == base["adam_fp32"]
    moe = cs.lm_world_want(ok_mod, "moe", 1, 60)
    assert moe == {**base, "pack_int8": 16}   # 2 legs x 8 blocks
    assert cs.lm_world_want(ok_mod, "int8", 0, 60)["pack_int8"] == 1


def _sp_moe_runs(**override) -> dict:
    runs = {"sp": {"losses": [10.40, 10.1, 9.9, 9.7],
                   "first": {"dense_loss": 10.4001},
                   "step_ms_median": 1500.0,
                   "ring_flash_vs_dense": {
                       k: {"max_abs_err": 0.01, "max_abs_ref": 2.0}
                       for k in ("o", "dq", "dk", "dv")}},
            "moe": {"step_ms_median": 2500.0,
                    "stats": {"moe_dcn_bytes_per_step": 1 << 20},
                    "k8_bitwise_plain": True,
                    "moe_parity_gate": {"ok": True, "bitwise_hier": True}}}
    for name, kw in override.items():
        runs[name] = dict(runs[name], **kw)
    return runs


def test_lm_world_sp_moe_gates_pass(capsys):
    out = cs.lm_world_sp_moe_gates(_sp_moe_runs())
    assert out["sp_loss_delta"] == pytest.approx(1e-4)
    assert all(out["ring_ok"].values())


@pytest.mark.parametrize("override", [
    {"sp": {"first": {"dense_loss": 10.0}}},
    {"sp": {"first": {"dense_loss": 10.4005}}},
    {"sp": {"ring_flash_vs_dense": {
        "o": {"max_abs_err": 0.07, "max_abs_ref": 2.0}}}},
    {"moe": {"k8_bitwise_plain": False}},
    {"moe": {"moe_parity_gate": {"ok": False}}},
    {"moe": {"stats": {"moe_dcn_bytes_per_step": 0}}}])
def test_lm_world_sp_moe_gates_fail(override, capsys):
    with pytest.raises(SystemExit):
        cs.lm_world_sp_moe_gates(_sp_moe_runs(**override))
    assert "lm_world" in capsys.readouterr().err


def test_sp_loss_controls_read_the_three_faults():
    """sp_loss_controls on a small dense model over two blocks: each
    fault moves the whole sequence's loss, the boundary control is the
    mean without the targets of each block's last position, one block
    has no fault to read, and the model's pos_embed is as it was."""
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lm_loss_fn)

    model = Transformer(TransformerConfig(
        vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
        max_len=8, dtype=torch.float32, attention="dense"), device="cpu",
        seed=3)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (4, 8)).astype(np.int32))
    before = model.pos_embed.detach().clone()
    with torch.no_grad():
        out = cs.sp_loss_controls(model, toks, 2)
        logp = torch.log_softmax(model(toks)[:, :-1].float(), -1)
        whole = float(lm_loss_fn(model, {"tokens": toks})[0])
    torch.testing.assert_close(model.pos_embed.detach(), before, rtol=0,
                               atol=0)
    nll = -torch.gather(logp, -1, toks[:, 1:].long()[..., None])[..., 0]
    dropped = float(torch.cat([nll[:, :3], nll[:, 4:]], 1).mean())
    assert out["boundary_targets_dropped"] == pytest.approx(
        abs(dropped - whole), abs=1e-6)
    assert all(v > 1e-4 for v in out.values()), out
    with torch.no_grad():
        assert cs.sp_loss_controls(model, toks, 1) == {k: 0.0 for k in out}


def test_state_checksum_tells_states_apart():
    from edl_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
    from edl_tpu_torch.train.fused_opt import make_fused_tx
    from edl_tpu_torch.train.state import TrainState

    def state(seed):
        model = Transformer(TransformerConfig(
            vocab_size=16, d_model=16, n_heads=2, n_layers=1, d_ff=32,
            max_len=8, dtype=torch.float32), device="cpu", seed=seed)
        return TrainState.create(model=model, tx=make_fused_tx(
            "adam", 1e-3, "fp32"), params=list(model.named_parameters()))

    assert cs.state_checksum(state(0)) == cs.state_checksum(state(0))
    assert cs.state_checksum(state(0)) != cs.state_checksum(state(1))


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


def test_the_discovery_view_over_the_port_s_store():
    """Step (d)'s view: the port's store and a discovery server; the
    teacher registered, tracked only once a client asks, assigned, and
    dropped once its registration is gone."""
    from edl_tpu_torch.coord.store import InMemStore
    from edl_tpu_torch.distill.discovery_client import DiscoveryClient
    from edl_tpu_torch.distill.discovery_server import DiscoveryServer
    from edl_tpu_torch.distill.registrar import TeacherRegistrar

    store, ep = InMemStore(), "127.0.0.1:9"
    reg = TeacherRegistrar(store, cs.DISTILL_SERVICE, ep, ttl=5.0,
                           probe_timeout=0.1)
    reg.wait_alive = lambda: None   # a registry entry, no teacher
    reg.start()
    with DiscoveryServer(store, port=0, host="127.0.0.1",
                         tick_interval=0.1) as srv:
        view = cs.DiscoveryView(store, srv.endpoint, cs.DISTILL_SERVICE)
        deadline = time.monotonic() + 10.0
        cs.wait_until(lambda: view.ready({ep}), deadline, "registration")
        assert view.tracked() is None and not view.dropped(ep)
        client = DiscoveryClient(srv.endpoint, cs.DISTILL_SERVICE,
                                 heartbeat_interval=0.1).start()
        try:
            assert client.wait_for_servers(5.0) == [ep]
            cs.wait_until(lambda: view.assigned(ep), deadline, "assignment")
            assert view.balanced() == [ep]
            reg.stop()
            cs.wait_until(lambda: ep not in view.registered(), deadline,
                          "removal from the registry")
            cs.wait_until(lambda: view.dropped(ep), deadline, "drop")
        finally:
            client.stop()
    assert cs.DiscoveryView(store, "127.0.0.1:1", "x").tracked() is None


# -- phase 20: zoo_ctr, and the per-phase seconds -----------------------------

def test_phase_20_is_documented_and_run():
    import ast
    import inspect

    assert "20. zoo_ctr" in cs.__doc__
    src = inspect.getsource(cs.main)
    calls = [n.func.id for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert "phase_zoo_ctr" in calls
    assert (src.index("phase_distill(") < src.index("phase_zoo_ctr(")
            < src.index('"kernels": kernels'))
    body = inspect.getsource(cs.phase_zoo_ctr)
    for part in ('model="VGG16"', "params=False", '"sgdm_fp32"',
                 "phase_vgg_teacher(", "phase_ctr(", "spawn_ctr_elastic(",
                 "phase_ctr_elastic(",
                 "phase_fit_a_line(", '"distill_vgg"', "DistillPool("):
        assert part in body, part


def test_every_phase_has_its_seconds():
    """main laps the clock after each of the 23 phases, in order, and the
    seconds line carries them."""
    import inspect
    import re

    src = inspect.getsource(cs.main)
    laps = re.findall(r'clock\.lap\("(\d+)_(\w+)"\)', src)
    assert [int(n) for n, _ in laps] == list(range(1, 24))
    assert '"phases": clock.seconds' in src
    assert src.index('clock.lap("23_chaos")') < src.index(
        '"phases": clock.seconds')


def test_phase_clock_laps_and_total(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(cs.time, "monotonic", lambda: now[0])
    clock = cs.PhaseClock()
    now[0] = 103.5
    clock.lap("a")
    now[0] = 104.0
    clock.lap("b")
    now[0] = 110.0
    clock.lap("a")
    assert clock.seconds == {"a": 9.5, "b": 0.5}
    assert clock.total() == 10.0


def test_ctr_table_reads_the_task_records():
    from edl_tpu_torch.coord.store import InMemStore
    from edl_tpu_torch.data.task_master import TaskMaster

    store = InMemStore()
    m = TaskMaster(store, "j", "ctr-A")
    m.init_epoch(0, [{"file": "a"}, {"file": "b"}])
    t = m.get_task()
    table = cs.ctr_table(store, "j")
    assert sorted(table) == ["/j/data/e0/task/000000",
                             "/j/data/e0/task/000001"]
    assert table[t._key]["state"] == "pending"
    assert table[t._key]["owner"] == "ctr-A"


def test_the_elastic_ctr_phase_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 20 (d) with its trainers on the CPU over small shards: the
    first to lease is stopped holding its lease until the other leases,
    then SIGKILLed; the survivor takes the lease after its deadline and
    the table ends all done."""
    from edl_tpu_torch.examples import ctr_train

    data = tmp_path / "ctr_data"
    ctr_train.make_synthetic_files(str(data), cs.CTR_SHARDS, 2048)
    with cs.DistillPool(tmp_path, tmp_path / "ck", prefix="test-ctr",
                        timeout=300) as pool:
        spawn = pool.spawn
        # one intra-op thread a CPU trainer: under a loaded run a thread
        # pool the size of the host waits at every op for its slowest
        # thread, and the trainers' steps, not the phase, set its time
        pool.env["OMP_NUM_THREADS"] = "1"

        def on_the_cpu(name, module, *args):
            if module.endswith("ctr_train"):
                args = (*args, "--device", "cpu")
            spawn(name, module, *args)

        pool.spawn = on_the_cpu
        out = cs.phase_ctr_elastic(pool, cs.spawn_ctr_elastic(pool, data))
    assert out["held"] and {out["victim"], out["survivor"]} == {
        "ctr-A", "ctr-B"}
    assert all(s >= 0 for s in out["redispense_after_deadline_s"].values())
    assert all(f == {"state": "done", "owner": out["survivor"],
                     "failures": 1} for f in out["final"].values())
    assert out["states_by_epoch"] == {e: {"done": cs.CTR_SHARDS - 1}
                                      for e in range(cs.CTR_ELASTIC_EPOCHS)}
    assert out["survivor_rc"] == 0 and out["survivor_auc"] > 0.5
    # taken after the kill (how long after depends on the load: on the
    # CPU the survivor finishes its other tasks first)
    assert all(s > 0 for s in out["redispense_after_kill_s"].values())
    assert cs.pids_with_env(EDL_TPU_JOB_ID=pool.job) == []


def rank_tiny_moe_gate(inputs: dict, directory: Path) -> dict:
    """A rank of phase 17's MoE gate (chip_smoke.tiny_moe_gate over
    MOE_GATE_CASES, read by moe_gate_readings) on the CPU, the CPU's
    readings standing in for the card's too."""
    cpu = [cs.tiny_moe_gate("cpu", *case) for case in cs.MOE_GATE_CASES]
    out = cs.moe_gate_readings(cpu, cpu)
    return {"ok": np.array(out["ok"]),
            "cases": np.array([[c["bitwise_hier"], c["max_loss_delta"],
                                c["fwd_delta"], c["device_delta"]]
                               for c in out["cases"]]),
            "flat": np.array([g["flat_losses"] for g in cpu]),
            "int8": np.array([g["int8_losses"] for g in cpu])}


@pytest.fixture(scope="module")
def moe_gate_world(tmp_path_factory):
    from test_torch_world import World

    return World("test_torch_chip_smoke_build:rank_tiny_moe_gate", 2,
                 tmp_path_factory.mktemp("moe_gate")).results()


def test_phase_17_s_moe_gate_passes_in_a_world_of_two_on_the_cpu(
        moe_gate_world):
    """The gate phase 17 holds the moe run to, on the JAX test's tiny
    problem over every case: hier bit for bit flat, step 1's int8 loss
    within MOE_FWD_ATOL of flat's, each case's max_loss_delta inside the
    envelope, on both ranks alike."""
    assert len(cs.MOE_GATE_CASES) >= 8
    r0, r1 = moe_gate_world
    np.testing.assert_array_equal(r0["cases"], r1["cases"])
    assert bool(r0["ok"])
    bitwise, delta, fwd, device = r0["cases"].T
    assert bitwise.all() and (device == 0).all()
    assert (fwd <= cs.MOE_FWD_ATOL).all()
    assert ((0 < delta) & (delta <= cs.MOE_GATE_ENVELOPE)).all()


def test_phase_17_s_moe_gate_fails_off_its_bounds():
    """moe_gate_readings fails a case off any of its bounds: hier not
    bit for bit, the card's losses off the CPU's, step 1's int8 loss off
    flat's, the envelope."""
    def case(**kw):
        return {"seed": 0, "rows": 5, "bitwise_hier": True, "ok": True,
                "max_loss_delta": 0.1, "flat_losses": [3.0, 2.5],
                "int8_losses": [3.001, 2.6], **kw}

    assert cs.moe_gate_readings([case()], [case()])["ok"]
    for card, cpu in (
            ([case(bitwise_hier=False)], [case()]),
            ([case(ok=False)], [case()]),
            ([case(flat_losses=[3.0, 2.51])], [case()]),
            ([case(int8_losses=[3.0 + 2 * cs.MOE_FWD_ATOL, 2.6])],
             [case(int8_losses=[3.0 + 2 * cs.MOE_FWD_ATOL, 2.6])])):
        assert not cs.moe_gate_readings(card, cpu)["ok"]


# a few of MOE_GATE_CASES in the JAX package (of the gate's cases its
# max_loss_delta is largest at (5, 1) and smallest at (4, 1)); a JAX MoE
# step is slow on the CPU
MOE_JAX_CASES = ((0, 5), (4, 1), (5, 1), (6, 5))


def test_phase_17_s_moe_gate_reads_as_the_jax_package_s(moe_gate_world):
    """The gate's per-step losses of the flat and int8 arms on the CPU,
    against the JAX package's MoECommStep on the same inits (the port's,
    bridged) and rows, on a two-device ep mesh (tests/moe_gate_sweep.py
    reads every case so): flat within 1e-5 (fp32 sums in another order),
    int8 within 1e-4 (XLA on the CPU forms a block's amax/127 one ulp off
    the IEEE quotient in a few blocks, and an element on a rounding edge
    then takes the next int8 step: 2.3e-5 at (4, 1))."""
    import moe_gate_sweep

    want = moe_gate_sweep.jax_gate_losses(MOE_JAX_CASES, cs.MOE_GATE_STEPS)
    at = [cs.MOE_GATE_CASES.index(case) for case in MOE_JAX_CASES]
    r0 = moe_gate_world[0]
    np.testing.assert_allclose(r0["flat"][at], want["flat"], atol=1e-5)
    np.testing.assert_allclose(r0["int8"][at], want["int8"], atol=1e-4)


# -- phases 21-22: the elastic control plane ---------------------------------

def test_the_control_plane_phases_are_documented_and_run():
    import ast
    import inspect

    assert "21. scaler" in cs.__doc__ and "22. serve_scaler" in cs.__doc__
    src = inspect.getsource(cs.main)
    calls = [n.func.id for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert {"phase_scaler", "phase_serve_scaler", "ServePool"} <= set(calls)
    # the first teacher starts before phase 21 and is awaited in phase 22
    assert (src.index("phase_zoo_ctr(") < src.index("ServePool(")
            < src.index("started.start()") < src.index("phase_scaler(")
            < src.index("phase_serve_scaler(") < src.index(
                '"kernels": kernels'))
    argv = cs.SCALER_ARGV
    assert argv[:3] == ["--scaler", "--nodes-range", "1:2"]
    assert "--device" not in argv          # the demo's default: the card
    # the two phases' scripted seconds: the pods' training, the load's
    # stages and the capacity probe, inside the 100 s they may take
    training = (int(argv[argv.index("--epochs") + 1])
                * int(argv[argv.index("--steps-per-epoch") + 1])
                * float(argv[argv.index("--step-time") + 1]))
    load = cs.SERVE_CAPACITY_S + sum(s for _, _, s in cs.SERVE_STAGES)
    assert training + load <= 60.0
    assert [n for n, _, _ in cs.SERVE_STAGES] == ["cruise", "step", "idle"]
    assert [m for _, m, _ in cs.SERVE_STAGES] == [0.3, 1.5, 0.05]
    assert cs.SERVE_MEASURE_S < cs.SERVE_STAGES[0][2]
    assert cs.ServePool.TEACHER[:2] == ["--model", "ResNet50_vd"]
    body = inspect.getsource(cs.phase_serve_scaler)
    for part in ("serve_scaler_audit(", "teacher_capacity(", "first_ok",
                 "drain_log", "h.proc.alive()", "SERVE_SLO_X",
                 '"teacher predict on (\\S+)"'):
        assert part in body, part


def test_the_resize_split_reads_the_trace_cli(tmp_path, monkeypatch,
                                              capsys):
    """trace_cli_resizes runs the trace CLI on a span directory and gives
    its resize_phase_summary with each trace's root spans;
    generation_start_split splits a respawned rank's start and skips a
    rank that adopted in place."""
    from edl_tpu_torch.obs import trace

    assert cs.trace_cli_resizes(tmp_path / "none") == []
    monkeypatch.setenv("EDL_TPU_TRACE", str(tmp_path))
    trace.reconfigure()
    try:
        with trace.span("scaler.decide"):
            with trace.span("resize.request"):
                with trace.span("resize.actuate"):
                    pass
        trace.event("resize.adopt", 0.25)
        trace.event("ckpt.write", 0.1)
    finally:
        monkeypatch.delenv("EDL_TPU_TRACE")
        trace.reconfigure()
    got = cs.trace_cli_resizes(tmp_path)
    assert sorted(r["roots"][0] for r in got) == ["resize.adopt",
                                                  "scaler.decide"]
    decide = next(r for r in got if r["roots"] == ["scaler.decide"])
    assert set(decide["phases"]) == {"decision", "actuation"}
    gens = [{"version": 2, "ranks": {
        0: {"rank": 0, "pod": "a", "adopted": False, "t_start": 12.0,
            "t_restore": [15.0, 15.5], "t_first_step": 17.0},
        1: {"rank": 1, "pod": "b", "adopted": True, "t_start": 1.0,
            "t_restore": None, "t_first_step": 10.5}}},
        {"version": 1, "ranks": {}}]
    (split,) = cs.generation_start_split(gens, {2: 10.0})
    assert split == {"version": 2, "rank": 0, "pod": "a",
                     "to_process_s": 2.0, "to_restore_s": 3.0,
                     "restore_s": 0.5, "to_first_step_s": 1.5,
                     "total_s": 7.0}
    line = cs.resize_split_line("elastic", got, [split])
    assert json.loads(capsys.readouterr().out) == {"resize_split": line}
    assert cs.summary_line("x\nscaler_summary={\"ok\": 1}\n",
                           "scaler_summary") == {"ok": 1}


def test_the_serve_pool_on_the_cpu(tmp_path, monkeypatch):
    """Phase 22's rig with a CPU teacher: the actuator spawns the
    zoo-teacher CLI through spawn_process_teacher and registers it; the
    capacity probe and an open-loop stage leave no request without an
    outcome; leaving the block stops the teacher and kills and reaps
    every process of the run."""
    monkeypatch.setattr(cs.ServePool, "TEACHER", [
        "--model", "ResNetTiny", "--num-classes", "10", "--input-shape",
        "32,32,3", "--input-dtype", "float16", "--device", "cpu"])
    marker = cs.run_marker()
    with cs.ServePool(tmp_path, marker) as pool:
        pool.actuator.resize(1)
        (ep,) = pool.actuator.endpoints()
        assert pool.endpoints_fn()() == [ep]
        feed = cs.serve_feed(2, size=32)
        assert cs.teacher_capacity(ep, feed, 0.5) > 0
        s, first, t0 = cs.serve_stage(pool, feed, 20.0, 1.0, seed=0)
        assert s["offered"] == s["ok"] > 0 and first[ep] >= t0
        (handle,) = pool.handles
        assert handle.proc.alive()
        # the line phase 22's device gate reads: this teacher's is the CPU
        import re
        assert re.findall(r"teacher predict on (\S+)", Path(
            handle.proc.log_path).read_text()) == ["cpu"]
    assert not handle.proc.alive()
    assert cs.pids_with_env(**marker) == []


def test_the_resnet_phases_keep_every_shard_and_the_elastic_ones_do_not():
    """RESNET_ARGV keeps all RESNET_SHARDS npz shards in the loader's
    cache (imagenet_train --cache-shards); the elastic phases keep the
    default 4, whose reloads pace their epochs."""
    from edl_tpu_torch.examples import imagenet_train

    argv = cs.RESNET_ARGV
    assert argv[argv.index("--cache-shards") + 1] == str(cs.RESNET_SHARDS)
    args = imagenet_train._parser().parse_args(["--data-dir", "D", *argv])
    assert args.cache_shards == cs.RESNET_SHARDS
    elastic = imagenet_train._parser().parse_args(cs.elastic_argv("D", "C"))
    assert "--cache-shards" not in cs.elastic_argv("D", "C")
    assert elastic.cache_shards == 4


# -- phase 15 on a replicated store, phase 23 chaos ---------------------------


def test_the_replicated_elastic_job_fails_over_on_the_cpu(tmp_path):
    """ElasticJob with three replicas starts the group, finds its leader,
    and store_failover SIGKILLs exactly that replica and names it; a new
    leader rises at a higher term within the phase's bound, the job's
    client keeps its writes across it, and every replica is gone after
    the block."""
    import inspect

    with cs.ElasticJob(tmp_path, tmp_path / "data", cs.ELASTIC_ENV, 120,
                       "elastic-cpu", replicas=cs.ELASTIC_STORE_REPLICAS,
                       election_ttl=cs.ELASTIC_STORE_TTL) as job:
        assert job.stores == ["store0", "store1", "store2"]
        assert job.store_spec == ",".join(job.endpoints)
        idx, term = job.wait_leader(30.0)
        rev = job.client.put("/cpu/before", "1")
        failover = cs.store_failover(job)
        assert failover["killed_index"] == idx
        assert failover["killed_endpoint"] == job.endpoints[idx]
        assert failover["term_before"] == term
        assert failover["term_after"] > term
        assert failover["new_leader_index"] != idx
        assert failover["kill_to_new_leader_s"] <= failover["bound_s"] == (
            cs.ELASTIC_FAILOVER_TTLS * cs.ELASTIC_STORE_TTL)
        assert job.procs[job.stores[idx]].poll() is not None
        rec = job.client.get("/cpu/before")
        assert (rec.value, rec.revision) == ("1", rev)
        assert job.client.put("/cpu/after", "2") > rev
        procs = list(job.procs.values())
    assert all(p.poll() is not None for p in procs)
    src = inspect.getsource(cs.phase_elastic)
    assert "replicas=ELASTIC_STORE_REPLICAS" in src
    assert src.index("store_failover(job)") < src.index(
        'job.launcher("podC")') < src.index("restore_every_version(")
    assert "replicas=" not in inspect.getsource(cs.phase_elastic_live)
    assert cs.ELASTIC_STORE_TTL < float(cs.ELASTIC_ENV["EDL_TPU_LEASE_TTL"])


def test_restore_every_version_reads_each_sealed_version(tmp_path, capsys):
    from edl_tpu_torch.models.linear import LinearRegression
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainState, TrainStatus, sgd

    state = TrainState.create(model=LinearRegression(8, 2, device="cpu"),
                              tx=sgd(lambda c: 0.1))
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3, process_index=0)
    for step in (1, 2):
        mgr.save(state, TrainStatus(step=step))
    mgr.close()
    assert cs.restore_every_version(tmp_path) == {0: 1, 1: 2}
    with pytest.raises(SystemExit):
        cs.restore_every_version(tmp_path / "none")
    assert "no sealed version" in capsys.readouterr().err


def _summary(**over):
    from edl_tpu_torch.chaos.schedule import FAULT_CLASSES

    doc = {"ok": True, "breaches": [], "stats": {
        "faults_injected": 11, "fault_classes": list(FAULT_CLASSES),
        "schedule_fingerprint": cs.CHAOS_FINGERPRINT}}
    doc["stats"].update(over.pop("stats", {}))
    doc.update(over)
    return doc


def test_the_chaos_phase_builds_its_command_lines():
    import sys as _sys

    from edl_tpu.chaos.schedule import ChaosSchedule

    soak, drill = cs.chaos_cmd(cs.CHAOS_SOAK), cs.chaos_cmd(cs.CHAOS_DRILL)
    assert soak == [_sys.executable, "-m", "edl_tpu_torch.chaos", "soak",
                    "--seed", "1", "--ticks", "11"]
    assert drill[4:] == ["--seed", "1", "--ticks", "2", "--mix",
                         "ckpt-corrupt", "--weaken-checksums"]
    # the default 1.5 s tick and 12 s settle: neither is overridden
    assert not {"--tick-s", "--settle-s"} & set(soak + drill)
    # the fingerprint the phase holds is the JAX package's
    assert cs.CHAOS_FINGERPRINT == ChaosSchedule.generate(
        1, 11, tick_s=1.5, pods=2).fingerprint()


def test_the_chaos_phase_reads_both_outcomes(capsys):
    out = ("log line\nchaos_summary=" + json.dumps(_summary())
           + "\nchaos soak: 11 faults across 11 classes\n")
    assert cs.chaos_summary(out) == _summary()
    assert cs.chaos_summary("no summary here") == {}
    cs.chaos_soak_gates(0, _summary())
    for rc, doc in ((1, _summary()),
                    (0, _summary(ok=False, breaches=["I1: lost m2"])),
                    (0, _summary(stats={"faults_injected": 10})),
                    (0, _summary(stats={"fault_classes": ["wire"]})),
                    (0, _summary(stats={"schedule_fingerprint": "x"})),
                    (0, {})):
        with pytest.raises(SystemExit):
            cs.chaos_soak_gates(rc, doc)
    drilled = _summary(ok=False, breaches=[
        "I3: pod0 restored ckpt-0 with digest a != sealed b and no "
        "corruption was detected"])
    cs.chaos_drill_gates(1, drilled)
    for rc, doc in ((0, drilled), (1, _summary()),
                    (1, _summary(ok=False, breaches=["I1: x"]))):
        with pytest.raises(SystemExit):
            cs.chaos_drill_gates(rc, doc)
    assert "auditor went blind" not in capsys.readouterr().out


def test_the_chaos_phase_is_documented_and_run():
    import ast
    import inspect

    assert "23. chaos" in cs.__doc__
    src = inspect.getsource(cs.main)
    calls = [n.func.id for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert calls.count("phase_chaos") == 1
    # alone: after the serving pool's block has closed
    assert src.index("phase_chaos()") > src.index(
        'clock.lap("22_serve_scaler")')
    assert src.index("phase_chaos()") < src.index('"kernels": kernels')


def test_the_bytecode_cache_reaches_the_children(tmp_path, monkeypatch):
    """use_bytecode_cache points this process and its children at
    PYCACHE with bytecode writes on, and its warm-up child writes the
    bytecode of what it imports there; main waits for it before phase 9,
    the first phase that starts a process."""
    import inspect
    import sys

    monkeypatch.setattr(cs, "PYCACHE", tmp_path / "pyc")
    monkeypatch.setattr(cs, "WARM_IMPORTS", "import edl_tpu_torch.chaos.audit")
    monkeypatch.setenv("PYTHONDONTWRITEBYTECODE", "1")
    monkeypatch.setenv("PYTHONPYCACHEPREFIX", "")
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    warm = cs.use_bytecode_cache()
    assert warm.wait(120) == 0, warm.stderr.read().decode()
    warm.stderr.close()
    assert os.environ["PYTHONPYCACHEPREFIX"] == str(tmp_path / "pyc")
    assert "PYTHONDONTWRITEBYTECODE" not in cs.smoke_env()
    assert list((tmp_path / "pyc").rglob("audit*.pyc"))
    src = inspect.getsource(cs.main)
    assert src.index('clock.lap("1_build")') < src.index(
        "use_bytecode_cache()") < src.index("warm.wait()") < src.index(
        "phase_train_resnet_world(")
    # every module the warm-up names imports on the CPU
    for mod in cs.WARM_IMPORTS.split("import ", 1)[1].split(", "):
        assert mod == "chip_smoke" or (
            Path(cs.HERE, *mod.split(".")).with_suffix(".py").exists()), mod


# -- the redis flavor (phase 19 (f)), the scrape (phase 9), the fleet (21) ---

def test_the_new_steps_are_documented_and_run():
    """Step (f) runs inside phase 19 after (d), on D and a fifth teacher E
    started with the others, and its K4 launches count on the
    distill_redis path; phase 9's rank 0 serves its registry and is
    scraped; the fleet simulator starts before phase 21's demo and is
    read after it, on an artifact of phases 15 and 16."""
    import ast
    import inspect

    assert "(f) the redis:// discovery flavor" in cs.__doc__
    assert "EDL_TPU_METRICS_PORT" in cs.__doc__
    assert "edl_tpu_torch.scaler.fleet selftest" in cs.__doc__
    body = inspect.getsource(cs.phase_distill)
    assert '"E": pool.teacher("E")' in body
    assert 'pool.wait_ready("A", "B", "C", "D", "E")' in body
    assert (body.index("phase_distill_discovery(")
            < body.index("phase_distill_redis(") < body.index("del model"))
    assert '"distill_redis"' in body
    redis = inspect.getsource(cs.phase_distill_redis)
    for part in ("MiniRedis().start()", "redis_wiring(", "redis_student(",
                 "DiscoveryView(RedisStore(", "wait_until(",
                 'pool.kill("E", "registrar_E_redis")',
                 "check_launches(", "mini.stop()"):
        assert part in redis, part
    student = inspect.getsource(cs.redis_student)
    for part in ("make_distill_step(", "make_fused_tx(", '"fp32"',
                 "discovery=disc_ep", "service=REDIS_SERVICE"):
        assert part in student, part
    world = inspect.getsource(cs.phase_train_resnet_world)
    assert '"EDL_TPU_METRICS_PORT"' in world and "scrape_gate(" in world
    src = inspect.getsource(cs.main)
    calls = [n.func.id for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert "FleetRun" in calls and "fleet_artifact" in calls
    assert (src.index("phase_elastic_live(") < src.index("FleetRun(")
            < src.index("phase_scaler(") < src.index("fleet.result()")
            < src.index('clock.lap("21_scaler")'))
    assert cs.REDIS_STEPS == 12 and cs.REDIS_KILL_AFTER == 6
    assert cs.REDIS_DROP_DEADLINE_S > cs.REDIS_TTL_S + cs.REDIS_TICK_S


def test_the_fleet_artifact_from_phases_15_and_16(tmp_path):
    """The ladder's keys and values from canned phase 15/16 results, read
    back by the fleet simulator's from_artifact."""
    from edl_tpu_torch.scaler.fleet import DowntimeLadder

    stop_resume = {"downtime_s": {"shrink": 13.86, "grow": 10.68}}
    live = {"downtime_s": {"shrink": 4.2, "grow": 9.75},
            "adoption_gap_s": 0.734}
    art = cs.fleet_artifact(stop_resume, live)
    assert art == {"elastic_downtime_s": 13.86,
                   "elastic_downtime_multihost_s": 9.75,
                   "elastic_downtime_p2p_s": 0.734}
    path = tmp_path / "ladder.json"
    path.write_text(json.dumps(art))
    ladder = DowntimeLadder.from_artifact(str(path))
    assert (ladder.adopt_s, ladder.reform_s, ladder.stop_resume_s) \
        == (0.734, 9.75, 13.86)
    assert ladder.name == f"artifact:{path}"


def _canned_tournament(tmp_path):
    from edl_tpu_torch.scaler.fleet import (LEGACY, DowntimeLadder,
                                            tournament, trace_menu)

    path = tmp_path / "ladder.json"
    path.write_text(json.dumps({"elastic_downtime_s": 13.0,
                                "elastic_downtime_multihost_s": 9.0,
                                "elastic_downtime_p2p_s": 0.7}))
    ladder = DowntimeLadder.from_artifact(str(path))
    doc = tournament(traces=trace_menu(n_jobs=6, n_pools=2, ticks=20),
                     ladders=[ladder, LEGACY])
    return json.loads(json.dumps(doc)), ladder.name


def test_the_fleet_gates_on_a_canned_tournament(tmp_path):
    doc, name = _canned_tournament(tmp_path)
    ok = "fleet selftest: all checks passed\n"
    out = cs.fleet_gates(doc, name, ok, 1.5, 0.25)
    assert out["rows"] == cs.FLEET_ROWS == 24
    assert out["card_ladder_rows"] == 12
    assert set(out["policies"]) == {"fair-share", "preemptive-fair-share",
                                    "greedy-rebalance"}
    assert all(len(p["slo_attainment"]) == 4
               for p in out["policies"].values())
    bad = json.loads(json.dumps(doc))
    bad["rows"][3]["slo_attainment"] = float("nan")
    for args in ((bad, name, ok), (doc, "artifact:elsewhere", ok),
                 ({"rows": doc["rows"][:20], "fingerprint": "x"}, name, ok),
                 (doc, name, "fleet selftest: 1 FAILED: ['x']")):
        with pytest.raises(SystemExit):
            cs.fleet_gates(*args, 1.0, 0.0)


def test_the_fleet_run_as_a_child(tmp_path, monkeypatch):
    """FleetRun starts the CLI's selftest and tournament in one child and
    reads them at the end (a small tournament here)."""
    monkeypatch.setattr(cs, "FLEET_TOURNAMENT",
                        ["--jobs", "6", "--pools", "2", "--ticks", "20"])
    run = cs.FleetRun(tmp_path, {"elastic_downtime_s": 13.0,
                                 "elastic_downtime_multihost_s": 9.0,
                                 "elastic_downtime_p2p_s": 0.7})
    out = run.result()
    assert out["rows"] == 24 and out["card_ladder_rows"] == 12
    assert out["seconds"] >= out["wait_s"] >= 0
    assert json.loads((tmp_path / "ladder.json").read_text())[
        "elastic_downtime_s"] == 13.0


def test_the_scrape_gate_parses_prometheus_text():
    from edl_tpu_torch.obs import metrics

    reg = metrics.Registry()
    reg.counter("step_dcn_bytes", "bytes").inc(3 * 1000)
    reg.counter("step_dcn_bytes_other").inc(7)
    reg.register_stats("store", lambda: {"step_dcn_bytes": 5})
    text = reg.render()
    assert cs.scrape_value(text) == 3000.0
    assert cs.scrape_value("# TYPE x counter\nx 1\n") is None
    out = cs.scrape_gate([("int8", 0.0), ("int8", 1000.0), ("int8", 3000.0),
                          ("int8", 30000.0), ("dense", 30000.0 + 777),
                          ("gate", 30000.0 + 1777)], 1000, 30)
    assert out["in_int8_run"] == 3 and out["whole_multiples"] == 3
    assert out["steps_seen"] == [1, 3, 30]
    for readings, per_step in (
            ([("int8", 0.0), ("int8", 0.0)], 1000),
            ([("int8", 1500.0)], 1000),
            ([("int8", 1000.0), ("int8", 2500.0)], 1000),
            ([("int8", 1000.0)], 0),
            ([("int8", 31000.0)], 1000),     # beyond the run's 30 steps
            # the gate's sub-run alone (3 int8 steps in the same process)
            ([("gate", 1000.0), ("gate", 2000.0), ("gate", 3000.0)], 1000),
            ([("int8", 0.0), ("dense", 2000.0), (None, 3000.0)], 1000)):
        with pytest.raises(SystemExit):
            cs.scrape_gate(readings, per_step, 30)


def test_current_run_follows_the_ranks_json(tmp_path):
    names = ["int8", "dense", "gate"]
    assert cs.current_run(tmp_path, names) == "int8"
    (tmp_path / "int8.rank1.json").write_text("{}")
    assert cs.current_run(tmp_path, names) == "int8"
    (tmp_path / "int8.rank0.json").write_text("{}")
    assert cs.current_run(tmp_path, names) == "dense"
    for name in names[1:]:
        (tmp_path / f"{name}.rank0.json").write_text("{}")
    assert cs.current_run(tmp_path, names) is None


def test_the_scraper_reads_a_live_endpoint():
    from edl_tpu_torch.obs import metrics

    reg = metrics.Registry()
    scraper = cs.Scraper(cs.free_port())
    scraper.poll()   # nothing listens yet
    assert scraper.readings == [] and scraper.polls == 1
    srv = metrics.MetricsServer(reg, port=0)
    runs = iter(["int8", "int8", "int8", "int8", "int8", "dense",
                 "dense", "dense"])
    try:
        scraper = cs.Scraper(srv.port, lambda: next(runs))
        scraper.poll()    # the series is not there yet
        reg.counter("step_dcn_bytes").inc(4096)
        scraper.poll()
        scraper.poll()    # the run changed across the GET: dropped
        scraper.poll()
    finally:
        srv.close()
    assert [(r, v) for _, r, v in scraper.readings] == [
        ("int8", 4096.0), ("dense", 4096.0)]
    assert scraper.polls == 4 and scraper.seconds > 0


def test_the_redis_wiring_over_an_in_process_mini_redis(tmp_path):
    """Step (f)'s processes on the CPU: the discovery server and the
    registrars of two stub teachers over redis:// to a MiniRedis in this
    process; the server up and both registered (DiscoveryView.ready) and,
    once a client asks, both assigned; then E's registrar SIGKILLed (and
    E stopped): its key leaves the registry by its TTL and the discovery
    server drops it, within the step's deadline."""
    from edl_tpu_torch.coord.redis_store import RedisStore
    from edl_tpu_torch.coord.resp import MiniRedis
    from edl_tpu_torch.distill.discovery_client import DiscoveryClient
    from edl_tpu_torch.distill.teacher_server import TeacherServer

    def predict(feeds):
        out = {"logits": np.zeros((len(feeds["image"]), 4), np.float32)}
        return lambda: out

    mini = MiniRedis().start()
    servers = {n: TeacherServer(predict, host="127.0.0.1").start()
               for n in ("D", "E")}
    eps = {n: f"127.0.0.1:{s.port}" for n, s in servers.items()}
    view = client = None
    try:
        with cs.DistillPool(tmp_path, tmp_path / "ck",
                            prefix="test-redis") as pool:
            disc_ep = cs.redis_wiring(pool, mini.endpoint, eps, ("D", "E"))
            assert {"discovery_redis", "registrar_D_redis",
                    "registrar_E_redis"} <= set(pool.procs)
            view = cs.DiscoveryView(RedisStore(mini.endpoint, timeout=5.0),
                                    disc_ep, cs.REDIS_SERVICE)
            cs.wait_until(lambda: view.ready({eps["D"], eps["E"]}),
                          time.monotonic() + 90.0, "registration")
            assert view.balanced() is None   # no client asked yet
            client = DiscoveryClient(disc_ep, cs.REDIS_SERVICE).start()
            assert sorted(client.wait_for_servers(timeout=30.0)) \
                == sorted(eps.values())
            assert sorted(view.balanced()) == sorted(eps.values())
            t_kill = pool.kill("registrar_E_redis")
            servers["E"].stop()
            deadline = t_kill + cs.REDIS_DROP_DEADLINE_S
            expiry_s = cs.wait_until(
                lambda: eps["E"] not in view.registered(), deadline,
                "expiry") - t_kill
            cs.wait_until(lambda: view.dropped(eps["E"]), deadline, "drop")
            assert cs.REDIS_TTL_S * 0.5 < expiry_s < cs.REDIS_DROP_DEADLINE_S
            assert not view.assigned(eps["E"]) and view.assigned(eps["D"])
            assert view.registered() == [eps["D"]]
            assert view.balanced() == [eps["D"]]
    finally:
        if client is not None:
            client.stop()
        if view is not None:
            view.close()
        servers["D"].stop()
        mini.stop()


def test_wait_until_fails_at_its_deadline():
    assert cs.wait_until(lambda: True, time.monotonic() + 1, "x") > 0
    # a RuntimeError: on a DistillReader's source thread it ends the
    # reader's epoch with the error (step (d))
    with pytest.raises(RuntimeError, match="no never in time"):
        cs.wait_until(lambda: False, time.monotonic() + 0.05, "never")
