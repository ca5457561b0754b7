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
from pathlib import Path

import numpy as np
import pytest

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
