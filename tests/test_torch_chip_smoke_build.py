"""chip_smoke.py's build gate for the flash backward, on the CPU.

On a card the gate reads ptxas's log and the SASS of the built library
(cuobjdump) and fails unless each bf16 wgmma body holds wgmma (HGMMA) and
TMA loads (UTMALDG), spills nothing, and never writes a register that a
wgmma in flight reads as its A operand. Its parsers are plain Python, so
they are held here to logs and SASS written by hand in the tools' formats,
including the two clobbering patterns the gate exists for.
"""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

K2 = ("_ZN45_GLOBAL__N__da1476e7_12_flash_bwd_cu_a119745d17dkdv_wgmma_kernel"
      "ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iifi")
K3 = ("_ZN45_GLOBAL__N__da1476e7_12_flash_bwd_cu_a119745d13dq_fma_kernel"
      "ILi128EEEvPKfS2_S2_S2_S2_S2_PfS3_iiNS_7StridesEfi")


@pytest.mark.parametrize("mangled,name", [
    (K2, "dkdv_wgmma_kernel<64>"),
    (K3, "dq_fma_kernel<128>"),
    ("_Z16adam_fp32_kernelPfS_", "adam_fp32_kernel"),
    ("_Z3foov", "_Z3foov"),
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


def _sass(body: list[str]) -> str:
    """cuobjdump's layout: a function header, then one instruction a line
    at 16-byte addresses, each followed by its encoding comment."""
    lines = [f"\t\tFunction : {K2}"]
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     "   /* 0x000000000000 */")
        lines.append("                                            "
                     "/* 0x000000000000 */")
    return "\n".join(lines)


# A K2-like loop: the head at 0x10, the tile's second product reads its A
# operand from R8..R11, and its wait comes in the next turn of the loop.
_LOOP = [
    "LDSM.16.M88.4 R20, [R1]",                                # 0x00
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR9], R8",           # 0x10 head
    "HGMMA.64x64x16.F32.BF16 R56, gdesc[UR16], RZ, !UPT",     # 0x20
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",                          # 0x30
    "F2FP.BF16.F32.PACK_AB R8, R57, R56",                     # 0x40
    "HGMMA.64x64x16.F32.BF16 R88, R8, gdesc[UR8].tnspB, R88", # 0x50
    "IADD3 R2, R2, 0x1, RZ",                                  # 0x60
    "@!P0 BRA 0x10",                                          # 0x70
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",                          # 0x80
    "EXIT",                                                   # 0x90
]


def _hazards(body):
    (name, ins), = cs.sass_functions(_sass(body)).items()
    assert name == "dkdv_wgmma_kernel<64>"
    return cs.wgmma_a_hazards(ins)


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
    body[2] = "HGMMA.64x64x16.F32.BF16 R56, R20, gdesc[UR16], RZ, !UPT"
    body[4] = "F2FP.BF16.F32.PACK_AB R20, R57, R56"
    body[5] = "HGMMA.64x64x16.F32.BF16 R88, R20, gdesc[UR8].tnspB, R88"
    assert _hazards(body) == [("0x40", "F2FP.BF16.F32.PACK_AB R20, R57, R56")]


def test_bwd_tflops_counts_the_visible_pairs():
    # B=1, H=1, S=4, D=64, causal: 10 visible pairs; 4 products of
    # 2 * 64 flops a pair in 1 ms is 5.12e6 flop/s
    assert cs.bwd_tflops(4, 1.0, 1, 4, 1, 64, True) == pytest.approx(5.12e-6)
    assert cs.bwd_tflops(4, 1.0, 1, 4, 1, 64, False) == pytest.approx(8.192e-6)
    # the products each backward computes, as bound and TFLOP/s count them
    assert cs.BWD_PRODUCTS == {"flash_bwd_dkdv": 4, "flash_bwd_dq": 5,
                               "sdpa_bwd": 5}
