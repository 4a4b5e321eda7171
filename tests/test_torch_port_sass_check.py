"""chip_smoke.py's check of the register contract of wgmma (HGMMA in SASS), on
hand-written listings in cuobjdump's format: a kernel that keeps the contract,
and one fault of each kind the check names."""

import pytest

import chip_smoke

HEAD = "\t\tFunction : _Z6kernelv\n"


def _listing(*instructions):
    return HEAD + "".join(f"        /*{16 * i:04x}*/                   {ins} ;"
                          f"                    /* 0x000000000000000000 */\n"
                          for i, ins in enumerate(instructions))


KEPT = (
    "F2FP.BF16.F32.PACK_AB R152, R25, R24",
    "F2FP.BF16.F32.PACK_AB R153, R27, R26",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8].tnspB, R88, gsb0",
    "HGMMA.64x64x16.F32.BF16 R88, R156, gdesc[UR12].tnspB, R88, gsb0",
    "IADD3 R3, R3, 0x1, RZ",
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",
    "FMUL R88, R88, R4",
    "STS.64 [R3], R88",
)


def test_a_kernel_that_keeps_the_contract_has_no_hazard():
    assert chip_smoke.wgmma_hazards(_listing(*KEPT)) == {"_Z6kernelv": []}


@pytest.mark.parametrize("fault,what", [
    # an A fragment rewritten while the product reads it
    (("WARPGROUP.ARRIVE", "HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88, gsb0",
      "F2FP.BF16.F32.PACK_AB R154, R1, R2", "WARPGROUP.DEPBAR.LE gsb0, 0x0"), "writes R154"),
    # an accumulator read before the wait
    (("WARPGROUP.ARRIVE", "HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88, gsb0",
      "FMUL R4, R119, R5", "WARPGROUP.DEPBAR.LE gsb0, 0x0"), "reads R119"),
    # an operand written after the fence, before the product that reads it
    (("WARPGROUP.ARRIVE", "MOV R155, R7",
      "HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88, gsb0",
      "WARPGROUP.DEPBAR.LE gsb0, 0x0"), "R155 written after the fence"),
    # a wait for all but one group leaves the product in flight
    (("WARPGROUP.ARRIVE", "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0",
      "WARPGROUP.DEPBAR.LE gsb0, 0x1", "LDS.64 R87, [R3]"), "writes R87"),
])
def test_each_fault_is_named(fault, what):
    found = chip_smoke.wgmma_hazards(_listing(*fault))["_Z6kernelv"]
    assert len(found) == 1 and what in found[0]


def test_functions_without_hgmma_are_not_listed():
    assert chip_smoke.wgmma_hazards(_listing("FMUL R4, R119, R5", "EXIT")) == {}
