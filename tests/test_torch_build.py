"""``kernels/_build.py``'s host-side helpers, on the CPU: reading ptxas's
``-Xptxas -v`` report (registers, spills, stack, static shared memory)
per kernel, as ``chip_smoke.py`` prints it beside the kernels' times."""

import pytest

from repro_torch.kernels._build import ptxas_report

_WGMMA = (
    "ptxas info    : 0 bytes gmem\n"
    "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__d1fb6f4a_12_"
    "attention_cu_72d1f3ed2tc22flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap"
    "_stS2_S2_Pfiiiiif' for 'sm_90a'\n"
    "ptxas info    : Function properties for _ZN45_GLOBAL__N__d1fb6f4a_12_"
    "attention_cu_72d1f3ed2tc22flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap"
    "_stS2_S2_Pfiiiiif\n"
    "    40 bytes stack frame, 36 bytes spill stores, 44 bytes spill loads\n"
    "ptxas info    : Used 168 registers, used 1 barriers, 40 bytes "
    "cumulative stack size\n"
    "ptxas info    : Compile time = 449.947 ms\n")
_F32 = (
    "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__d1fb6f4a_12_"
    "attention_cu_72d1f3ed16flash_fwd_kernelILi32EfEEvPKT0_S3_S3_Pfiiiiif' "
    "for 'sm_90a'\n"
    "ptxas info    : Function properties for _ZN45_GLOBAL__N__d1fb6f4a_12_"
    "attention_cu_72d1f3ed16flash_fwd_kernelILi32EfEEvPKT0_S3_S3_Pfiiiiif\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 128 registers, used 1 barriers\n")
_SMEM = (
    "ptxas info    : Compiling entry function '_Z14monitor_kernelPKfPfi' for "
    "'sm_90a'\n"
    "ptxas info    : Used 32 registers, 384 bytes smem, 400 bytes cmem[0]\n")


_NS = "_GLOBAL__N__d1fb6f4a_10_monitor_cu_72d1f3ed"
_FLEET = (
    "ptxas info    : Compiling entry function '_ZN43" + _NS
    + "20monitor_fleet_kernelILi32ELi16ELi2ELb0ELb1EEEvPKfxPKiiiPfPiS4_' "
    "for 'sm_90a'\n"
    "ptxas info    : Used 96 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function '_ZN43" + _NS
    + "22batched_monitor_kernelI13__nv_bfloat16Li32ELi5EEEvPKT_iiNS_4Taps"
    "EifPfS6_S6_' for 'sm_90a'\n"
    "ptxas info    : Used 40 registers, used 1 barriers\n")


@pytest.mark.parametrize("log,want", [
    (_WGMMA, [{"kernel": "flash_fwd_wgmma_kernel<128>", "registers": 168,
               "spill_stores": 36, "spill_loads": 44, "stack": 40,
               "smem": 0}]),
    (_F32, [{"kernel": "flash_fwd_kernel<32,f>", "registers": 128,
             "spill_stores": 0, "spill_loads": 0, "stack": 0, "smem": 0}]),
    (_SMEM, [{"kernel": "monitor_kernel", "registers": 32,
              "spill_stores": 0, "spill_loads": 0, "stack": 0,
              "smem": 384}]),
    (_FLEET, [{"kernel": "monitor_fleet_kernel<32,16,2,0,1>",
               "registers": 96, "spill_stores": 0, "spill_loads": 0,
               "stack": 0, "smem": 0},
              {"kernel": "batched_monitor_kernel<__nv_bfloat16,32,5>",
               "registers": 40, "spill_stores": 0, "spill_loads": 0,
               "stack": 0, "smem": 0}]),
], ids=["wgmma-spills", "f32-template", "static-smem", "bool-and-type-args"])
def test_ptxas_report_reads_each_kernel(log, want):
    assert ptxas_report(log) == want


def test_ptxas_report_keeps_kernels_apart_in_order():
    """Each kernel's numbers stay with it in a report of several, and
    lines before the first entry are ignored."""
    got = ptxas_report("ptxas info    : Used 9 registers\n" + _WGMMA + _F32)
    assert [r["kernel"] for r in got] == ["flash_fwd_wgmma_kernel<128>",
                                          "flash_fwd_kernel<32,f>"]
    assert [(r["registers"], r["spill_stores"]) for r in got] == [
        (168, 36), (128, 0)]
