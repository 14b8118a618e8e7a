"""`bayesvlm_tpu_torch.breakdown`'s kernel groups, on the CPU: each
representative demangled kernel name (as torch.profiler reports it) lands
in its own group, the int8 lane's and the block lane's wgmma GEMMs ahead
of the GEMM probes' row and the cuBLAS row whose pattern `gemm` would
otherwise take them."""

import pytest

from bayesvlm_tpu_torch.breakdown import GROUPS, _group

_DEQUANT = ("void bvt_wgmma::wgmma_gemm_kernel<1, 128, 128, 5, 1, "
            "bvt_wgmma::EpiDequant<{out}, {res}> >(CUtensorMap, CUtensorMap, "
            "CUtensorMap, int, int, int, bvt_wgmma::EpiDequant<{out}, {res}>::Params)")

# the block lane's projections (csrc/bf16_gemm.cuh), not the GEMM probes'
_BIAS = ("void bvt_wgmma::wgmma_gemm_kernel<2, 128, 128, 6, 1, bvt_wgmma::EpiBias<{res}> >"
         "(CUtensorMap, CUtensorMap, CUtensorMap, int, int, int, "
         "bvt_wgmma::EpiBias<{res}>::Params)")


@pytest.mark.parametrize("name,group", [
    (_DEQUANT.format(out="float", res="false"), "int8 GEMMs"),
    (_DEQUANT.format(out="__nv_bfloat16", res="true"), "int8 GEMMs"),
    (_BIAS.format(res="false"), "block GEMMs"),
    (_BIAS.format(res="true"), "block GEMMs"),
    ("void bvt_wgmma::wgmma_gemm_kernel<1, 128, 128, 6, 1, bvt_wgmma::EpiRaw>"
     "(CUtensorMap, CUtensorMap, CUtensorMap, int, int, int, bvt_wgmma::EpiRaw::Params)",
     "GEMM probes"),
    ("void bvt_int8::quant_rows_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int, "
     "float const*, float const*, float, signed char*, float*)", "int8 quantize"),
    ("void bvt_int8::act_quant_rows_kernel<1>(float const*, int, signed char*, float*)",
     "int8 quantize"),
    ("void bvt_attn::mha_mma_kernel<64, 0, 1, 1, 1, 0>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, float)",
     "attention kernel"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", "GEMMs (cuBLAS)"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>"
     "(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8::Params)",
     "GEMMs (cuBLAS)"),
    ("Memcpy HtoD (Pageable -> Device)", "H2D copy"),
])
def test_group_of_each_kernel(name, group):
    assert _group(name).startswith(group), (_group(name), group)


def test_groups_are_distinct():
    labels = [label for label, _ in GROUPS]
    assert len(labels) == len(set(labels))
