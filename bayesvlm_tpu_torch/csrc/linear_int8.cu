// W8A8 int8 linear layer: out = x . W^T + b, for the vision towers'
// attention projections (fused QKV, N = 3D, and the out-projection).
//
// Replaces the TPU kernel `_linear_int8_kernel` of
// bayesvlm_tpu/models/linear_int8.py (called through `linear_int8`).
// Same math, same rounding points (csrc/int8_gemm.cuh lists them):
//
//   x [M, K] (bf16 or fp32) -> fp32 -> per-row int8 -> int8 GEMM vs
//   Wq [N, K] (int32) -> fp32 dequant + bias -> x's dtype
//
// Design (first, simple version): two launches on the caller's stream,
// from one C entry point: quant_rows_kernel (x -> xq [M, K] int8 +
// xs [M]), then gemm_s8_kernel with the dequant epilogue. The int8 copy
// of x goes through device memory (2 x M*K bytes: 33.7 MB at ViT-L/14,
// M = 16448, K = 1024, ~0.010 ms). The output may be written as `chunk`-
// wide contiguous blocks, so the fused QKV product yields contiguous q,
// k and v for the attention kernel without a copy.
//
// What bounds it on an H100, at ViT-L/14: QKV (N = 3072) does 2*M*K*N =
// 103.5 G int8 operations, 0.052 ms at 1,979 TOP/s, against 138 MB,
// 0.041 ms at 3.35 TB/s: the operations. The out-projection (N = 1024)
// moves 68.4 MB, 0.020 ms, against 34.5 G operations, 0.017 ms: the
// bytes. This version stays above both: the products run on mma.sync fed
// by 32-bit shared-memory loads, and the quantize is a separate pass.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include "int8_gemm.cuh"

namespace {

using namespace bvt_int8;

template <typename T>
int run(const void* x, int M, int K, int N, const int8_t* wq, const float* s,
        const float* b, int chunk, int8_t* xq, float* xs, void* out,
        cudaStream_t stream) {
  cudaError_t err = quant_rows<T>(static_cast<const T*>(x), M, K, nullptr,
                                  nullptr, 0.f, xq, xs, stream);
  if (err != cudaSuccess) return err;
  return gemm_s8<T>(xq, xs, wq, s, b, nullptr, static_cast<T*>(out), M, N, K,
                    kNone, chunk, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). out is written as N/chunk
// contiguous [M, chunk] blocks. xq, xs: scratch of M*K and M elements.
// Returns a cudaError_t (0 = launched).
int bvt_linear_int8(const void* x, int dtype, int M, int K, int N,
                    const int8_t* wq, const float* s, const float* b, int chunk,
                    int8_t* xq, float* xs, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, M, K, N, wq, s, b, chunk, xq, xs, out, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, M, K, N, wq, s, b, chunk, xq, xs, out, st);
  return cudaErrorInvalidValue;
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
