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
// Design: two launches on the caller's stream, from one C entry point:
// quant_rows_kernel (x -> xq [M, K] int8 + xs [M]), then the wgmma body
// of wgmma_gemm.cuh (persistent, warp-specialised, a TMA ring of 5
// stages, ping-pong 128 x 128 tiles; Wq [N, K] is already the K-major B^T
// wgmma reads) with the dequantising epilogue EpiDequant (dequant and
// bias). The
// output is written as `N / chunk` contiguous [M, chunk] blocks, so the
// fused QKV product yields contiguous q, k and v for the attention kernel
// without a copy: one TMA store map over [N / chunk, M, chunk] where each
// chunk is a whole number of epilogue boxes (32 fp32 or 64 bf16 columns;
// at ViT-L/14 chunk = 1024), else plain stores from each box (chosen at
// launch from the shape). The int8 copy of x goes through device memory
// (2 x M*K bytes: 33.7 MB at ViT-L/14, M = 16448, K = 1024, ~0.010 ms).
//
// What bounds it on an H100, at ViT-L/14: QKV (N = 3072) does 2*M*K*N =
// 103.5 G int8 operations, 0.052 ms at 1,979 TOP/s, against 138 MB,
// 0.041 ms at 3.35 TB/s: the operations. The out-projection (N = 1024)
// moves 68.4 MB, 0.020 ms, against 34.5 G operations, 0.017 ms: the
// bytes. The quantize is a separate pass over x.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include "int8_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace bvt_int8;

template <typename T>
using Epi = bvt_wgmma::EpiDequant<T, false>;

template <typename T>
int run(const void* x, int M, int K, int N, const int8_t* wq, const float* s,
        const float* b, int chunk, int8_t* xq, float* xs, void* out,
        cudaStream_t stream) {
  if (K % 16 != 0) return cudaErrorInvalidValue;
  const cudaError_t err = quant_rows<T>(static_cast<const T*>(x), M, K, nullptr,
                                        nullptr, 0.f, xq, xs, stream);
  if (err != cudaSuccess) return err;
  typename Epi<T>::Params p = {};
  p.xs = xs;
  p.ws = s;
  p.bias = b;
  p.out = static_cast<T*>(out);
  p.chunk = chunk;
  return bvt_wgmma::wgmma_gemm_dequant<Epi<T>>(xq, wq, M, N, K, p, stream);
}

template <typename T>
int resources(int* out) {
  return bvt_wgmma::resources<Epi<T>>(out);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). out is written as N/chunk
// contiguous [M, chunk] blocks. xq, xs: scratch of M*K and M elements.
// Returns a cudaError_t (0 = launched) or a tensor-map / register code of
// wgmma_gemm.cuh (bvt_error_string).
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

// the GEMM kernel's dynamic shared memory, blocks an SM and registers a
// thread at launch for dtype's output into out[0..2] (the warpgroups then
// move to 40 / 232 with setmaxnreg), and whether an output of N columns in
// chunks of `chunk` goes out by the TMA (1) or by plain stores (0) into
// out[3]. Returns 0 or a cudaError_t.
int bvt_linear_int8_resources(int dtype, int N, int chunk, int* out) {
  if (chunk <= 0 || N % chunk != 0) return cudaErrorInvalidValue;
  if (dtype == 0) {
    out[3] = bvt_wgmma::tma_output<float>(N, chunk);
    return resources<float>(out);
  }
  if (dtype == 1) {
    out[3] = bvt_wgmma::tma_output<__nv_bfloat16>(N, chunk);
    return resources<__nv_bfloat16>(out);
  }
  return cudaErrorInvalidValue;
}

const char* bvt_error_string(int err) { return bvt_wgmma::error_string(err); }

}  // extern "C"
