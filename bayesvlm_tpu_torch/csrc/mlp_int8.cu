// W8A8 int8 MLP sublayer: out = fc2(act(fc1(x))), or with the fused
// pre-LN variant out = x + fc2(act(fc1(LN(x)))), for the vision towers.
//
// Replaces the TPU kernel `_mlp_int8_kernel` of
// bayesvlm_tpu/models/mlp_int8.py (called through `mlp_int8`). Same
// math, same rounding points (csrc/int8_gemm.cuh lists them):
//
//   x [M, D] (bf16 or fp32) -> fp32 (-> fp32 LayerNorm) -> per-row int8
//   -> int8 GEMM vs W1q [F, D] (int32) -> dequant + bias -> tanh-GELU or
//   quick-GELU in fp32 -> per-row int8 -> int8 GEMM vs W2q [D, F]
//   -> dequant + bias (-> + x in fp32) -> one cast to x's dtype
//
// Weights come quantized per output channel (bits 8: +-127; bits 4:
// +-7 in int8 storage, the same kernel).
//
// Design (first, simple version): four launches on the caller's stream,
// from one C entry point:
//   1. quant_rows_kernel: x -> xq [M, D] int8 + xs [M] (LN inside)
//   2. gemm_s8_kernel:    xq . W1q^T -> a [M, F] fp32, activation applied
//   3. quant_rows_kernel: a -> aq [M, F] int8 + as [M]
//   4. gemm_s8_kernel:    aq . W2q^T -> out [M, D], + x when fused
// The row requantize needs each row's absmax over all F fp32 activations
// before the second product may start. The TPU kept a [512, F] tile in
// VMEM; a Hopper block has 227 KB, i.e. at most 13 fp32 rows of F=4096,
// too few rows for the tensor cores. So the fp32 activations go through
// device memory. Its cost, at ViT-L/14 (M = 64*257 = 16448, D = 1024,
// F = 4096): a written and read back (2 x 269.5 MB), aq written and read
// (2 x 67.4 MB), xq written and read (2 x 16.8 MB): ~707 MB, ~0.21 ms at
// 3.35 TB/s, beside the function's own 75.8 MB.
//
// What bounds it on an H100: 4*M*D*F = 275.9 G int8 operations, 0.139 ms
// at 1,979 TOP/s (the 75.8 MB that the function must move take 0.023 ms),
// so the operations. This version stays above that: the hidden round
// trip above costs more than the bound, and the products run on
// mma.sync fed by 32-bit shared-memory loads, not wgmma. The next steps:
// keep a row block's activations on chip (a two-pass absmax, or a
// cluster's distributed shared memory), then wgmma with TMA.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include "int8_gemm.cuh"

namespace {

using namespace bvt_int8;

template <typename T>
int run(const void* x, int M, int D, int F, const float* ln_w,
        const float* ln_b, float ln_eps, const int8_t* w1q, const float* s1,
        const float* b1, const int8_t* w2q, const float* s2, const float* b2,
        int act, int8_t* xq, float* xs, float* a, int8_t* aq, float* as,
        void* out, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  cudaError_t err = quant_rows<T>(xt, M, D, ln_w, ln_b, ln_eps, xq, xs, stream);
  if (err != cudaSuccess) return err;
  err = gemm_s8<float>(xq, xs, w1q, s1, b1, nullptr, a, M, F, D, act, F, stream);
  if (err != cudaSuccess) return err;
  err = quant_rows<float>(a, M, F, nullptr, nullptr, 0.f, aq, as, stream);
  if (err != cudaSuccess) return err;
  // the fused variant adds the pre-LN input x back in fp32
  return gemm_s8<T>(aq, as, w2q, s2, b2, ln_w != nullptr ? xt : nullptr,
                    static_cast<T*>(out), M, D, F, kNone, D, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). ln_w/ln_b null: the plain
// variant; set: the fused pre-LN + residual variant. act: 1 = tanh-GELU,
// 2 = quick-GELU. xq, xs, a, aq, as: scratch of M*D, M, M*F (fp32), M*F,
// M elements. Returns a cudaError_t (0 = launched).
int bvt_mlp_int8(const void* x, int dtype, int M, int D, int F,
                 const float* ln_w, const float* ln_b, float ln_eps,
                 const int8_t* w1q, const float* s1, const float* b1,
                 const int8_t* w2q, const float* s2, const float* b2, int act,
                 int8_t* xq, float* xs, float* a, int8_t* aq, float* as,
                 void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act != kGeluTanh && act != kQuickGelu) return cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(x, M, D, F, ln_w, ln_b, ln_eps, w1q, s1, b1, w2q, s2, b2,
                      act, xq, xs, a, aq, as, out, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, M, D, F, ln_w, ln_b, ln_eps, w1q, s1, b1, w2q,
                              s2, b2, act, xq, xs, a, aq, as, out, s);
  return cudaErrorInvalidValue;
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
