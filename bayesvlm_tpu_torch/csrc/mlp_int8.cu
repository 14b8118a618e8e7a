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
// Design: four launches on the caller's stream, from one C entry point:
//   1. quant_rows_kernel: x -> xq [M, D] int8 + xs [M] (LN inside)
//   2. GEMM1, the wgmma body of wgmma_gemm.cuh (persistent, warp-
//      specialised, a TMA ring of 5 stages, ping-pong 128 x 128 tiles;
//      W1q [F, D] is already the K-major B^T wgmma reads) with the
//      dequantising epilogue EpiDequant<float, false>: xq . W1q^T ->
//      dequant + bias -> h [M, F] fp32 (scratch `a`)
//   3. act_quant_rows_kernel: act(h) -> aq [M, F] int8 + as [M], one block
//      a row: the activation, the row's absmax and the quantize
//   4. GEMM2, EpiDequant<T, fused>: aq . W2q^T -> dequant + bias (+ x when
//      fused) -> out [M, D]
// The row requantize needs each row's absmax over all F activations before
// the second product may start, and a Hopper block holds at most 13 fp32
// rows of F = 4096: too few for the tensor cores. So the fp32 hidden layer
// goes through device memory once each way: at ViT-L/14 (M = 64*257 =
// 16448, D = 1024, F = 4096) h written and read back (2 x 269.5 MB), aq
// written and read (2 x 67.4 MB), xq written and read (2 x 16.8 MB):
// ~707 MB, ~0.21 ms at 3.35 TB/s, beside the function's own 75.8 MB.
// The activation sits in the row pass, not in GEMM1's epilogue: there the
// accurate tanhf runs on one consumer warpgroup (4 warps an SM) and
// outlasts the other consumer's mainloop, so ping-pong no longer hides it
// (with each row's absmax taken by atomics in that epilogue and the
// requantize elementwise, GEMM1 took 0.294 ms and the sublayer 0.625 ms;
// this way 0.503, the same bits: PERF.md). The row pass runs the same
// operations on the same values as a per-row quantize of act(h).
//
// What bounds it on an H100: 4*M*D*F = 275.9 G int8 operations, 0.139 ms
// at 1,979 TOP/s (the 75.8 MB that the function must move take 0.023 ms),
// so the operations; the hidden round trip above costs more than that.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include "int8_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace bvt_int8;
using bvt_wgmma::EpiDequant;
using bvt_wgmma::wgmma_gemm_dequant;

using Gemm1 = EpiDequant<float, false>;  // h = dequant + bias, fp32
template <typename T, bool RESIDUAL>
using Gemm2 = EpiDequant<T, RESIDUAL>;  // + x when fused

// out = dequant(aq . W2q^T) + b2, + x with RESIDUAL
template <typename T, bool RESIDUAL>
int gemm2(const int8_t* aq, const float* as, const int8_t* w2q, const float* s2,
          const float* b2, const T* x, T* out, int M, int D, int F, cudaStream_t stream) {
  typename Gemm2<T, RESIDUAL>::Params p = {};
  p.xs = as;
  p.ws = s2;
  p.bias = b2;
  p.residual = x;
  p.out = out;
  p.chunk = D;
  return wgmma_gemm_dequant<Gemm2<T, RESIDUAL>>(aq, w2q, M, D, F, p, stream);
}

template <typename T>
int run(const void* x, int M, int D, int F, const float* ln_w,
        const float* ln_b, float ln_eps, const int8_t* w1q, const float* s1,
        const float* b1, const int8_t* w2q, const float* s2, const float* b2,
        int act, int8_t* xq, float* xs, float* a, int8_t* aq, float* as,
        void* out, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (D % 16 != 0 || F % 16 != 0) return cudaErrorInvalidValue;
  int err = quant_rows<T>(xt, M, D, ln_w, ln_b, ln_eps, xq, xs, stream);
  if (err != cudaSuccess) return err;
  typename Gemm1::Params p1 = {};
  p1.xs = xs;
  p1.ws = s1;
  p1.bias = b1;
  p1.out = a;
  p1.chunk = F;
  err = wgmma_gemm_dequant<Gemm1>(xq, w1q, M, F, D, p1, stream);
  if (err == cudaSuccess) err = act_quant_rows(a, M, F, act, aq, as, stream);
  if (err != cudaSuccess) return err;
  // the fused variant adds the pre-LN input x back in fp32
  T* o = static_cast<T*>(out);
  return ln_w != nullptr ? gemm2<T, true>(aq, as, w2q, s2, b2, xt, o, M, D, F, stream)
                         : gemm2<T, false>(aq, as, w2q, s2, b2, nullptr, o, M, D, F, stream);
}

// registers at launch: the larger of GEMM2's two variants
template <typename T>
int gemm2_resources(int* out) {
  int a[3], b[3];
  int err = bvt_wgmma::resources<Gemm2<T, false>>(a);
  if (err == 0) err = bvt_wgmma::resources<Gemm2<T, true>>(b);
  if (err != 0) return err;
  out[0] = a[0] > b[0] ? a[0] : b[0];
  out[1] = a[1] < b[1] ? a[1] : b[1];
  out[2] = a[2] > b[2] ? a[2] : b[2];
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). ln_w/ln_b null: the plain
// variant; set: the fused pre-LN + residual variant. act: 1 = tanh-GELU,
// 2 = quick-GELU. xq, xs, a, aq, as: scratch of M*D, M, M*F (fp32), M*F,
// M elements. Returns a cudaError_t (0 = launched) or a tensor-map /
// register code of wgmma_gemm.cuh (bvt_error_string).
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

// the GEMM kernels' dynamic shared memory, blocks an SM and registers a
// thread at launch (GEMM1's, then GEMM2's for dtype's output, the larger
// of its plain and fused variants) into out[0..3];
// the warpgroups then move to 40 / 232 registers with setmaxnreg. Returns
// 0 or a cudaError_t.
int bvt_mlp_int8_resources(int dtype, int* out) {
  int g1[3], g2[3];
  int err = bvt_wgmma::resources<Gemm1>(g1);
  if (err == 0)
    err = dtype == 0   ? gemm2_resources<float>(g2)
          : dtype == 1 ? gemm2_resources<__nv_bfloat16>(g2)
                       : static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  out[0] = g1[0] > g2[0] ? g1[0] : g2[0];
  out[1] = g1[1] < g2[1] ? g1[1] : g2[1];
  out[2] = g1[2];
  out[3] = g2[2];
  return 0;
}

const char* bvt_error_string(int err) { return bvt_wgmma::error_string(err); }

}  // extern "C"
