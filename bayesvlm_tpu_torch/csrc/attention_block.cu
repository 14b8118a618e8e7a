// The whole pre-LN attention sublayer of the vision towers:
//
//   out = x + out_proj(MHA(LN(x)))
//
// Replaces the TPU kernel `_mha_block_kernel` of
// bayesvlm_tpu/models/attention_pallas.py (called through
// `fused_attention_block`). Same function, same rounding points
// (attention_pallas.py:241-287):
//   1. LayerNorm in fp32, two-pass: mu = mean(x), var = mean((x - mu)^2),
//      (x - mu) * rsqrt(var + eps) * w + b, rounded once to the compute
//      dtype;
//   2. q, k, v = h . W^T accumulated in fp32, plus the compute-dtype bias
//      in fp32, each rounded ONCE (the per-op lane rounds the product and
//      then the bias add);
//   3. the attention core of csrc/attention.cuh (one-block schedule);
//   4. the out-projection the same way as 2;
//   5. x + out: two compute-dtype values summed in fp32, rounded once.
//
// Design (first version). The TPU kernel runs one program per batch row
// and keeps the LN output, q, k, v and the attention output in VMEM,
// with the four [D, D] weights resident across the grid. That does not
// fit Hopper: at ViT-L the four bf16 weights are 8 MiB against 227 KB of
// shared memory a block, and one program per batch row would put 64
// blocks on 132 SMs. So the sublayer is a chain of four hand-written
// launches over all B*T rows, on the caller's stream, from one C entry:
//   ln_rows_kernel    one row a block: h = LN(x), in the compute dtype;
//   gemm (QKV)        h [M, D] . [Wq; Wk; Wv]^T + bias, N = 3D, written as
//                     contiguous q, k, v (csrc/bf16_gemm.cuh; the three
//                     weights are read in place, no concatenated copy);
//   mha_kernel        the attention core, scores in shared memory;
//   gemm (out-proj)   a . Wo^T + bo, then + x, rounded once more.
// h, q, k, v and the attention output go through device memory: 5 x M x
// D values, 168 MB written and read again per layer at ViT-L, B=64 in
// bf16 (M = 16448, D = 1024). Keeping them on chip is later work.
//
// What bounds it on an H100, at ViT-L/14, B=64, bf16: the four products
// (8 * M * D^2 = 138 G operations) and the attention core (4 * B * H *
// T^2 * Dh = 17.3 G): 1.553e11 operations, 0.157 ms at 989 TFLOP/s,
// against 75.8 MB read and written by the function (x, out, the four
// weights), 0.023 ms: the operations. This version stays above both:
// the products run on mma.sync (not wgmma) fed by ldmatrix, and the
// attention core on the CUDA cores.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include "attention.cuh"
#include "bf16_gemm.cuh"

namespace {

using bvt_gemm::Stack;
using bvt_int8::block_reduce;
using bvt_int8::from_f;
using bvt_int8::to_f;

constexpr int LT = 256;  // threads of a LayerNorm block

// One row per block: y[m] = LN(x[m]) rounded to T, in the order of
// `_mha_block_kernel` (and of int8_gemm.cuh's `quant_rows_kernel`). The
// row's fp32 copy lives in dynamic shared memory (K floats); each thread
// reads back only what it wrote.
template <typename T>
__global__ void __launch_bounds__(LT)
ln_rows_kernel(const T* __restrict__ x, int K, const float* __restrict__ w,
               const float* __restrict__ b, float eps, T* __restrict__ y) {
  extern __shared__ float ln_row[];
  __shared__ float red[32];
  const long m = blockIdx.x;
  const T* xr = x + m * K;
  float s = 0.f;
  for (int k = threadIdx.x; k < K; k += LT) {
    const float v = to_f(xr[k]);
    ln_row[k] = v;
    s += v;
  }
  const float mu = __fdiv_rn(block_reduce<false>(s, red), static_cast<float>(K));
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += LT) {
    const float d = __fsub_rn(ln_row[k], mu);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(block_reduce<false>(ss, red), static_cast<float>(K));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  T* yr = y + m * K;
  for (int k = threadIdx.x; k < K; k += LT)
    yr[k] = from_f<T>(
        __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(ln_row[k], mu), inv), w[k]), b[k]));
}

template <typename T>
int run(const void* x, const float* ln_w, const float* ln_b, float eps, const void* wq,
        const void* bq, const void* wk, const void* bk, const void* wv, const void* bv,
        const void* wo, const void* bo, int B, int seq, int D, int heads, float scale,
        void* h, void* qkv, void* attn, void* out, cudaStream_t stream) {
  const long M = (long)B * seq;
  if (B < 0 || seq <= 0 || heads <= 0 || D <= 0 || D > bvt_int8::kMaxRowFloats ||
      D % heads != 0 || M > 0x7fffffffL)
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const T* xt = static_cast<const T*>(x);
  T* ht = static_cast<T*>(h);
  T* q = static_cast<T*>(qkv);
  T* k = q + M * D;
  T* v = k + M * D;
  T* at = static_cast<T*>(attn);

  ln_rows_kernel<T><<<(unsigned)M, LT, D * sizeof(float), stream>>>(xt, D, ln_w, ln_b,
                                                                   eps, ht);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const Stack<T> w_qkv{static_cast<const T*>(wq), static_cast<const T*>(wk),
                       static_cast<const T*>(wv), static_cast<const T*>(bq),
                       static_cast<const T*>(bk), static_cast<const T*>(bv), D};
  err = bvt_gemm::gemm(ht, w_qkv, static_cast<const T*>(nullptr), q, (int)M, 3 * D, D,
                       stream);
  if (err != cudaSuccess) return err;

  err = bvt_attn::launch_head_dim<T, bvt_attn::kOneBlock>(q, k, v, at, B, seq, heads,
                                                          D / heads, scale, stream);
  if (err != cudaSuccess) return err;

  const T* wot = static_cast<const T*>(wo);
  const T* bot = static_cast<const T*>(bo);
  const Stack<T> w_out{wot, wot, wot, bot, bot, bot, D};
  return bvt_gemm::gemm(at, w_out, xt, static_cast<T*>(out), (int)M, D, D, stream);
}

}  // namespace

extern "C" {

// x, out: [B, seq, D]; ln_w, ln_b: [D] fp32; wq, wk, wv, wo: [D, D] in
// torch's [out, in] layout and bq, bk, bv, bo: [D], all in x's dtype
// (0 = float32, 1 = bfloat16); D a multiple of 8 and of heads, D / heads
// in {16, 64, 80}. Scratch: h and attn [B*seq, D], qkv [3, B*seq, D].
// Every pointer 16-byte aligned. Returns a cudaError_t (0 = launched).
int bvt_attention_block(const void* x, const float* ln_w, const float* ln_b, float eps,
                        const void* wq, const void* bq, const void* wk, const void* bk,
                        const void* wv, const void* bv, const void* wo, const void* bo,
                        int B, int seq, int D, int heads, int dtype, float scale,
                        void* h, void* qkv, void* attn, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, wo, bo, B, seq, D,
                      heads, scale, h, qkv, attn, out, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, wo, bo, B,
                              seq, D, heads, scale, h, qkv, attn, out, s);
  return cudaErrorInvalidValue;
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
