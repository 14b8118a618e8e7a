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
//   3. the attention core (one-block schedule): in bf16 the tensor-core
//      body of csrc/attention_mma.cuh, in fp32 the CUDA-core body of
//      csrc/attention.cuh;
//   4. the out-projection the same way as 2;
//   5. x + out: two compute-dtype values summed in fp32, rounded once.
//
// Design. The TPU kernel runs one program per batch row and keeps the LN
// output, q, k, v and the attention output in VMEM, with the four [D, D]
// weights resident across the grid. That does not fit Hopper: at ViT-L
// the four bf16 weights are 8 MiB against 227 KB of shared memory a
// block, and one program per batch row would put 64 blocks on 132 SMs.
// So the sublayer is a chain of four hand-written launches over all B*T
// rows, on the caller's stream, from one C entry:
//   ln_rows_kernel    one row a block: h = LN(x), in the compute dtype;
//   gemm (QKV)        h [M, D] . [Wq; Wk; Wv]^T + bias, N = 3D, written as
//                     contiguous q, k, v (csrc/bf16_gemm.cuh; the three
//                     weights are read in place, no concatenated copy);
//   attention core    launch_head_dim<T, kOneBlock> (attention_mma.cuh):
//                     mha_mma_kernel in bf16, mha_kernel in fp32;
//   gemm (out-proj)   a . Wo^T + bo, then + x, rounded once more.
// In bf16 both GEMMs run the persistent, warp-specialised wgmma body of
// csrc/wgmma_gemm.cuh (TMA ring of 6 stages, ping-pong 128 x 128 tiles,
// m64n128k16 with the weights read K-major in place) with the EpiBias
// epilogue: the bias added to the fp32 sums and rounded once (QKV: three
// weights, three tensor maps, a tile column in one part; q, k, v stored
// by the TMA), and in the out-projection the residual x read in the
// epilogue and added to the rounded product, rounded once more. fp32
// keeps a CUDA-core GEMM (wgmma has no fp32 operands). h, q, k, v and the
// attention output go through device memory: 5 x M x D values, 168 MB
// written and read again per layer at ViT-L, B=64 in bf16 (M = 16448,
// D = 1024). Keeping them on chip is later work.
//
// What bounds it on an H100, at ViT-L/14, B=64, bf16: the four products
// (8 * M * D^2 = 138 G operations) and the attention core (4 * B * H *
// T^2 * Dh = 17.3 G): 1.553e11 operations, 0.157 ms at 989 TFLOP/s,
// against 75.8 MB read and written by the function (x, out, the four
// weights), 0.023 ms: the operations. Above that: the GEMMs' own
// distance from the peak (the wgmma body reached ~600 TFLOP/s on the
// GEMM probe, PERF.md), the bf16 attention core on mma.sync (two sweeps
// over the keys; attention_mma.cuh), the LN pass, and the round trips of
// h, q, k, v and the attention output through device memory.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include "attention_mma.cuh"
#include "bf16_gemm.cuh"

namespace {

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

// the sublayer's projection: out = round(a . W^T + bias) (+ residual), W
// the `parts` weights w[p] side by side (bf16_gemm.cuh)
template <typename T>
int project(const void* a, const void* const* w, const void* const* bias, int parts,
            const void* residual, void* out, int M, int N, int K, cudaStream_t stream) {
  if (parts < 1 || parts > 3) return cudaErrorInvalidValue;
  const T* wt[3] = {};
  const T* bt[3] = {};
  for (int p = 0; p < parts; ++p) {
    wt[p] = static_cast<const T*>(w[p]);
    bt[p] = static_cast<const T*>(bias[p]);
  }
  return bvt_gemm::gemm(static_cast<const T*>(a), wt, bt, parts,
                        static_cast<const T*>(residual), static_cast<T*>(out), M, N, K, stream);
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
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const void* w_qkv[3] = {wq, wk, wv};
  const void* b_qkv[3] = {bq, bk, bv};
  err = project<T>(ht, w_qkv, b_qkv, 3, nullptr, q, (int)M, D, D, stream);
  if (err != cudaSuccess) return err;

  err = bvt_attn::launch_head_dim<T, bvt_attn::kOneBlock>(q, k, v, at, B, seq, heads,
                                                          D / heads, scale, stream);
  if (err != cudaSuccess) return err;

  return project<T>(at, &wo, &bo, 1, x, out, (int)M, D, D, stream);
}

}  // namespace

extern "C" {

// x, out: [B, seq, D]; ln_w, ln_b: [D] fp32; wq, wk, wv, wo: [D, D] in
// torch's [out, in] layout and bq, bk, bv, bo: [D], all in x's dtype
// (0 = float32, 1 = bfloat16); D a multiple of 8 and of heads, D / heads
// in {16, 64, 80}. Scratch: h and attn [B*seq, D], qkv [3, B*seq, D].
// Every pointer 16-byte aligned. Returns a cudaError_t (0 = launched) or a
// tensor-map / register code of wgmma_gemm.cuh (bvt_error_string).
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

// One projection of the sublayer alone (the tests and chip_smoke.py):
// out = round(a . W^T + bias), W the `parts` (1-3) [N, K] weights w0, w1,
// w2 side by side and out `parts` contiguous [M, N] blocks; with a
// residual (parts 1), out = round(residual + that). Same dtypes and rules
// as above.
int bvt_attention_block_gemm(const void* a, const void* w0, const void* w1, const void* w2,
                             const void* b0, const void* b1, const void* b2, int parts,
                             const void* residual, void* out, int M, int N, int K, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* w[3] = {w0, w1, w2};
  const void* b[3] = {b0, b1, b2};
  if (dtype == 0) return project<float>(a, w, b, parts, residual, out, M, N, K, s);
  if (dtype == 1) return project<__nv_bfloat16>(a, w, b, parts, residual, out, M, N, K, s);
  return cudaErrorInvalidValue;
}

// the bf16 GEMM (residual 0: QKV, 1: the out-projection with the residual):
// dynamic shared memory, blocks an SM, registers a thread at launch, local
// memory a thread, the producer's and the consumers' registers after
// setmaxnreg, into out[0..5]. Returns 0 or a cudaError_t.
int bvt_attention_block_gemm_resources(int residual, int* out) {
  return bvt_gemm::bf16_resources(residual, out);
}

const char* bvt_error_string(int err) { return bvt_wgmma::error_string(err); }

}  // extern "C"
