// The attention sublayer's dense GEMMs, for csrc/attention_block.cu:
//
//   out = round(a . W^T + bias)                       (QKV, out-proj)
//   out = round(residual + round(a . W^T + bias))     (out-proj + residual)
//
// a [M, K] row-major in the compute dtype; W the rows of up to three
// [rows, K] matrices stacked along N (the q, k and v weights, in torch's
// [out, in] layout, each read in place: no concatenated copy), their
// biases likewise, in the compute dtype. The product is accumulated in
// fp32, the bias added in fp32 (explicit __fadd_rn), and the result
// rounded once, as `_mha_block_kernel`'s `proj` does
// (bayesvlm_tpu/models/attention_pallas.py:250-256); the residual add
// sums two compute-dtype values in fp32 and rounds once (:287). The
// output is written as N / rows contiguous [M, rows] blocks, so the fused
// QKV product gives contiguous q, k and v for the attention kernel.
//
// bf16: the warp-specialised, persistent wgmma body of csrc/wgmma_gemm.cuh
// with its EpiBias epilogue (`wgmma_gemm_bias`): one block of 384 threads
// an SM, a producer thread keeping TMA loads of A and of the part's weight
// (K-major, as torch stores it: B^T, imm-trans-b 0) in a ring of 6 stages,
// two consumer warpgroups owning 128 x 128 output tiles in turn
// (ping-pong), m64n128k16 wgmma; the tile's bias staged in shared memory,
// the residual read in the epilogue, each 64 x 64 box stored by the TMA
// into its part's [M, rows] block (clipped at rows and M, so rows = 80
// needs no plain stores). Each weight has its own tensor map; a tile
// column belongs to one part. K and rows must be multiples of 8 and every
// base 16-byte aligned (the TMA's rules; the wrapper checks).
//
// fp32 (gemm_f32_kernel; the tests and the tiny towers): wgmma has no
// fp32 operand type, and TF32 would round the operands, so a 64 x 64
// tile of fp32 FMAs on the CUDA cores (256 threads, each 4 rows x 2
// column pairs), K walked 16 at a time through shared memory.
//
// K and rows must be multiples of 8 (a column pair never straddles a
// block; the TMA's 16-byte rows).

#pragma once

#include "int8_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace bvt_gemm {

using bvt_int8::from_f;
using bvt_int8::store2;
using bvt_int8::to_f;

constexpr int FM = 64;                // fp32: output rows per block
constexpr int FN = 64;                // fp32: output columns per block
constexpr int FK = 16;                // fp32: K per shared-memory step
constexpr int FP = FM + 4;            // fp32: shared-memory row stride
constexpr int FT = 256;               // fp32: threads per block

// the B operand and its bias: up to three [rows, K] matrices (and
// [rows] biases) stacked along N; part p holds output columns
// p*rows .. p*rows+rows-1
template <typename T> struct Stack {
  const T* w0;
  const T* w1;
  const T* w2;
  const T* b0;
  const T* b1;
  const T* b2;
  int rows;
  __device__ __forceinline__ const T* w(int part) const {
    return part == 0 ? w0 : part == 1 ? w1 : w2;
  }
  __device__ __forceinline__ const T* b(int part) const {
    return part == 0 ? b0 : part == 1 ? b1 : b2;
  }
};

// the epilogue of output columns col, col+1 (one part) of row `row`, from
// their fp32 sums s0, s1
template <typename T>
__device__ __forceinline__ void store_pair(const Stack<T>& W, const T* __restrict__ residual,
                                           T* __restrict__ out, int M, int N, int row,
                                           int col, float s0, float s1) {
  const int part = col / W.rows, c = col - part * W.rows;
  const T* b = W.b(part);
  float y0 = __fadd_rn(s0, to_f(b[c]));
  float y1 = __fadd_rn(s1, to_f(b[c + 1]));
  if (residual != nullptr) {
    const T* r = residual + (long)row * N + col;
    y0 = __fadd_rn(to_f(r[0]), to_f(from_f<T>(y0)));
    y1 = __fadd_rn(to_f(r[1]), to_f(from_f<T>(y1)));
  }
  store2<T>(out + ((long)part * M + row) * W.rows + c, y0, y1);
}

__global__ void __launch_bounds__(FT)
gemm_f32_kernel(const float* __restrict__ a, Stack<float> W,
                const float* __restrict__ residual, float* __restrict__ out, int M,
                int N, int K) {
  __shared__ __align__(16) float as[FK][FP];
  __shared__ __align__(16) float ws[FK][FP];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4] = {};  // rows ty*4 + r; columns 2tx, 2tx+1, 2tx+32, 2tx+33
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int idx = threadIdx.x; idx < FM * FK; idx += FT) {
      const int r = idx / FK, kk = idx % FK;
      const int m = m0 + r, n = n0 + r, kx = k0 + kk;
      as[kk][r] = m < M && kx < K ? a[(long)m * K + kx] : 0.f;
      float wv = 0.f;
      if (n < N && kx < K) {
        const int part = n / W.rows;
        wv = W.w(part)[(long)(n - part * W.rows) * K + kx];
      }
      ws[kk][r] = wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float2 b0 = *reinterpret_cast<const float2*>(&ws[kk][2 * tx]);
      const float2 b1 = *reinterpret_cast<const float2*>(&ws[kk][2 * tx + 32]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float bc[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], bc[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    if (row >= M) continue;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = n0 + 2 * tx + 32 * p;
      if (col < N)
        store_pair(W, residual, out, M, N, row, col, acc[r][2 * p], acc[r][2 * p + 1]);
    }
  }
}

inline bool gemm_shape_ok(int M, int N, int K, int rows) {
  return M >= 0 && K > 0 && K % 8 == 0 && rows > 0 && rows % 8 == 0 && N % rows == 0 &&
         N / rows >= 1 && N / rows <= 3;
}

// out = the epilogue above of a . W^T on `stream`: W the `parts` (1-3)
// [rows, K] weights w[p] side by side, b[p] their biases (the first
// `parts` of each are read), residual null for none. Returns 0, a
// cudaError_t or (bf16) a code of wgmma_gemm.cuh.
inline int gemm(const __nv_bfloat16* a, const __nv_bfloat16* const* w,
                const __nv_bfloat16* const* b, int parts, const __nv_bfloat16* residual,
                __nv_bfloat16* out, int M, int rows, int K, cudaStream_t stream) {
  if (residual != nullptr)
    return bvt_wgmma::wgmma_gemm_bias<true>(a, w, b, parts, residual, out, M, rows, K, stream);
  return bvt_wgmma::wgmma_gemm_bias<false>(a, w, b, parts, nullptr, out, M, rows, K, stream);
}

inline int gemm(const float* a, const float* const* w, const float* const* b, int parts,
                const float* residual, float* out, int M, int rows, int K,
                cudaStream_t stream) {
  const int N = parts * rows;
  if (parts < 1 || parts > 3 || !gemm_shape_ok(M, N, K, rows)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const Stack<float> W{w[0], w[parts > 1 ? 1 : 0], w[parts > 2 ? 2 : 0],
                       b[0], b[parts > 1 ? 1 : 0], b[parts > 2 ? 2 : 0], rows};
  const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_f32_kernel<<<grid, FT, 0, stream>>>(a, W, residual, out, M, N, K);
  return cudaGetLastError();
}

// the bf16 GEMM's two instantiations (residual 0: QKV, 1: the
// out-projection): dynamic shared memory, blocks an SM, registers a thread
// at launch, local memory a thread, then the producer's and the consumers'
// registers after setmaxnreg, into out[0..5]. Returns 0 or a cudaError_t.
inline int bf16_resources(int residual, int* out) {
  using namespace bvt_wgmma;
  const int err =
      residual ? kernel_resources<kWgBF16T, kBiBM, kBiBN, kBiStages, kBiSched, EpiBias<true>>(out)
               : kernel_resources<kWgBF16T, kBiBM, kBiBN, kBiStages, kBiSched, EpiBias<false>>(
                     out);
  out[4] = kProducerRegs;
  out[5] = kConsumerRegs;
  return err;
}

}  // namespace bvt_gemm
