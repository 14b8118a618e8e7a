// W8A8 int8 building blocks shared by csrc/mlp_int8.cu and
// csrc/linear_int8.cu (each includes this header and is its own library),
// and by the dequantising epilogue of csrc/wgmma_gemm.cuh. Its cp.async,
// ldmatrix (and ldmatrix.trans) and mma helpers (mma_bf16 too) also serve
// csrc/attention_mma.cuh, csrc/packed_heads.cu and csrc/tile_gemm.cu.
//
//   quant_rows_kernel      per-row symmetric absmax int8 quantize of [M, K],
//                          optionally after an fp32 LayerNorm; one warp a row
//   act_quant_rows_kernel  the same quantize of act(h) for fp32 h [M, K]
//                          (tanh-GELU or quick-GELU): the MLP's hidden layer
//
// The int8 products themselves run on the wgmma body of wgmma_gemm.cuh
// (EpiDequant: dequant + bias and a residual in its epilogue).
//
// Rounding is the JAX package's (bayesvlm_tpu/models/mlp_int8.py
// `_quant_rows`, `_ln_rows`, `_mlp_int8_kernel`), operation for operation:
//
//   r = max(max_k |x_k|, 1e-12)   q = rint(x * (127 / r))   scale = r * (1/127)
//   y = ((float(h) * x_scale) * w_scale) + bias          (h the int32 sum)
//
// rint and __float2int_rn round half to even, as jnp.round does. The
// explicit __fmul_rn / __fadd_rn keep nvcc from contracting a product and
// a sum into one FMA, which would round once where the JAX package rounds
// twice. The int32 sums are exact: K * 127^2 < 2^31 for K <= 133,000. A
// row's max is exact whoever takes it and in whatever order, so r, 127 / r
// and the scale are the same values wherever they are computed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "convert.cuh"

namespace bvt_int8 {

constexpr float kEps = 1e-12f;
constexpr int QT = 256;               // threads of a row block (quant_rows_kernel: whose sums a warp keeps)
constexpr int kMaxRowFloats = 12288;  // a row's fp32 copy fits in 48 KB

enum Activation { kNone = 0, kGeluTanh = 1, kQuickGelu = 2 };

using bvt_cvt::from_f;
using bvt_cvt::store2;
using bvt_cvt::to_f;

// 0.5 * x * (1 + tanh(c * (x + 0.044715 * x * x * x))), in the order of
// the JAX package's `_tanh_gelu`
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float th = tanhf(__fmul_rn(c, __fadd_rn(x, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, th));
}

// x * sigmoid(1.702 * x)
__device__ __forceinline__ float quick_gelu(float x) {
  const float z = __fmul_rn(1.702f, x);
  return __fmul_rn(x, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
}

// sum (or max) over the block; every thread gets the result. `red`
// holds one float per warp.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  __syncthreads();  // `red` may still be read by the previous reduce
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  return v;
}

// block_reduce's sum (or max) over a block of QT threads, taken by one
// warp in the same order: lane l's v[w] is the value of thread 32 w + l.
// Every lane gets the result.
template <bool kMax>
__device__ __forceinline__ float warp_reduce_as_block(const float (&v)[QT / 32]) {
  const int lane = threadIdx.x % 32;
  float out = 0.f;  // lane w: warp w's sum, as block_reduce's red[w]
#pragma unroll
  for (int w = 0; w < QT / 32; ++w) {
    float x = v[w];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, x, o);
      x = kMax ? fmaxf(x, u) : x + u;
    }
    if (lane == w) out = x;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, out, o);
    out = kMax ? fmaxf(out, u) : out + u;
  }
  return out;
}

// One row per warp: x[m] (as fp32, through the LayerNorm when ln_w is
// given) -> q[m] int8 and scale[m]. The row's fp32 copy lives in dynamic
// shared memory (K floats a warp); each lane reads back only what it
// wrote. The LayerNorm's sums are those of a block of QT threads, each
// summing elements t, t + QT, ... in turn, reduced by block_reduce: lane l
// keeps thread 32 w + l's partial sum for each w, and warp_reduce_as_block
// adds them in block_reduce's order, so the bits are a block's. A max
// takes any order. No barrier, so 64 rows an SM are in flight.
template <typename T>
__global__ void __launch_bounds__(QT)
quant_rows_kernel(const T* __restrict__ x, int M, int K, const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, float ln_eps,
                  int8_t* __restrict__ q, float* __restrict__ scale) {
  extern __shared__ float rows[];
  constexpr int W = QT / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long m = static_cast<long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (m >= M) return;
  float* row = rows + static_cast<long>(warp) * K;
  const T* xr = x + m * K;
  float amax = 0.f;
  if (ln_w != nullptr) {
    // two-pass variance, as `_ln_rows`
    float s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      s[w] = 0.f;
      for (int k = 32 * w + lane; k < K; k += QT) {
        const float v = to_f(xr[k]);
        row[k] = v;
        s[w] += v;
      }
    }
    const float mu = __fdiv_rn(warp_reduce_as_block<false>(s), static_cast<float>(K));
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float ss = 0.f;
      for (int k = 32 * w + lane; k < K; k += QT) {
        const float d = __fsub_rn(row[k], mu);
        ss = __fadd_rn(ss, __fmul_rn(d, d));
      }
      s[w] = ss;
    }
    const float var = __fdiv_rn(warp_reduce_as_block<false>(s), static_cast<float>(K));
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, ln_eps)));
    for (int k = lane; k < K; k += 32) {
      const float y = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(row[k], mu), inv), ln_w[k]), ln_b[k]);
      row[k] = y;
      amax = fmaxf(amax, fabsf(y));
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      const float v = to_f(xr[k]);
      row[k] = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float r = fmaxf(amax, kEps);
  const float qs = __fdiv_rn(127.0f, r);
  int8_t* qr = q + m * K;
  for (int k = lane; k < K; k += 32)
    qr[k] = static_cast<int8_t>(__float2int_rn(__fmul_rn(row[k], qs)));
  if (lane == 0) scale[m] = __fmul_rn(r, 1.0f / 127.0f);
}

// h [M, K] fp32 -> y = act(h) (ACT: kGeluTanh or kQuickGelu) -> q [M, K]
// int8 and scale [M]: quant_rows_kernel's operations on y, one block a row
// (K a multiple of 4, the row's y kept in dynamic shared memory). Each
// thread reads back only what it wrote.
template <int ACT>
__global__ void __launch_bounds__(QT)
act_quant_rows_kernel(const float* __restrict__ h, int K, int8_t* __restrict__ q,
                      float* __restrict__ scale) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const long m = blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(h + m * K);
  float amax = 0.f;
  for (int k4 = threadIdx.x; k4 < K / 4; k4 += QT) {
    const float4 v = src[k4];
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = ACT == kGeluTanh ? gelu_tanh(f[e]) : quick_gelu(f[e]);
      row[4 * k4 + e] = y;
      amax = fmaxf(amax, fabsf(y));
    }
  }
  const float r = fmaxf(block_reduce<true>(amax, red), kEps);
  const float qs = __fdiv_rn(127.0f, r);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + m * K);
  for (int k4 = threadIdx.x; k4 < K / 4; k4 += QT) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      word |= (static_cast<uint32_t>(__float2int_rn(__fmul_rn(row[4 * k4 + b], qs))) & 0xFFu)
              << (8 * b);
    qr[k4] = word;
  }
  if (threadIdx.x == 0) scale[m] = __fmul_rn(r, 1.0f / 127.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8 x 8 b16 matrices (8 rows of 16 bytes each): lanes 8q .. 8q+7
// give the row addresses of matrix q, and each lane receives, in r[q],
// bytes 4 (lane % 4) .. +3 of row lane / 4 of matrix q
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const int8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// the same four matrices transposed: each lane receives, in r[q], the
// b16 elements (row 2 (lane % 4), column lane / 4) and (row 2 (lane % 4)
// + 1, column lane / 4) of matrix q. From a row-major [k][n] b16 tile
// this gives mma.sync's col-major B fragment (k pairs of one column n).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const int8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c (16 x 8 int32) += a (16 x 32 s8, row) . b (32 x 8 s8, col)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
cudaError_t quant_rows(const T* x, int M, int K, const float* ln_w,
                       const float* ln_b, float ln_eps, int8_t* q, float* scale,
                       cudaStream_t stream) {
  if (K <= 0 || K > kMaxRowFloats) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  // as many rows (warps) a block as 48 KB of row copies hold, at most QT / 32
  int rows = static_cast<int>((48 * 1024) / (static_cast<size_t>(K) * sizeof(float)));
  rows = rows < 1 ? 1 : rows > QT / 32 ? QT / 32 : rows;
  const long blocks = (static_cast<long>(M) + rows - 1) / rows;
  quant_rows_kernel<T><<<static_cast<unsigned>(blocks), 32 * rows,
                         static_cast<size_t>(rows) * K * sizeof(float), stream>>>(
      x, M, K, ln_w, ln_b, ln_eps, q, scale);
  return cudaGetLastError();
}

// q, scale = quantize(act(h)) for h [M, K] fp32, act a kGeluTanh or
// kQuickGelu (K a multiple of 4)
inline cudaError_t act_quant_rows(const float* h, int M, int K, int act, int8_t* q,
                                  float* scale, cudaStream_t stream) {
  if (K <= 0 || K > kMaxRowFloats || K % 4 != 0) return cudaErrorInvalidValue;
  if (act != kGeluTanh && act != kQuickGelu) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (act == kGeluTanh)
    act_quant_rows_kernel<kGeluTanh><<<M, QT, smem, stream>>>(h, K, q, scale);
  else
    act_quant_rows_kernel<kQuickGelu><<<M, QT, smem, stream>>>(h, K, q, scale);
  return cudaGetLastError();
}

}  // namespace bvt_int8
