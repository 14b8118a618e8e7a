// W8A8 int8 building blocks shared by csrc/mlp_int8.cu and
// csrc/linear_int8.cu (each includes this header and is its own library).
// Its cp.async, ldmatrix and mma helpers (mma_bf16 too) also serve
// csrc/xlogy_rowsum.cu and csrc/bf16_gemm.cuh.
//
//   quant_rows_kernel  per-row symmetric absmax int8 quantize of [M, K],
//                      optionally after an fp32 LayerNorm; one block a row
//   gemm_s8_kernel     int8 A [M, K] times int8 W [N, K]^T, exact int32
//                      sums on the tensor cores (mma.sync m16n8k32 s8),
//                      then an fp32 epilogue: dequant + bias, optionally
//                      an activation, optionally an fp32 residual add
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
// twice. The int32 sums are exact: K * 127^2 < 2^31 for K <= 133,000.
//
// The GEMM tile: 256 threads (8 warps as 2 x 4) own a 128 x 128 output
// tile; each warp a 64 x 32 piece, i.e. 4 x 4 mma tiles of 16 x 8 and 64
// int32 accumulators a thread. K is walked in steps of 64 bytes through
// a ring of 4 shared-memory stages filled by cp.async (16 bytes a
// thread, zero-filled past the ragged edges of M, N and K), so three
// steps' loads are in flight while one step's products run. The mma
// fragments come from shared memory by ldmatrix (one x4 gives a 16 x 32
// A fragment, or the B fragments of two 8-column tiles): 6 loads per 16
// mma. Shared-memory rows are padded from 64 to 80 bytes, so the 8 rows
// of 16 bytes an ldmatrix phase reads fall in 32 distinct banks. Two
// blocks fit on an SM (80 KB of shared memory and <= 128 registers a
// thread each).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bvt_int8 {

constexpr float kEps = 1e-12f;
constexpr int QT = 256;               // threads of a row-quantize block
constexpr int kMaxRowFloats = 12288;  // a row's fp32 copy fits in 48 KB

constexpr int BM = 128;               // GEMM output rows per block
constexpr int BN = 128;               // GEMM output columns per block
constexpr int BK = 64;                // K bytes per pipeline stage
constexpr int GT = 256;               // GEMM threads per block
constexpr int STAGES = 4;             // cp.async ring depth
constexpr int SK = BK + 16;           // shared-memory row stride (bytes)
constexpr int STAGE_BYTES = (BM + BN) * SK;
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES;  // 80 KB: dynamic
static_assert(BM == BN, "load_tile serves both operands");

enum Activation { kNone = 0, kGeluTanh = 1, kQuickGelu = 2 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// One row per block: x[m] (as fp32, through the LayerNorm when ln_w is
// given) -> q[m] int8 and scale[m]. The row's fp32 copy lives in dynamic
// shared memory (K floats); each thread reads back only what it wrote.
template <typename T>
__global__ void __launch_bounds__(QT)
quant_rows_kernel(const T* __restrict__ x, int K, const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, float ln_eps,
                  int8_t* __restrict__ q, float* __restrict__ scale) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const long m = blockIdx.x;
  const T* xr = x + m * K;
  float amax = 0.f;
  if (ln_w != nullptr) {
    // two-pass variance, as `_ln_rows`
    float s = 0.f;
    for (int k = threadIdx.x; k < K; k += QT) {
      const float v = to_f(xr[k]);
      row[k] = v;
      s += v;
    }
    const float mu = __fdiv_rn(block_reduce<false>(s, red), static_cast<float>(K));
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += QT) {
      const float d = __fsub_rn(row[k], mu);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(block_reduce<false>(ss, red), static_cast<float>(K));
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, ln_eps)));
    for (int k = threadIdx.x; k < K; k += QT) {
      const float y = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(row[k], mu), inv), ln_w[k]), ln_b[k]);
      row[k] = y;
      amax = fmaxf(amax, fabsf(y));
    }
  } else {
    for (int k = threadIdx.x; k < K; k += QT) {
      const float v = to_f(xr[k]);
      row[k] = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }
  const float r = fmaxf(block_reduce<true>(amax, red), kEps);
  const float qs = __fdiv_rn(127.0f, r);
  int8_t* qr = q + m * K;
  for (int k = threadIdx.x; k < K; k += QT)
    qr[k] = static_cast<int8_t>(__float2int_rn(__fmul_rn(row[k], qs)));
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

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                                  float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// rows r0 .. r0+127, bytes k0 .. k0+63 of a row-major int8 [rows, K]
// operand into shared memory (row stride SK); chunks past `rows` or K
// are zero-filled (K is a multiple of 16, so a chunk is all in or out)
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int r0,
                                          int rows, int k0, int K) {
  for (int c = threadIdx.x; c < BM * (BK / 16); c += GT) {
    const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
    const bool ok = r0 + r < rows && k0 + kc < K;
    cp_async16(dst + r * SK + kc, ok ? src + (long)(r0 + r) * K + k0 + kc : src,
               ok ? 16 : 0);
  }
}

// out = epilogue(a . w^T): a [M, K] int8 with per-row a_scale, w [N, K]
// int8 with per-column w_scale, bias [N]; `act` from Activation;
// `residual` [M, N] (or null) is added last in fp32. The output is
// written as `N / chunk` contiguous [M, chunk] blocks (chunk = N: one
// plain [M, N] matrix), so a fused QKV product lands as three
// contiguous tensors.
template <typename OutT>
__global__ void __launch_bounds__(GT, 2)
gemm_s8_kernel(const int8_t* __restrict__ a, const float* __restrict__ a_scale,
               const int8_t* __restrict__ w, const float* __restrict__ w_scale,
               const float* __restrict__ bias, const OutT* __restrict__ residual,
               OutT* __restrict__ out, int M, int N, int K, int act, int chunk) {
  extern __shared__ __align__(16) int8_t smem[];  // STAGES x (A tile, B tile)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, thread in group
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this lane's ldmatrix row and byte offset. A: matrices (rows 0-7,
  // k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) are the mma A
  // registers 0..3. B: (n 0-7, k 0-15), (0-7, 16-31), (8-15, 0-15),
  // (8-15, 16-31) are registers 0, 1 of two 8-column tiles.
  const int lq = lane / 8, lr = lane % 8;
  const int a_off = (lr + (lq & 1) * 8) * SK + (lq >> 1) * 16;
  const int b_off = (lr + (lq >> 1) * 8) * SK + (lq & 1) * 16;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + BK - 1) / BK;
  // one commit group per K step, empty past the end, so that group kt is
  // complete once at most STAGES - 2 groups are pending
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      load_tile(smem + s * STAGE_BYTES, a, m0, M, s * BK, K);
      load_tile(smem + s * STAGE_BYTES + BM * SK, w, n0, N, s * BK, K);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage read in step kt-1: every thread is past it
    const int next = kt + STAGES - 1;
    if (next < ktiles) {
      int8_t* st = smem + (next % STAGES) * STAGE_BYTES;
      load_tile(st, a, m0, M, next * BK, K);
      load_tile(st + BM * SK, w, n0, N, next * BK, K);
    }
    cp_async_commit();
    const int8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    const int8_t* bs = as + BM * SK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], as + (wm + i * 16) * SK + kk + a_off);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn + j * 8) * SK + kk + b_off);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // accumulator e of tile (i, j): row g (+8 for e >= 2), column 2t + e % 2.
  // The two columns of a pair share a chunk when chunk is even, and are
  // then stored as one 4- or 8-byte vector.
  const bool pairs = (chunk % 2) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      if (row >= M) continue;
      const float xs = a_scale[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + t * 2;
        if (col >= N) continue;
        const int ne = col + 1 < N ? 2 : 1;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e >= ne) break;
          float y = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), xs),
                        w_scale[col + e]),
              bias[col + e]);
          if (act == kGeluTanh) y = gelu_tanh(y);
          else if (act == kQuickGelu) y = quick_gelu(y);
          if (residual != nullptr)
            y = __fadd_rn(y, to_f(residual[(long)row * N + col + e]));
          v[e] = y;
        }
        const int c = col / chunk;
        OutT* o = out + ((long)c * M + row) * chunk + (col - c * chunk);
        if (ne == 2 && pairs) {
          store2<OutT>(o, v[0], v[1]);
        } else {
          o[0] = from_f<OutT>(v[0]);
          // the pair's second column may open the next chunk
          if (ne == 2) out[((long)((col + 1) / chunk) * M + row) * chunk
                           + (col + 1) % chunk] = from_f<OutT>(v[1]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t quant_rows(const T* x, int M, int K, const float* ln_w,
                       const float* ln_b, float ln_eps, int8_t* q, float* scale,
                       cudaStream_t stream) {
  if (K <= 0 || K > kMaxRowFloats) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  quant_rows_kernel<T><<<M, QT, K * sizeof(float), stream>>>(x, K, ln_w, ln_b,
                                                             ln_eps, q, scale);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t gemm_s8(const int8_t* a, const float* a_scale, const int8_t* w,
                    const float* w_scale, const float* bias, const OutT* residual,
                    OutT* out, int M, int N, int K, int act, int chunk,
                    cudaStream_t stream) {
  if (K <= 0 || K % 16 != 0 || chunk <= 0 || N % chunk != 0)
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opted in
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_s8_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  gemm_s8_kernel<OutT><<<grid, GT, GEMM_SMEM, stream>>>(
      a, a_scale, w, w_scale, bias, residual, out, M, N, K, act, chunk);
  return cudaGetLastError();
}

}  // namespace bvt_int8
