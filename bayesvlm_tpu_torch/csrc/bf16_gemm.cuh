// Dense GEMMs with an fp32 epilogue, for csrc/attention_block.cu:
//
//   out = round(a . W^T + bias)                       (QKV, out-proj)
//   out = round(residual + round(a . W^T + bias))     (out-proj + residual)
//
// a [M, K] row-major in the compute dtype; W the rows of up to three
// [rows, K] matrices stacked along N (the q, k and v weights, in torch's
// [out, in] layout), their biases likewise, in the compute dtype. The
// product is accumulated in fp32, the bias added in fp32, and the result
// rounded once, as `_mha_block_kernel`'s `proj` does
// (bayesvlm_tpu/models/attention_pallas.py:250-256); the residual add
// sums two compute-dtype values in fp32 and rounds once (:287). The
// output is written as N / rows contiguous [M, rows] blocks, so the fused
// QKV product gives contiguous q, k and v for the attention kernel.
//
// bf16 (gemm_bf16_kernel): the tile of csrc/int8_gemm.cuh, on bf16
// operands. 256 threads (8 warps as 2 x 4) own a 128 x 128 output tile;
// each warp a 64 x 32 piece, i.e. 4 x 4 mma.sync m16n8k16 tiles and 64
// fp32 accumulators a thread. K is walked 64 values (128 bytes) a stage
// through a ring of 3 shared-memory stages filled by cp.async (16 bytes
// a thread, zero-filled past the ragged edges of M, N and K), so a block
// meets one barrier per 4 k-steps; rows are padded from 128 to 144
// bytes, so the 8 rows an ldmatrix phase reads start 4 banks apart and
// cover all 32. A k-step is 32 bytes of each row, for bf16 as for int8,
// so the ldmatrix addressing of int8_gemm.cuh gives the bf16 fragments
// unchanged. Two blocks fit on an SM (108 KB of shared memory and <= 128
// registers a thread each), 16 warps to hide the mma and load
// latencies. (Measured by chip_smoke.py on an H100, PERF.md: 64-byte
// stages 4 deep were 5% slower; a 64 x 64 warp piece with 4 warps a
// block, which loads fewer fragments per mma but leaves 8 warps an SM at
// 209 registers, 8%.)
//
// fp32 (gemm_f32_kernel; the tests and the tiny towers): mma.sync has no
// fp32 operand type, and TF32 would round the operands, so a 64 x 64
// tile of fp32 FMAs on the CUDA cores (256 threads, each 4 rows x 2
// column pairs), K walked 16 at a time through shared memory.
//
// K and rows must be multiples of 8 (a 16-byte chunk of a bf16 row is
// all inside or all outside K; a column pair never straddles a block).

#pragma once

#include "int8_gemm.cuh"

namespace bvt_gemm {

using bvt_int8::cp_async16;
using bvt_int8::cp_async_commit;
using bvt_int8::cp_async_wait;
using bvt_int8::from_f;
using bvt_int8::ldmatrix_x4;
using bvt_int8::mma_bf16;
using bvt_int8::store2;
using bvt_int8::to_f;

constexpr int BM = 128;               // bf16: output rows per block
constexpr int BN = 128;               // bf16: output columns per block
constexpr int BKB = 128;              // bf16: K bytes per pipeline stage
constexpr int BT = 256;               // bf16: threads (8 warps as 2 x 4)
constexpr int WTN = 4;                // bf16: 8-column mma tiles per warp
constexpr int STAGES = 3;             // cp.async ring depth
constexpr int SK = BKB + 16;          // shared-memory row stride (bytes)
constexpr int STAGE_BYTES = (BM + BN) * SK;
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES;  // 108 KB: dynamic

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

// rows r0 .. r0+BM-1, bytes kb0 .. kb0+BKB-1 of a row-major [rows, kbytes]
// operand into shared memory (row stride SK); chunks past the edges are
// zero-filled
__device__ __forceinline__ void load_a(int8_t* dst, const int8_t* src, int r0, int rows,
                                       int kb0, int kbytes) {
  for (int c = threadIdx.x; c < BM * (BKB / 16); c += BT) {
    const int r = c / (BKB / 16), kc = (c % (BKB / 16)) * 16;
    const bool ok = r0 + r < rows && kb0 + kc < kbytes;
    cp_async16(dst + r * SK + kc, ok ? src + (long)(r0 + r) * kbytes + kb0 + kc : src,
               ok ? 16 : 0);
  }
}

// the same for rows n0 .. n0+BN-1 of the stacked W
template <typename T>
__device__ __forceinline__ void load_w(int8_t* dst, const Stack<T>& W, int n0, int N,
                                       int kb0, int kbytes) {
  for (int c = threadIdx.x; c < BN * (BKB / 16); c += BT) {
    const int r = c / (BKB / 16), kc = (c % (BKB / 16)) * 16;
    const int n = n0 + r;
    const bool ok = n < N && kb0 + kc < kbytes;
    const int part = ok ? n / W.rows : 0;
    const int8_t* src = reinterpret_cast<const int8_t*>(W.w(part));
    cp_async16(dst + r * SK + kc,
               ok ? src + (long)(n - part * W.rows) * kbytes + kb0 + kc : src,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(BT, 2)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ a, Stack<__nv_bfloat16> W,
                 const __nv_bfloat16* __restrict__ residual,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];  // STAGES x (A tile, B tile)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, thread in group
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 8 * WTN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this lane's ldmatrix row and byte offset (see csrc/int8_gemm.cuh)
  const int lq = lane / 8, lr = lane % 8;
  const int a_off = (lr + (lq & 1) * 8) * SK + (lq >> 1) * 16;
  const int b_off = (lr + (lq >> 1) * 8) * SK + (lq & 1) * 16;
  const int8_t* ab = reinterpret_cast<const int8_t*>(a);
  const int kbytes = 2 * K;

  float acc[4][WTN][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < WTN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (kbytes + BKB - 1) / BKB;
  // one commit group per K step, empty past the end, so that group kt is
  // complete once at most STAGES - 2 groups are pending
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      load_a(smem + s * STAGE_BYTES, ab, m0, M, s * BKB, kbytes);
      load_w(smem + s * STAGE_BYTES + BM * SK, W, n0, N, s * BKB, kbytes);
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
      load_a(st, ab, m0, M, next * BKB, kbytes);
      load_w(st + BM * SK, W, n0, N, next * BKB, kbytes);
    }
    cp_async_commit();
    const int8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    const int8_t* bs = as + BM * SK;
#pragma unroll
    for (int kk = 0; kk < BKB; kk += 32) {
      uint32_t af[4][4], bf[WTN][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], as + (wm + i * 16) * SK + kk + a_off);
#pragma unroll
      for (int j = 0; j < WTN; j += 2) {
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
        for (int j = 0; j < WTN; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // accumulator e of tile (i, j): row g (+8 for e >= 2), column 2t + e % 2
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < WTN; ++j) {
        const int col = n0 + wn + j * 8 + t * 2;
        if (col < N)
          store_pair(W, residual, out, M, N, row, col, acc[i][j][h * 2],
                     acc[i][j][h * 2 + 1]);
      }
    }
  }
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

inline cudaError_t gemm(const __nv_bfloat16* a, const Stack<__nv_bfloat16>& W,
                        const __nv_bfloat16* residual, __nv_bfloat16* out, int M, int N,
                        int K, cudaStream_t stream) {
  if (!gemm_shape_ok(M, N, K, W.rows)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opted in
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  gemm_bf16_kernel<<<grid, BT, GEMM_SMEM, stream>>>(a, W, residual, out, M, N, K);
  return cudaGetLastError();
}

inline cudaError_t gemm(const float* a, const Stack<float>& W, const float* residual,
                        float* out, int M, int N, int K, cudaStream_t stream) {
  if (!gemm_shape_ok(M, N, K, W.rows)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_f32_kernel<<<grid, FT, 0, stream>>>(a, W, residual, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace bvt_gemm
