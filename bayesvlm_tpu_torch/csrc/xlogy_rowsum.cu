// Fused EPIG joint-entropy row sums, bf16 and int8:
//
//   r[m] = sum_n xlogy(s[m, n]),   s = (A . B^T) / K,   xlogy(s) = s > 0 ? s log s : 0
//
// A [M, K] holds the pool's class probabilities (M = N_p * C rows, K MC
// samples), B [N, K] the targets' (N = N_t * C). The [M, N] joint never
// reaches device memory.
//
// Replaces the TPU kernels `_xlogy_rowsum_kernel` (bf16) and
// `_xlogy_rowsum_kernel_int8` of bayesvlm_tpu/select/epig_pallas.py
// (called through `joint_xlogy_rowsums`). Same math, same rounding points:
//
//   bf16:  s = fp32(A . B^T) * (1/K)           exact bf16 products, fp32 sums
//   int8:  A, B quantized per row (absmax of the bf16-rounded values, the
//          1e-12 clamp, q = rint(x * (127 / r)), scale = r * (1/127); the
//          quant_rows_kernel of csrc/int8_gemm.cuh), exact int32 sums, then
//          s = ((float(s32) * b_scale[n]) * a_scale[m]) * (1/K), left to
//          right, each product rounded (__fmul_rn: no FMA contraction)
//
// The log is MUFU's lg2.approx.ftz (the instruction behind __log2f,
// without the subnormal fix-up nvcc wraps around it by default): per
// element s * log2(max(s, FLT_MIN)) is summed and the row sum is
// multiplied by ln 2 once at the end. lg2.approx has an absolute error
// <= 2^-22 for s in [0.5, 2] and <= 2 ulp elsewhere, so a term s log s
// is off by <= ~3e-7 s, far below the fp32 rounding of a sum over 10^5
// terms. The clamp gives s = 0 a term of 0 (xlogy's 0 log 0), and a
// subnormal s one smaller than 2^-126 * 126 in magnitude.
//
// What bounds it on an H100, at the reference operating point (pool 4000,
// targets 2000, C = 65, K = 100: M = 260,000, N = 130,000): the operands
// are ~78 MB as bf16, nothing. The tensor work is 2 M N K = 6.76 T bf16
// operations, 6.8 ms at 989 TFLOP/s (3.4 ms at the int8 rate). The logs
// are M N = 3.38e10; MUFU lg2 issues 16 per SM per clock, ~8.1 ms at 132
// SMs and 1.98 GHz. So the logs and the fp32 epilogue (scale, clamp, FMA:
// 3 instructions an element, 128 lanes per SM per clock) bound it,
// not the tensor cores. For comparison, writing the joint out in fp32, as
// a plain cuBLAS product would, moves >= 135 GB: >= 40 ms. This version's
// time on the card against that bound is in PERF.md (chip_smoke.py).
//
// Design (first version). One block of 256 threads (8 warps as 4 x 2)
// owns BM = 128 pool rows; their A tile stays in shared memory for the
// block's life. The block loops over ALL target rows itself, in tiles of
// BN = 128, streaming each B tile (all of K) with cp.async into a double
// buffer, so tile j+1 loads while tile j is worked on. Pool rows are the
// MMA's M dimension (mma.sync m16n8k16 bf16 -> fp32, or m16n8k32 s8 ->
// s32): each warp owns 32 pool rows, whose A fragments sit in registers
// from the start when K <= 112 bf16 / 128 int8 (7 / 4 k-steps of 32
// bytes; a second instantiation for larger K reads them from shared
// memory at every k-step), and 64 target columns of each tile, taken 16
// at a time: a group's products, then at once its epilogue, folded into
// per-row partial sums in registers (4 rows per thread). The group loop
// has no branch, so the scheduler overlaps the log work of one group with
// the products of the next. B fragments come by
// ldmatrix from rows padded by 16 bytes (an ldmatrix phase hits 32
// distinct banks): 7 bytes of shared memory per joint element at K = 112.
// After the last tile the 4 threads of a row quad are reduced with
// shuffles, the 2 warps that share rows through shared memory, and each
// row sum is written once. No atomics: the result is deterministic.
// The TPU's sequential target grid axis and its [1, M] scratch are gone:
// the loop inside the block takes their place. At the operating point
// the grid is ceil(260000 / 128) = 2032 blocks, two per SM.
//
// K (zero-padded by the wrapper to a multiple of 16 bf16 / 32 int8
// values; a zero column adds zero) lives whole in shared memory:
// 3 x 128 rows of K bytes + 16 (A, two B buffers) + 1.5 KB, 93.7 KB at
// K = 112 bf16. The launch is refused (cudaErrorInvalidValue) when that
// exceeds the device's opt-in limit: K > 288 bf16 or K > 576 int8 on an
// H100. Ragged M and N are zero-filled by cp.async: an s of 0 adds 0.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <float.h>

#include "int8_gemm.cuh"

namespace {

using bvt_int8::cp_async16;
using bvt_int8::cp_async_commit;
using bvt_int8::cp_async_wait;
using bvt_int8::ldmatrix_x4;
using bvt_int8::mma_bf16;
using bvt_int8::mma_s8;

constexpr int BM = 128;   // pool rows per block (resident A tile)
constexpr int BN = 128;   // target rows per streamed B tile
constexpr int NT = 256;   // threads: 8 warps as 4 (pool rows) x 2 (targets)
constexpr int WM = 32;    // pool rows per warp
constexpr int WN = 64;    // target rows per warp and tile
constexpr int PAD = 16;   // bytes appended to each shared-memory row
constexpr float kLn2 = 0.693147180559945309f;

// log2(x) by MUFU, for normal x (subnormals would read as 0)
__device__ __forceinline__ float lg2_ftz(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A k-step is 32 bytes of each row for both operand types (16 bf16 or
// 32 int8), so the fragment loads are the same; only the product and
// the accumulator type differ.
template <bool kInt8> struct Op;
template <> struct Op<false> {
  using Acc = float;
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    mma_bf16(c, a, b);
  }
};
template <> struct Op<true> {
  using Acc = int;
  static __device__ __forceinline__ void mma(int* c, const uint32_t* a,
                                             const uint32_t* b) {
    mma_s8(c, a, b);
  }
};

// shared memory of one block: A tile, two B tiles (row stride kb + PAD
// bytes), the cross-warp row sums [2][BM] and the pool-row scales [BM]
__host__ __device__ constexpr long smem_bytes(int kb) {
  return (long)(BM + 2 * BN) * (kb + PAD) + 3L * BM * (long)sizeof(float);
}

// rows r0 .. r0+rows_tile-1 (all kb bytes) of a row-major [rows, kb]
// operand into shared memory with row stride sb; rows past `rows` are
// zero-filled
__device__ __forceinline__ void load_rows(int8_t* dst, const int8_t* src, long r0,
                                          long rows, int rows_tile, int kb, int sb) {
  const int chunks = kb / 16;
  for (int c = threadIdx.x; c < rows_tile * chunks; c += NT) {
    const int r = c / chunks, kc = (c % chunks) * 16;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * sb + kc, ok ? src + (r0 + r) * kb + kc : src, ok ? 16 : 0);
  }
}

// the most k-steps of 32 bytes whose A fragments a block holds in
// registers: K <= 112 bf16 / 128 int8 (the operating point's K = 100)
template <bool kInt8> constexpr int kRegSteps = kInt8 ? 4 : 7;

// a [M, kb] and b [N, kb] bytes (bf16 or int8 values), kb a multiple of
// 32; a_scale [M] and b_scale [N] are read only by the int8 variant;
// out [M] fp32. KS > 0: kb = 32 KS, known at compile time, and the A
// fragments sit in registers; KS = 0: any kb, and every k-step reads the
// A fragments from shared memory.
template <bool kInt8, int KS>
__global__ void __launch_bounds__(NT, 2)
xlogy_rowsum_kernel(const int8_t* __restrict__ a, const float* __restrict__ a_scale,
                    const int8_t* __restrict__ b, const float* __restrict__ b_scale,
                    float* __restrict__ out, int M, int N, int kb_any, float inv_k) {
  using Acc = typename Op<kInt8>::Acc;
  constexpr bool kRegA = KS > 0;
  constexpr int KR = kRegA ? KS : 1;
  extern __shared__ __align__(16) int8_t smem[];
  const int kb = kRegA ? 32 * KS : kb_any;
  const int sb = kb + PAD, ksteps = kb / 32;
  int8_t* as = smem;                        // [BM][sb], resident
  int8_t* bs = smem + BM * sb;              // 2 x [BN][sb]
  float* red = reinterpret_cast<float*>(smem + (BM + 2 * BN) * sb);  // [2][BM]
  float* asc = red + 2 * BM;                // [BM]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;     // fragment row group, thread in group
  const int wm = (warp / 2) * WM, wn = (warp % 2) * WN;
  const long m0 = (long)blockIdx.x * BM;
  // this lane's ldmatrix row and byte offset (see csrc/int8_gemm.cuh)
  const int lq = lane / 8, lr = lane % 8;
  const int a_off = (lr + (lq & 1) * 8) * sb + (lq >> 1) * 16;
  const int b_off = (lr + (lq >> 1) * 8) * sb + (lq & 1) * 16;

  load_rows(as, a, m0, M, BM, kb, sb);
  cp_async_commit();
  const int ntiles = (N + BN - 1) / BN;
  if (ntiles > 0) load_rows(bs, b, 0, N, BN, kb, sb);
  cp_async_commit();
  if constexpr (kInt8) {
    for (int r = tid; r < BM; r += NT) asc[r] = m0 + r < M ? a_scale[m0 + r] : 0.f;
  }
  cp_async_wait<1>();  // A has landed
  __syncthreads();
  uint32_t af[2][KR][4];
  if constexpr (kRegA) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ks = 0; ks < KR; ++ks)
        ldmatrix_x4(af[i][ks], as + (wm + i * 16) * sb + ks * 32 + a_off);
  }
  float rs[2][2] = {};  // pool-row scales of this thread's rows (int8)
  if constexpr (kInt8) {
    for (int i = 0; i < 2; ++i)
      for (int h = 0; h < 2; ++h) rs[i][h] = asc[wm + i * 16 + g + h * 8];
  }

  float part[2][2] = {};  // [m16 tile][row g, row g + 8]: sums of s log2 s
  for (int j = 0; j < ntiles; ++j) {
    // refill the buffer read in step j-1 (every thread is past it)
    if (j + 1 < ntiles)
      load_rows(bs + ((j + 1) & 1) * BN * sb, b, (long)(j + 1) * BN, N, BN, kb, sb);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const int8_t* bt = bs + (j & 1) * BN * sb;

    // the warp's 64 target columns in 4 groups of 16: each group's
    // products, then at once its epilogue, so that the log work of one
    // group overlaps the products of the next. With kRegA the loop has no
    // branch and constant shared-memory offsets (one basic block for the
    // scheduler).
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int8_t* bp = bt + (wn + p * 16) * sb + b_off;
      Acc acc[2][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;
      if constexpr (kRegA) {
#pragma unroll
        for (int ks = 0; ks < KR; ++ks) {
          uint32_t r[4];  // two 8-column B fragments
          ldmatrix_x4(r, bp + ks * 32);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            Op<kInt8>::mma(acc[i][0], af[i][ks], r);
            Op<kInt8>::mma(acc[i][1], af[i][ks], r + 2);
          }
        }
      } else {
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t r[4], x[2][4];
          ldmatrix_x4(r, bp + ks * 32);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ldmatrix_x4(x[i], as + (wm + i * 16) * sb + ks * 32 + a_off);
            Op<kInt8>::mma(acc[i][0], x[i], r);
            Op<kInt8>::mma(acc[i][1], x[i], r + 2);
          }
        }
      }

      // accumulator e of tile (i, n): pool row g (+8 for e >= 2), target
      // column 2t + e % 2. Columns past N hold 0 (zero-filled rows of B).
      float bsc[2][2] = {};
      if constexpr (kInt8) {
        for (int n = 0; n < 2; ++n)
          for (int e = 0; e < 2; ++e) {
            const long col = (long)j * BN + wn + p * 16 + n * 8 + 2 * t + e;
            bsc[n][e] = col < N ? b_scale[col] : 0.f;
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sum = part[i][h];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float s;
              if constexpr (kInt8)
                s = __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][n][h * 2 + e]),
                                                  bsc[n][e]), rs[i][h]), inv_k);
              else
                s = __fmul_rn(acc[i][n][h * 2 + e], inv_k);
              sum = fmaf(s, lg2_ftz(fmaxf(s, FLT_MIN)), sum);
            }
          }
          part[i][h] = sum;
        }
      }
    }
    __syncthreads();  // buffer j & 1 is refilled in step j + 1
  }
  cp_async_wait<0>();

  // the 4 threads of a quad share a row; then the 2 warps that share rows
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = part[i][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) red[(warp % 2) * BM + wm + i * 16 + g + h * 8] = v;
    }
  __syncthreads();
  if (tid < BM && m0 + tid < M)
    out[m0 + tid] = __fmul_rn(red[tid] + red[BM + tid], kLn2);
}

template <bool kInt8, int KS>
cudaError_t launch_kernel(const int8_t* a, const float* a_scale, const int8_t* b,
                          const float* b_scale, float* out, int M, int N, int kb,
                          float inv_k, long bytes, cudaStream_t stream) {
  // above 48 KB a launch is refused unless the kernel opted in
  cudaError_t err = cudaFuncSetAttribute(xlogy_rowsum_kernel<kInt8, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((M + BM - 1) / BM);
  xlogy_rowsum_kernel<kInt8, KS><<<blocks, NT, bytes, stream>>>(
      a, a_scale, b, b_scale, out, M, N, kb, inv_k);
  return cudaGetLastError();
}

// the instantiation with KS = kb / 32 k-steps in registers, for KS <= KMAX
template <bool kInt8, int KMAX>
cudaError_t launch_regs(const int8_t* a, const float* a_scale, const int8_t* b,
                        const float* b_scale, float* out, int M, int N, int kb,
                        float inv_k, long bytes, cudaStream_t stream) {
  if constexpr (KMAX == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (kb == 32 * KMAX)
      return launch_kernel<kInt8, KMAX>(a, a_scale, b, b_scale, out, M, N, kb, inv_k,
                                        bytes, stream);
    return launch_regs<kInt8, KMAX - 1>(a, a_scale, b, b_scale, out, M, N, kb, inv_k,
                                        bytes, stream);
  }
}

template <bool kInt8>
cudaError_t launch(const int8_t* a, const float* a_scale, const int8_t* b,
                   const float* b_scale, float* out, int M, int N, int kb,
                   float inv_k, cudaStream_t stream) {
  if (kb <= 0 || kb % 32 != 0 || M < 0 || N < 0) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const long bytes = smem_bytes(kb);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  if (kb <= 32 * kRegSteps<kInt8>)
    return launch_regs<kInt8, kRegSteps<kInt8>>(a, a_scale, b, b_scale, out, M, N, kb,
                                                inv_k, bytes, stream);
  return launch_kernel<kInt8, 0>(a, a_scale, b, b_scale, out, M, N, kb, inv_k, bytes,
                                 stream);
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one block needs for rows of kb bytes
long bvt_xlogy_rowsum_smem_bytes(int kb) { return smem_bytes(kb); }

// the most dynamic shared memory a block of the current device may opt
// in to, or -1 when the device cannot be queried
int bvt_xlogy_rowsum_smem_limit(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

// a [M, k] and b [N, k] bf16, row-major, k a multiple of 16 (zero-padded);
// out [M] fp32. Returns a cudaError_t (0 = launched).
int bvt_xlogy_rowsum_bf16(const void* a, const void* b, float* out, int M, int N,
                          int k, float inv_k, void* stream) {
  if (k <= 0 || k % 16 != 0) return cudaErrorInvalidValue;
  return launch<false>(static_cast<const int8_t*>(a), nullptr,
                       static_cast<const int8_t*>(b), nullptr, out, M, N, 2 * k,
                       inv_k, static_cast<cudaStream_t>(stream));
}

// a [M, k] and b [N, k] bf16, row-major, k a multiple of 32 (zero-padded),
// quantized per row into the scratch aq [M, k] + a_scale [M] and
// bq [N, k] + b_scale [N]; then the int8 kernel. Three launches on the
// caller's stream. Returns a cudaError_t (0 = launched).
int bvt_xlogy_rowsum_int8(const void* a, const void* b, int8_t* aq, float* a_scale,
                          int8_t* bq, float* b_scale, float* out, int M, int N,
                          int k, float inv_k, void* stream) {
  if (k <= 0 || k % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bvt_int8::quant_rows<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(a), M, k, nullptr, nullptr, 0.f, aq,
      a_scale, st);
  if (err != cudaSuccess) return err;
  err = bvt_int8::quant_rows<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(b), N,
                                            k, nullptr, nullptr, 0.f, bq, b_scale, st);
  if (err != cudaSuccess) return err;
  return launch<true>(aq, a_scale, bq, b_scale, out, M, N, k, inv_k, st);
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
