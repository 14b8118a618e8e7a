// Fused probit zero-shot head: the tail of the Smith chain in one kernel,
//
//   mean  = es_hat . yt_hat^T                       [B, C]
//   var   = ns_bar . st_bar^T + ss_bar . t2_bar^T   [B, C]
//   probs = softmax(mean e^s / sqrt(1 + pi/8 var e^{2s}))   over the C columns
//
// with the row-scaled operands of the TPU kernel's prelude
// (smith_pallas.py:161-171): n = e^2 + sigma, E = sum_k n per row, and
// es_hat = e_s / sqrt(E_s), ns_bar = n_s / E_s, ss_bar = sigma_s / E_s,
// yt_hat = e_t / sqrt(E_t), st_bar = sigma_t / E_t, t2_bar = e_t^2 / E_t,
// each rounded as the plain version rounds it. The [B, C] mean and
// variance never reach device memory.
//
// Replaces the TPU kernel `_smith_kernel` of
// bayesvlm_tpu/probforward/kernels/smith_pallas.py (called through
// `fused_probit_probs`). Same math in fp32 throughout, as the Pallas call
// casts every operand to f32: the products are fp32 FMAs on the CUDA
// cores (Hopper has no fp32 tensor-core product, and TF32 keeps 10
// mantissa bits, ~1e-3 relative, outside the 1e-4 the head is held to).
// The two variance products share one accumulator. Columns >= C take no
// part in the softmax (the TPU masked its lane padding to -inf). The
// probit scale is an IEEE division by an IEEE square root, and the
// softmax uses expf (not __expf) and divides by the row sum.
//
// What bounds it on an H100: 6 B C D fp32 operations (three products of
// 2 B C D). At B = 2048, C = 1000, D = 768 that is 9.4 GFLOP, 0.14 ms at
// the 67 TFLOP/s fp32 peak, against ~21 MB of operands and output, 6 us
// at 3.35 TB/s: the operations. This version's time against that bound
// is in PERF.md (chip_smoke.py).
//
// Design. Three launches on the caller's stream, from one C entry point,
// the first two over both sides at once. row_energy_kernel computes E per
// row (a warp a row); scale_transpose_kernel writes the three scaled
// operands k-major, [3, D, ld] with ld the row count rounded up to 4 and
// the pad zeroed, one 32 x 32 tile a block through a shared-memory
// transpose (reads and writes coalesced): 3 (B + C) D floats of scratch,
// 34 MB at B = 2048, C = 1000, D = 768. The TPU left this prelude to XLA;
// here it is two launches instead of the ~20 elementwise ops torch would
// take, each with a block per 32 x 32 tile (a block per 32 rows walking
// all of D gave 68 blocks at B = 2048, C = 100).
//
// smith_head_kernel: one block of 256 threads owns TB = 16 image rows,
// the TPU kernel's row tile turned into a block; the loop over the class
// columns inside the block takes the place of the TPU's whole-C VMEM
// tile. Each chunk of KD = 32 values of k is a set of contiguous 16-byte
// pieces of the k-major operands: cp.async copies the block's three
// [KD, TB] row pieces and the three [KD, CT = 128] class pieces into a
// double buffer while the previous chunk is worked on. Shared-memory
// bandwidth, not the FMA rate, bounds a CUDA-core product: the SM
// delivers 32 floats a clock to 128 FMA lanes, so a thread must reuse
// each loaded value ~4 times. A thread owns a 4 x 8 piece of the tile
// (4 rows, columns cj .. cj + 3 and cj + 32 .. cj + 35): per k and
// operand one float4 of rows and two of columns, 12 floats for 32 FMAs
// (the first version's 2 x 4 piece loaded 6 for 8: 19% of the fp32 peak
// at B = 2048, C = 1000, D = 768, where this one reaches 28%). 16 rows x
// 128 columns is then 2 x 8 thread pieces wide, 64 threads; the 8 warps
// split k instead (4 groups of 8 k values a
// chunk, 2 column halves), and at the end of each column tile the four
// groups' partial sums are added through shared memory in a fixed order
// (deterministic), the last group applying the scale and the probit and
// writing kappa = mean / sqrt(1 + pi/8 var) into the block's [TB, C]
// logits tile in shared memory. After the last column tile each warp
// takes two rows: max, then exp and sum, then the normalised row, with
// warp shuffles; each output row is written once, coalesced.
//
// Shared memory: 110,592 bytes of operand buffers, 16,384 of partial
// sums and 64 C bytes of logits, 188 KB at C = 1000. A C whose tile does
// not fit the device's opt-in limit (C > 1648 on an H100) is refused
// (cudaErrorInvalidValue); the wrapper raises before it launches. Ragged
// B and C: pieces past the operands' leading dimension are zero-filled by
// cp.async, rows >= B and columns >= C are never written; k >= D is
// zero-filled.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TB = 16;    // image rows per block
constexpr int CT = 128;   // class columns per tile
constexpr int KD = 32;    // k values per chunk
constexpr int NT = 256;   // threads per block: 4 k-groups x 2 column halves
constexpr int KG = 4;     // k-groups, each KD / KG = 8 k values of a chunk
constexpr int STAGES = 2;
constexpr int A_STAGE = 3 * KD * TB;  // floats of one stage's row pieces
constexpr int B_STAGE = 3 * KD * CT;  // floats of one stage's class pieces
constexpr int RED = 2 * TB * CT;      // the k-groups' mean and var sums
constexpr float kPi8 = 0.39269908169872414f;  // pi / 8
static_assert((3 * KD * CT / 4) % NT == 0, "class pieces per thread");

long smem_bytes(int C) {
  return (long)(STAGES * (A_STAGE + B_STAGE) + RED + TB * (long)C) * sizeof(float);
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

// one chunk (column tile c0, k0 .. k0 + KD) of the operands into stage
// buffers a_s [3][KD][TB] and b_s [3][KD][CT]
__device__ __forceinline__ void load_chunk(const float* __restrict__ src,
                                           const float* __restrict__ tgt,
                                           float* a_s, float* b_s, int r0, int c0,
                                           int k0, int D, int ldb, int ldc) {
  const int t = threadIdx.x;
  for (int idx = t; idx < 3 * KD * TB / 4; idx += NT) {
    const int p = idx / (KD * TB / 4), rem = idx % (KD * TB / 4);
    const int kr = rem / (TB / 4), q = rem % (TB / 4);
    const int k = k0 + kr, r = r0 + 4 * q;
    const bool ok = k < D && r < ldb;
    const float* g = ok ? src + ((long)p * D + k) * ldb + r : src;
    cp_async16(a_s + (p * KD + kr) * TB + 4 * q, g, ok ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < 3 * KD * CT / 4 / NT; ++i) {
    const int idx = t + i * NT;
    const int p = idx / (KD * CT / 4), rem = idx % (KD * CT / 4);
    const int kr = rem / (CT / 4), q = rem % (CT / 4);
    const int k = k0 + kr, c = c0 + 4 * q;
    const bool ok = k < D && c < ldc;
    const float* g = ok ? tgt + ((long)p * D + k) * ldc + c : tgt;
    cp_async16(b_s + (p * KD + kr) * CT + 4 * q, g, ok ? 16 : 0);
  }
}

// One side of the prelude: e, s [N, D] row-major (embeddings, diagonal
// covariances) -> E [N] and out [3, D, ld] k-major.
struct Side {
  const float* e;
  const float* s;
  float* E;
  float* out;
  int N, ld;
};

// E[r] = sum_k (e^2 + s) for every row of both sides (blockIdx.y): one
// warp per row, 8 rows per block
__global__ void __launch_bounds__(256)
row_energy_kernel(Side src, Side tgt, int D) {
  const Side& sd = blockIdx.y ? tgt : src;
  const int r = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= sd.N) return;
  float sum = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float x = sd.e[(long)r * D + k];
    sum += __fadd_rn(__fmul_rn(x, x), sd.s[(long)r * D + k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) sd.E[r] = sum;
}

// one 32-row x 32-k tile of a side's three scaled operands, written
// k-major through a shared-memory transpose (reads and writes coalesced):
// the image side's (e / sqrt(E), n / E, s / E), the class side's
// (e / sqrt(E), s / E, e^2 / E); rows N .. ld - 1 are written as zeros.
// grid (row tiles, k tiles, side)
__global__ void __launch_bounds__(256)
scale_transpose_kernel(Side src, Side tgt, int D) {
  __shared__ float tile[3][32][33];
  const bool source = blockIdx.z == 0;
  const Side& sd = source ? src : tgt;
  const int r0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  if (r0 >= sd.ld) return;  // the other side has more row tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < 32; rr += 8) {
    const int r = r0 + rr, k = k0 + lane;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if (r < sd.N && k < D) {
      const float x = sd.e[(long)r * D + k], c = sd.s[(long)r * D + k], E = sd.E[r];
      const float x2 = __fmul_rn(x, x);
      v0 = __fdiv_rn(x, __fsqrt_rn(E));
      if (source) {
        v1 = __fdiv_rn(__fadd_rn(x2, c), E);
        v2 = __fdiv_rn(c, E);
      } else {
        v1 = __fdiv_rn(c, E);
        v2 = __fdiv_rn(x2, E);
      }
    }
    tile[0][lane][rr] = v0;
    tile[1][lane][rr] = v1;
    tile[2][lane][rr] = v2;
  }
  __syncthreads();
  for (int kk = warp; kk < 32; kk += 8) {
    const int k = k0 + kk, r = r0 + lane;
    if (k < D && r < sd.ld)
#pragma unroll
      for (int p = 0; p < 3; ++p) sd.out[((long)p * D + k) * sd.ld + r] = tile[p][kk][lane];
  }
}

__global__ void __launch_bounds__(NT, 1)
smith_head_kernel(const float* __restrict__ src,  // [3, D, ldb]: es, ns, ss (k-major)
                  const float* __restrict__ tgt,  // [3, D, ldc]: yt, st, t2 (k-major)
                  float* __restrict__ out,        // [B, C]
                  int B, int C, int D, int ldb, int ldc,
                  const float* __restrict__ log_scale) {  // s, on the device
  extern __shared__ __align__(16) float smem[];
  float* a_buf = smem;                          // [STAGES][3][KD][TB]
  float* b_buf = a_buf + STAGES * A_STAGE;      // [STAGES][3][KD][CT]
  float* red = b_buf + STAGES * B_STAGE;        // [2][TB][CT]
  float* logits = red + RED;                    // [TB][C]

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int kg = warp / 2;                      // k-group: k values 8 kg .. 8 kg + 7
  const int ri = 4 * (lane / 8);                // this thread's four rows
  const int cj = 64 * (warp % 2) + 4 * (lane % 8);  // and columns cj + {0..3, 32..35}
  const int r0 = blockIdx.x * TB;
  const int n_k = (D + KD - 1) / KD;
  const int total = ((C + CT - 1) / CT) * n_k;
  const float scale = expf(*log_scale), scale2 = scale * scale;

  float mean[4][8], var[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) mean[r][c] = var[r][c] = 0.f;

  load_chunk(src, tgt, a_buf, b_buf, r0, 0, 0, D, ldb, ldc);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      const int nx = it + 1, s = nx % STAGES;
      load_chunk(src, tgt, a_buf + s * A_STAGE, b_buf + s * B_STAGE, r0,
                 (nx / n_k) * CT, (nx % n_k) * KD, D, ldb, ldc);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk `it` has landed
    __syncthreads();

    const float* a_s = a_buf + (it % STAGES) * A_STAGE;
    const float* b_s = b_buf + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < KD / KG; ++kk) {
      const int kr = kg * (KD / KG) + kk;
      const float4 es = *reinterpret_cast<const float4*>(a_s + (0 * KD + kr) * TB + ri);
      const float4 ns = *reinterpret_cast<const float4*>(a_s + (1 * KD + kr) * TB + ri);
      const float4 ss = *reinterpret_cast<const float4*>(a_s + (2 * KD + kr) * TB + ri);
      const float e[4] = {es.x, es.y, es.z, es.w}, n[4] = {ns.x, ns.y, ns.z, ns.w};
      const float s2[4] = {ss.x, ss.y, ss.z, ss.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = cj + 32 * h;
        const float4 yt = *reinterpret_cast<const float4*>(b_s + (0 * KD + kr) * CT + col);
        const float4 st = *reinterpret_cast<const float4*>(b_s + (1 * KD + kr) * CT + col);
        const float4 t2 = *reinterpret_cast<const float4*>(b_s + (2 * KD + kr) * CT + col);
        const float y[4] = {yt.x, yt.y, yt.z, yt.w};
        const float sg[4] = {st.x, st.y, st.z, st.w};
        const float tt[4] = {t2.x, t2.y, t2.z, t2.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            mean[r][4 * h + c] = fmaf(e[r], y[c], mean[r][4 * h + c]);
            var[r][4 * h + c] = fmaf(n[r], sg[c], var[r][4 * h + c]);
            var[r][4 * h + c] = fmaf(s2[r], tt[c], var[r][4 * h + c]);
          }
      }
    }

    if (it % n_k == n_k - 1) {
      // the column tile is complete: sum the four k-groups' partial sums
      // in a fixed order (deterministic), then the probit on the last
      const int c0 = (it / n_k) * CT;
      for (int g = 0; g < KG; ++g) {
        if (kg == g) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int lc = cj + 32 * (c / 4) + c % 4, idx = (ri + r) * CT + lc;
              float m = mean[r][c], v = var[r][c];
              if (g > 0) {
                m = red[idx] + m;
                v = red[TB * CT + idx] + v;
              }
              if (g < KG - 1) {
                red[idx] = m;
                red[TB * CT + idx] = v;
              } else if (c0 + lc < C) {
                logits[(ri + r) * C + c0 + lc] = __fdiv_rn(
                    m * scale, __fsqrt_rn(fmaf(kPi8, v * scale2, 1.0f)));
              }
              mean[r][c] = var[r][c] = 0.f;
            }
        }
        __syncthreads();
      }
    }
    __syncthreads();  // the next load may overwrite this stage
  }
  cp_async_wait<0>();

  // row softmax over the C valid columns: each warp two rows
  for (int rr = 2 * warp; rr < 2 * warp + 2; ++rr) {
    if (r0 + rr >= B) break;
    float* row = logits + rr * C;
    float mx = -CUDART_INF_F;
    for (int c = lane; c < C; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float* dst = out + (long)(r0 + rr) * C;
    for (int c = lane; c < C; c += 32) dst[c] = __fdiv_rn(row[c], sum);
  }
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one block needs for C classes
long bvt_smith_head_smem_bytes(int C) { return smem_bytes(C); }

// the most dynamic shared memory a block of the current device may opt
// in to, or -1 when the device cannot be queried
int bvt_smith_head_smem_limit(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

// se, sc [B, D] and te, tc [C, D] fp32 row-major (embeddings and diagonal
// covariances); log_scale: the fp32 logit scale s on the device; src
// [3, D, ldb] and tgt [3, D, ldc] fp32 scratch, ldb = B and ldc = C
// rounded up to multiples of 4, 16-byte aligned; energy [B + C] fp32
// scratch; out [B, C] fp32. Three launches on `stream`. Returns a
// cudaError_t (0 = launched).
int bvt_smith_head(const float* se, const float* sc, const float* te, const float* tc,
                   const float* log_scale, float* src, float* tgt, float* energy,
                   float* out, int B, int C, int D, int ldb, int ldc, void* stream) {
  if (B < 0 || C <= 0 || D <= 0 || ldb < B || ldc < C || ldb % 4 || ldc % 4)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long bytes = smem_bytes(C);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opted in
  err = cudaFuncSetAttribute(smith_head_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const Side s_src{se, sc, energy, src, B, ldb}, s_tgt{te, tc, energy + B, tgt, C, ldc};
  const int rows = B > C ? B : C, lds = ldb > ldc ? ldb : ldc;
  row_energy_kernel<<<dim3((rows + 7) / 8, 2), 256, 0, st>>>(s_src, s_tgt, D);
  scale_transpose_kernel<<<dim3((lds + 31) / 32, (D + 31) / 32, 2), 256, 0, st>>>(
      s_src, s_tgt, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((B + TB - 1) / TB);
  smith_head_kernel<<<blocks, NT, bytes, st>>>(src, tgt, out, B, C, D, ldb, ldc,
                                               log_scale);
  return cudaGetLastError();
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
