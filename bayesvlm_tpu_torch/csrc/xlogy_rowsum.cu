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
// operations, 6.8 ms at 989 TFLOP/s (3.4 ms at the int8 rate; 7.6 ms at
// the padded K = 112 the kernel multiplies). The logs are M N = 3.38e10;
// MUFU lg2 issues 16 per SM per clock, ~8.1 ms at 132 SMs and 1.98 GHz.
// The fp32 epilogue issues beside them: scale, clamp and FMA an element
// (int8: also the conversion and two more products).
// On this card the products and the epilogue's fp32 instructions of one
// SM barely overlap (PERF.md, the EPIG kernel's findings: products alone
// 8.2 ms, the epilogue alone 10.6, without its log 10.9 with the
// products), so their sum, not the log count alone, is what the design
// works against. For comparison,
// writing the joint out in fp32, as a plain cuBLAS product would, moves
// >= 135 GB: >= 40 ms. This version's time on the card against that
// bound is in PERF.md (chip_smoke.py).
//
// Design. A block owns BM = 256 pool rows and walks ALL target rows in
// tiles of BN = 64. It has 640 threads, a producer warpgroup and four
// consumer warpgroups:
//   - one producer thread keeps TMA loads of B tiles in flight into a ring
//     of kStages stages (full / empty mbarriers). A stage row is K bytes
//     of one target, in 128-byte chunks (64 bf16 / 128 s8, one TMA box
//     each, in the 128-byte swizzle wgmma reads without bank conflicts);
//     the TMA zero-fills targets past N and bytes past K (K = 112 bf16
//     fills two 64-value chunks, the second's last 16 with zeros, and only
//     the 7 k-steps of K are multiplied). The int8 kernel's stage also
//     holds the tile's b_scale (a rank-1 TMA box).
//   - each consumer owns 64 pool rows (one m64 wgmma product) for its
//     life, their A fragments loaded once from device memory into
//     registers (K <= 128 bf16 / 256 int8: at most 8 k-steps of 32 bytes,
//     4 registers each; 28 at the operating point). A tile is one
//     m64n64k16 bf16 / m64n64k32 s8 product a k-step, A from registers,
//     then its epilogue. All four consumers read every B stage, which is
//     freed when all 16 of their warps are done with it: one pass over B
//     serves 256 pool rows, half the L2 traffic of a 128-row block.
//   - products and logs overlap between consumers: four warps an SMSP take
//     turns at the tensor core, MUFU and the fp32 pipe, and run free (they
//     share only the ring). 32 accumulators and 28 A registers leave the
//     epilogue room under the 96 registers a thread of 640 threads gets,
//     so no register split is needed. Measured against the alternatives
//     on this card (PERF.md, the EPIG kernel's findings), bf16: two
//     consumers of 128 rows, each with its two products' wgmma groups
//     beside each other's epilogue, took 1.11x as long, three consumers
//     of 64 rows 1.34x; at 128 rows a consumer BN = 128 spilled and A
//     from shared memory was no faster.
//   - a term: s = acc * (1/K) (int8: the products above), then s *
//     lg2(max(s, FLT_MIN)) into the tile's per-row sums, which go into the
//     row's running sum. The int8 conversion s32 -> fp32 is I2F
//     (__int2float_rn, exact below 2^24 > K * 127^2 for K <= 1040): the
//     exact magic-number form (an integer add and a float subtract on the
//     full-rate pipes instead) measured 4% slower, as the epilogue's
//     fp32-pipe instructions, not MUFU, are what the products crowd out.
//   - after the last tile the 4 threads of a row quad add their sums by
//     shuffles and each row sum is written once: no atomics, no other
//     warp shares a row, the result is deterministic.
// The grid is ceil(M / 256) blocks, one an SM (1016 at the operating
// point). The TPU's sequential target grid axis and its [1, M] scratch
// are gone: the loop inside the block takes their place.
//
// Longer rows (K > 128 bf16 / 256 int8) take the streamed instantiation:
// the same ring with stages of (A chunk, B chunk), 128 bytes of each of
// the block's 256 pool rows and of a tile's 128 targets, in a block of
// 384 threads (csrc/wgmma_gemm.cuh's shape: setmaxnreg drops the producer
// to 40 registers) whose two consumers own 128 rows each. A comes
// from the stage by descriptor (m64n128 wgmma, both operands K-major), the
// accumulators are kept across the chunks of a B tile and the epilogue
// runs only after the last one: xlogy is not linear, so every dot must be
// whole first. Both consumers take each stage at once, so their epilogues
// do not overlap their own products; the wgmma of chunk c + 1 is issued
// before chunk c's stage is freed.
//
// Every operand must start 16-byte aligned, with rows a multiple of 16
// bytes apart (the TMA's rule; the wrapper's padded copies are).
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <float.h>

#include "int8_gemm.cuh"   // quant_rows: the int8 operands
#include "wgmma_gemm.cuh"  // wgmma, TMA and mbarrier PTX, the tensor-map encoder

namespace {

namespace wg = bvt_wgmma;

constexpr int BM = 256;               // pool rows a block
constexpr int BN = 64;                // targets a resident tile (wgmma's N)
constexpr int BNS = 128;              // targets a streamed tile
constexpr int kThreadsR = 640;        // resident: a producer and 4 consumer warpgroups
constexpr int kRowsS = 128;           // streamed: pool rows a consumer (of 2)
constexpr int kStages = 4;
constexpr int kChunk = wg::kRowBytes;  // bytes of K a TMA box (the swizzle span)
constexpr int kRegBytes = 256;         // the most K bytes a resident block holds
constexpr float kLn2 = 0.693147180559945309f;
static_assert(BM == (kThreadsR / 128 - 1) * 64, "resident: one m64 product a consumer");
static_assert(BM == (wg::kThreads / 128 - 1) * kRowsS, "streamed: a producer and 2 consumers");

// log2(x) by MUFU, for normal x (subnormals would read as 0)
__device__ __forceinline__ float lg2_ftz(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the products by operand type: A from registers (resident, N = BN) or a
// descriptor (streamed, N = BNS), B K-major from a descriptor
template <bool kInt8> struct Op;
template <> struct Op<false> {
  using Acc = float;
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int sd) {
    wg::wgmma_rs_bf16_n64(d, a, db, sd);
  }
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int sd) {
    wg::wgmma_bf16_n128<0>(d, da, db, sd);
  }
};
template <> struct Op<true> {
  using Acc = int;
  static __device__ __forceinline__ void rs(int* d, const uint32_t* a, uint64_t db, int sd) {
    wg::wgmma_rs_s8_n64(d, a, db, sd);
  }
  static __device__ __forceinline__ void ss(int* d, uint64_t da, uint64_t db, int sd) {
    wg::wgmma_s8_n128(d, da, db, sd);
  }
};

// H m64 products' terms of a tile into this thread's row sums (two a
// product), by way of the tile's own sums (a row's error grows with NT / 4
// + N / NT sequential adds, not N / 4). Accumulator 4 jn + 2 h + e of a
// product: its row 16 warp + g + 8 h, target column 8 jn + 2 t + e of the
// tile; bsc the tile's b_scale (int8), asc the rows' a_scale
template <bool kInt8, int NT, int H>
__device__ __forceinline__ void add_terms(const typename Op<kInt8>::Acc (*d)[NT / 2],
                                          const float* bsc, const float (*asc)[2], int t,
                                          float inv_k, float (*part)[2]) {
  float tile[H][2] = {};
#pragma unroll
  for (int jn = 0; jn < NT / 8; ++jn) {
    float bv[2] = {0.f, 0.f};
    if constexpr (kInt8) {
      const float2 b2 = *reinterpret_cast<const float2*>(bsc + 8 * jn + 2 * t);
      bv[0] = b2.x;
      bv[1] = b2.y;
    }
#pragma unroll
    for (int mi = 0; mi < H; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s;
          if constexpr (kInt8)
            s = __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(d[mi][4 * jn + 2 * h + e]), bv[e]),
                                    asc[mi][h]),
                          inv_k);
          else
            s = __fmul_rn(d[mi][4 * jn + 2 * h + e], inv_k);
          tile[mi][h] = fmaf(s, lg2_ftz(fmaxf(s, FLT_MIN)), tile[mi][h]);
        }
  }
#pragma unroll
  for (int mi = 0; mi < H; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) part[mi][h] += tile[mi][h];
}

// this warp is done with a stage (its wgmma waited for, its reads made)
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) wg::mbar_arrive(empty);
}

// the 4 threads of a row quad add their sums; each row is written once.
// This thread's rows: row0 + 64 mi + 8 h.
template <int H>
__device__ __forceinline__ void write_rows(float (&part)[H][2], long row0, int M, int t,
                                           float* out) {
#pragma unroll
  for (int mi = 0; mi < H; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = part[mi][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const long row = row0 + mi * 64 + 8 * h;
      if (t == 0 && row < M) out[row] = __fmul_rn(v, kLn2);
    }
}

// this thread's rows' a_scale (int8; 0 past M)
template <int H>
__device__ __forceinline__ void load_row_scales(float (&asc)[H][2], const float* a_scale,
                                                long row0, int M) {
#pragma unroll
  for (int mi = 0; mi < H; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = row0 + mi * 64 + 8 * h;
      asc[mi][h] = row < M ? a_scale[row] : 0.f;
    }
}

// the shared memory after the 1024-byte-aligned ring: kStages tiles' int8
// column scales, then the full and empty barriers (an empty barrier counts
// every consumer warp)
__host__ __device__ constexpr int smem_bytes(int stage, int cols) {
  return 1024 + kStages * (stage + cols * 4) + 2 * kStages * 8;
}
template <int KS>
__host__ __device__ constexpr int resident_stage() {
  return (32 * KS + kChunk - 1) / kChunk * BN * kChunk;
}
constexpr int kStreamStage = (BM + BNS) * kChunk;

struct Smem {
  uint8_t* ring;
  float* bsc;
  uint64_t *full, *empty;
};

// the ring (aligned to the swizzle's 1024-byte period), the scales and the
// barriers, initialised by thread 0
__device__ __forceinline__ Smem setup(uint8_t* raw, int stage, int cols, int arrivals) {
  Smem m;
  m.ring = raw + ((1024 - (wg::smem_u32(raw) & 1023)) & 1023);
  m.bsc = reinterpret_cast<float*>(m.ring + kStages * stage);
  m.full = reinterpret_cast<uint64_t*>(m.bsc + kStages * cols);
  m.empty = m.full + kStages;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&m.full[s], 1);  // the producer's expect_tx, then the bytes
      wg::mbar_init(&m.empty[s], arrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return m;
}

// -- the resident instantiation: A in registers (kb = 32 KS <= 256) --------

// the smem address of tile j's stage, once the TMA has filled it
__device__ __forceinline__ uint32_t full_stage(const Smem& sm, int stage_bytes, int j) {
  wg::mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
  return wg::smem_u32(sm.ring + (j % kStages) * stage_bytes);
}

// one m64 product of a tile, A from this thread's fragments, B the stage
// at b_s (k-step ks: chunk ks / 4, 32 bytes along its rows), committed as
// one group
template <bool kInt8, int KS>
__device__ __forceinline__ void issue(typename Op<kInt8>::Acc* d, const uint32_t (&af)[KS][4],
                                      uint32_t b_s) {
  wg::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    Op<kInt8>::rs(d, af[ks],
                  wg::smem_desc(b_s + (ks / 4) * BN * kChunk + (ks % 4) * 32, 16, 1024),
                  ks != 0);
  wg::wgmma_commit();
}

// tma_b: B [N, K] (box 128 bytes x BN, 128-byte swizzle); tma_bs: int8
// b_scale [N] (box BN); a [M, kb] bytes, a_scale [M] (int8); out [M]
template <bool kInt8, int KS>
__global__ void __launch_bounds__(kThreadsR, 1)
xlogy_rowsum_kernel(const __grid_constant__ CUtensorMap tma_b,
                    const __grid_constant__ CUtensorMap tma_bs, const int8_t* __restrict__ a,
                    const float* __restrict__ a_scale, float* __restrict__ out, int M, int N,
                    float inv_k) {
  using Acc = typename Op<kInt8>::Acc;
  constexpr int kb = 32 * KS;
  constexpr int kChunks = (kb + kChunk - 1) / kChunk;
  constexpr int kStage = resident_stage<KS>();
  constexpr int kBK = kInt8 ? kChunk : kChunk / 2;  // K values a box
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm = setup(smem_raw, kStage, kInt8 ? BN : 0, kThreadsR / 32 - 4);
  const int ntiles = (N + BN - 1) / BN;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wgi == 0) {
    // -- producer: one thread keeps the ring full -----------------------------
    if (tid != 0) return;
    wg::prefetch_map(&tma_b);
    if constexpr (kInt8) wg::prefetch_map(&tma_bs);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      wg::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);  // round 0 passes
      wg::mbar_expect_tx(&sm.full[s], kStage + (kInt8 ? BN * 4 : 0));
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        wg::tma_load_2d(sm.ring + s * kStage + c * BN * kChunk, &tma_b, &sm.full[s], c * kBK,
                        j * BN);
      if constexpr (kInt8) wg::tma_load_1d(sm.bsc + s * BN, &tma_bs, &sm.full[s], j * BN);
    }
    return;
  }

  // -- consumers: 64 pool rows each ---------------------------------------------
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // this thread's rows: row0 and row0 + 8
  const long row0 = static_cast<long>(blockIdx.x) * BM + (wgi - 1) * 64 + warp * 16 + g;
  // the A fragments: register q of k-step ks holds row0 + 8 (q & 1), bytes
  // ks * 32 + 16 (q >> 1) + 4 t .. + 3 (zero past M)
  uint32_t af[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long row = row0 + (q & 1) * 8;
      af[ks][q] = row < M ? __ldg(reinterpret_cast<const uint32_t*>(
                                a + row * kb + ks * 32 + (q >> 1) * 16 + 4 * t))
                          : 0u;
    }
  float asc[1][2] = {};
  if constexpr (kInt8) load_row_scales(asc, a_scale, row0, M);
  Acc d[1][BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[0][i] = 0;
  float part[1][2] = {};  // [row, row + 8]: sums of s log2 s
  for (int j = 0; j < ntiles; ++j) {
    issue<kInt8, KS>(d[0], af, full_stage(sm, kStage, j));
    wg::wgmma_wait<0>();
    wg::fence_regs<BN / 2>(d[0]);
    add_terms<kInt8, BN, 1>(d, sm.bsc + (j % kStages) * BN, asc, t, inv_k, part);
    release(&sm.empty[j % kStages], lane);  // after its products and b_scale reads
  }
  write_rows(part, row0, M, t, out);
}

// -- the streamed instantiation: any kb, (A chunk, B chunk) stages -----------

// tma_a: A [M, K] (box 128 bytes x BM); tma_b: B [N, K] (box 128 bytes x
// BNS); tma_bs: int8 b_scale [N] (box BNS); all else as the resident one.
// Step it of the ring holds B tile it / nchunks and K chunk it % nchunks.
template <bool kInt8>
__global__ void __launch_bounds__(wg::kThreads, 1)
xlogy_rowsum_stream_kernel(const __grid_constant__ CUtensorMap tma_a,
                           const __grid_constant__ CUtensorMap tma_b,
                           const __grid_constant__ CUtensorMap tma_bs,
                           const float* __restrict__ a_scale, float* __restrict__ out, int M,
                           int N, int kb, float inv_k) {
  using Acc = typename Op<kInt8>::Acc;
  constexpr int kBK = kInt8 ? kChunk : kChunk / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm = setup(smem_raw, kStreamStage, kInt8 ? BNS : 0, wg::kThreads / 32 - 4);
  const int ntiles = (N + BNS - 1) / BNS, nchunks = (kb + kChunk - 1) / kChunk;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wgi == 0) {
    wg::setmaxnreg_dec<wg::kProducerRegs>();
    if (tid != 0) return;
    wg::prefetch_map(&tma_a);
    wg::prefetch_map(&tma_b);
    if constexpr (kInt8) wg::prefetch_map(&tma_bs);
    int it = 0;
    for (int j = 0; j < ntiles; ++j)
      for (int c = 0; c < nchunks; ++c, ++it) {
        const int s = it % kStages;
        const bool scales = kInt8 && c == nchunks - 1;  // the epilogue's stage
        wg::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        wg::mbar_expect_tx(&sm.full[s], kStreamStage + (scales ? BNS * 4 : 0));
        uint8_t* st = sm.ring + s * kStreamStage;
        wg::tma_load_2d(st, &tma_a, &sm.full[s], c * kBK, blockIdx.x * BM);
        wg::tma_load_2d(st + BM * kChunk, &tma_b, &sm.full[s], c * kBK, j * BNS);
        if (scales) wg::tma_load_1d(sm.bsc + s * BNS, &tma_bs, &sm.full[s], j * BNS);
      }
    return;
  }

  wg::setmaxnreg_inc<wg::kConsumerRegs>();
  const int cw = wgi - 1, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const long row0 = static_cast<long>(blockIdx.x) * BM + cw * kRowsS + warp * 16 + lane / 4;
  float asc[2][2] = {};
  if constexpr (kInt8) load_row_scales(asc, a_scale, row0, M);
  Acc d[2][BNS / 2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < BNS / 2; ++i) d[mi][i] = 0;
  float part[2][2] = {};

  int it = 0;
  for (int j = 0; j < ntiles; ++j) {
    int prev = 0;
    for (int c = 0; c < nchunks; ++c, ++it) {
      const int s = it % kStages;
      wg::mbar_wait(&sm.full[s], (it / kStages) & 1);
      const uint32_t a_s = wg::smem_u32(sm.ring + s * kStreamStage) + cw * kRowsS * kChunk;
      const uint32_t b_s = wg::smem_u32(sm.ring + s * kStreamStage) + BM * kChunk;
      const int nks = min(kChunk, kb - c * kChunk) / 32;  // k-steps in this chunk
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 32; ++ks) {
        if (ks >= nks) break;
        const uint64_t db = wg::smem_desc(b_s + ks * 32, 16, 1024);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          Op<kInt8>::ss(d[mi], wg::smem_desc(a_s + mi * 64 * kChunk + ks * 32, 16, 1024), db,
                        (c | ks) != 0);
      }
      wg::wgmma_commit();
      if (c > 0) {
        // chunk c-1's products are done: free its stage
        wg::wgmma_wait<1>();
        release(&sm.empty[prev], lane);
      }
      prev = s;
    }
    wg::wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) wg::fence_regs<BNS / 2>(d[mi]);
    if constexpr (!kInt8) release(&sm.empty[prev], lane);
    add_terms<kInt8, BNS, 2>(d, sm.bsc + prev * BNS, asc, t, inv_k, part);
    if constexpr (kInt8) release(&sm.empty[prev], lane);
  }
  write_rows(part, row0, M, t, out);
}

// -- the host side -------------------------------------------------------------

// a row-major [rows, k] operand (bf16 or s8) in boxes of box_rows x 128
// bytes, 128-byte swizzle, zero fill
int encode_rows(CUtensorMap* map, bool int8, const void* base, int k, int rows, int box_rows) {
  const int elem = int8 ? 1 : 2;
  return wg::encode_2d(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       base, k, rows, static_cast<uint64_t>(k) * elem, kChunk / elem, box_rows);
}

// a [n] fp32 vector in boxes of `box` values, no swizzle, zero fill
int encode_scales(CUtensorMap* map, const float* base, int n, int box) {
  const wg::EncodeTiled fn = wg::encoder();
  if (fn == nullptr) return wg::kErrNoEncoder;
  cuuint64_t dim[1] = {static_cast<cuuint64_t>(n)}, stride[1] = {static_cast<cuuint64_t>(n) * 4};
  cuuint32_t bx[1] = {static_cast<cuuint32_t>(box)}, unit[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dim,
                        stride, bx, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : wg::kErrEncode;
}

// a kernel opted in to its shared memory, with (streamed) the registers at
// launch its setmaxnreg split needs (0, a cudaError_t or wg::kErrRegisters)
int prepare(const void* kernel, int smem, bool streamed) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int regs = wg::kernel_registers(kernel);
  if (regs < 0) return -regs;
  if (streamed && regs * wg::kThreads < 128 * wg::kProducerRegs + 256 * wg::kConsumerRegs)
    return wg::kErrRegisters;
  return 0;
}

// the instantiation for (int8, streamed, kb) and its dynamic shared memory
// (kernel null: no instantiation takes that kb resident)
template <bool kInt8, int KS = 8>
void pick_resident(int kb, const void*& kernel, int& smem) {
  if constexpr (KS > 0) {
    if (kb == 32 * KS) {
      kernel = reinterpret_cast<const void*>(xlogy_rowsum_kernel<kInt8, KS>);
      smem = smem_bytes(resident_stage<KS>(), kInt8 ? BN : 0);
      return;
    }
    pick_resident<kInt8, KS - 1>(kb, kernel, smem);
  }
}

void pick(bool int8, bool streamed, int kb, const void*& kernel, int& smem) {
  kernel = nullptr;
  if (streamed) {
    kernel = int8 ? reinterpret_cast<const void*>(xlogy_rowsum_stream_kernel<true>)
                  : reinterpret_cast<const void*>(xlogy_rowsum_stream_kernel<false>);
    smem = smem_bytes(kStreamStage, int8 ? BNS : 0);
  } else if (int8) {
    pick_resident<true>(kb, kernel, smem);
  } else {
    pick_resident<false>(kb, kernel, smem);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// a [M, k] and b [N, k] values (bf16 or s8; k a multiple of 16 / 32),
// a_scale [M] and b_scale [N] read by int8 only; out [M]
int launch(bool int8, const void* a, const float* a_scale, const void* b, const float* b_scale,
           float* out, int M, int N, int k, float inv_k, int streamed, cudaStream_t stream) {
  int kb = int8 ? k : 2 * k;
  if (k <= 0 || kb % 32 != 0 || M < 0 || N < 0) return cudaErrorInvalidValue;
  if (!streamed && kb > kRegBytes) return cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(b) || (int8 && !aligned16(b_scale)))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  if (N == 0)  // every row sums nothing
    return cudaMemsetAsync(out, 0, static_cast<size_t>(M) * sizeof(float), stream);
  const void* kernel;
  int smem;
  pick(int8, streamed, kb, kernel, smem);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int err = prepare(kernel, smem, streamed);
  if (err != 0) return err;
  CUtensorMap ma = {}, mb = {}, ms = {};
  err = encode_rows(&mb, int8, b, k, N, streamed ? BNS : BN);
  if (err == 0 && streamed) err = encode_rows(&ma, int8, a, k, M, BM);
  if (err == 0 && int8) err = encode_scales(&ms, b_scale, N, streamed ? BNS : BN);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>((M + BM - 1) / BM);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  if (streamed) {
    void* args[] = {&ma, &mb, &ms, &a_scale, &out, &M, &N, &kb, &inv_k};
    return cudaLaunchKernel(kernel, grid, wg::kThreads, args, smem, stream);
  }
  void* args[] = {&mb, &ms, &a8, &a_scale, &out, &M, &N, &inv_k};
  return cudaLaunchKernel(kernel, grid, kThreadsR, args, smem, stream);
}

}  // namespace

extern "C" {

// a [M, k] and b [N, k] bf16, row-major, k a multiple of 16 (zero-padded);
// out [M] fp32; streamed: 1 for the streamed instantiation (any k), 0 for
// the resident one (k <= 128). Returns 0 (launched), a cudaError_t or a
// tensor-map / register code of wgmma_gemm.cuh (bvt_error_string).
int bvt_xlogy_rowsum_bf16(const void* a, const void* b, float* out, int M, int N, int k,
                          float inv_k, int streamed, void* stream) {
  if (k <= 0 || k % 16 != 0) return cudaErrorInvalidValue;
  return launch(false, a, nullptr, b, nullptr, out, M, N, k, inv_k, streamed,
                static_cast<cudaStream_t>(stream));
}

// a [M, k] and b [N, k] bf16, row-major, k a multiple of 32 (zero-padded),
// quantized per row into the scratch aq [M, k] + a_scale [M] and
// bq [N, k] + b_scale [N]; then the int8 kernel (streamed as above; the
// resident one takes k <= 256). Three launches on the caller's stream.
// Returns as bvt_xlogy_rowsum_bf16.
int bvt_xlogy_rowsum_int8(const void* a, const void* b, int8_t* aq, float* a_scale, int8_t* bq,
                          float* b_scale, float* out, int M, int N, int k, float inv_k,
                          int streamed, void* stream) {
  if (k <= 0 || k % 32 != 0) return cudaErrorInvalidValue;
  if (!streamed && k > kRegBytes) return cudaErrorInvalidValue;  // before quantizing
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bvt_int8::quant_rows<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(a), M, k, nullptr, nullptr, 0.f, aq, a_scale, st);
  if (err != cudaSuccess) return err;
  err = bvt_int8::quant_rows<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(b), N, k, nullptr,
                                            nullptr, 0.f, bq, b_scale, st);
  if (err != cudaSuccess) return err;
  return launch(true, aq, a_scale, bq, b_scale, out, M, N, k, inv_k, streamed, st);
}

// what the instantiation a launch at (int8, streamed, k) takes: dynamic
// shared memory a block, blocks an SM (the occupancy calculator),
// registers a thread at launch (the streamed one's warpgroups then move to
// 40 / 232 with setmaxnreg), local memory a thread, the device's opt-in
// limit of shared memory a block and threads a block, into out[0..5].
// Returns 0 or a cudaError_t.
int bvt_xlogy_rowsum_resources(int int8, int streamed, int k, int* out) {
  const int kb = int8 ? k : 2 * k;
  if (k <= 0 || kb % 32 != 0 || (!streamed && kb > kRegBytes)) return cudaErrorInvalidValue;
  const void* kernel;
  int smem;
  pick(int8 != 0, streamed != 0, kb, kernel, smem);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, streamed ? wg::kThreads : kThreadsR, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int dev = 0, limit = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  out[0] = smem;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = limit;
  out[5] = streamed ? wg::kThreads : kThreadsR;
  return 0;
}

const char* bvt_error_string(int err) { return wg::error_string(err); }

}  // extern "C"
