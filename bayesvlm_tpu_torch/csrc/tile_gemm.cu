// The GEMM probes of scripts/dev/ (bench_int8_mxu.py, bench_int8_sweep.py,
// bench_int4_mxu.py) as one templated Hopper GEMM over (operand types,
// block tile). All three scripts share one TPU body, `make_matmul`'s
// `kernel` (bench_int8_mxu.py:48, pallas_call :64; bench_int8_sweep.py:37,
// :53; bench_int4_mxu.py:33, :49): a tiled
//
//   C[M, N] = A[M, K] . B[K, N]      B row-major [K, N], as the scripts lay it out
//
// with the raw accumulator as output. Four kinds:
//   kBF16  bf16 x bf16 -> fp32     mma.sync m16n8k16
//   kS8    s8 x s8 -> s32          mma.sync m16n8k32 (exact)
//   kS4    s4 x s4 -> s32          mma.sync m16n8k64 s4
//   kS8S4  s8 x s4 -> s32          B's nibbles unpacked to s8 in registers,
//                                  m16n8k32 (weight-only int4)
// s4 operands are packed two a byte along K, the lower k in the low
// nibble (two's complement): A as [M, K/2] bytes, B as [K/2, N] bytes.
//
// The s4 mma: ptxas for sm_90a (the CUDA 12 toolkit on an H100 machine)
// takes `mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32` without a word,
// so kS4 runs it (the alternative, both operands unpacked to s8 in
// registers for m16n8k32, is what kS8S4 does to B). On the card it runs
// far below the s8 rate (PERF.md).
//
// Design. A block of NT = 32 x WARPS_M x WARPS_N threads owns a BM x BN
// output tile; each warp a (BM / WARPS_M) x (BN / WARPS_N) piece of
// 16 x 8 mma tiles. K is walked 64 bytes of A a row per stage through a
// ring of STAGES shared-memory stages filled by cp.async (16 bytes a
// thread, zero-filled past the edges of M, N and K), one barrier a stage,
// as csrc/int8_gemm.cuh's GEMM (whose cp.async, ldmatrix and mma helpers
// are reused here; its gemm_s8_kernel takes W as [N, K] and has a
// dequant epilogue, so it is not this function). A reaches its fragments
// through ldmatrix (rows padded to 80 bytes). B is [K, N]: its
// fragments need k-consecutive values of one column n.
//   - bf16: ldmatrix.trans from the row-major tile (rows padded by 16
//     bytes, so an 8-row phase hits 32 banks).
//   - 8- and 4-bit: sm_90 has no ldmatrix.trans for 8-bit elements, so
//     each lane reads 32-bit words of 4 consecutive columns from 4 (s8,
//     s4) or 2 (s8 x s4: 2 nibbles a byte) consecutive k rows and
//     transposes the 4 x 4 bytes with prmt (`__byte_perm`) in registers.
//     The word's 4 columns go to the 4 mma tiles of a 32-column group, so
//     mma tile j's column c is the group's column 4c + j; that permutation
//     is undone in the epilogue, where a lane then holds 8 consecutive
//     columns of a row and stores them as two 16-byte vectors. The stage
//     rows are not padded but XOR-swizzled by 16-byte chunk (chunk ^ 2
//     ((row / rows-a-lane) % 4)), so the 32 lanes of a word load hit 32
//     banks.
//   - s8 x s4: each nibble is
//     sign-extended to a byte with `__vsub4` ((x ^ 8) - 8 a byte) and the
//     bytes interleaved with prmt, so the s8 mma sees the exact values.
// Edges: M and N are masked (zero-filled loads, stores skipped); K must
// be a multiple of one mma step's depth (16 bf16, 32 s8, 64 s4) and N of
// 16, so a 16-byte chunk lies wholly inside or outside the operands, and
// the wrapper raises otherwise.
//
// What bounds it on an H100 at the probes' M, K, N = 16384, 1024, 4096:
// bf16 the operations (137.4 G at 989 TFLOP/s: 0.139 ms; bytes 0.093);
// s8 the bytes, chiefly the 268 MB int32 output (0.086 ms; operations at
// 1,979 TOP/s 0.069); s4 x s4 and s8 x s4 the bytes (0.083, 0.086 ms;
// NVIDIA publishes no int4 tensor rate for the H100).
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <stdint.h>

#include "int8_gemm.cuh"

namespace {

using bvt_int8::cp_async16;
using bvt_int8::cp_async_commit;
using bvt_int8::cp_async_wait;
using bvt_int8::ldmatrix_x4;
using bvt_int8::ldmatrix_x4_trans;
using bvt_int8::mma_bf16;
using bvt_int8::mma_s8;

enum Kind { kBF16 = 0, kS8 = 1, kS4 = 2, kS8S4 = 3 };
enum BMode { kBTrans = 0, kBBytes = 1, kBNibbles = 2 };

constexpr int AKB = 64;        // A bytes a row per stage
constexpr int SA = AKB + 16;   // A shared-memory row stride (bytes)

template <int KIND> struct Traits;
// a_num / a_den: A bytes per k; b_k_per_row: k values per B row; b_elem:
// B bytes per column; step_a: A bytes per mma step; step_b: B rows per mma
// step; rows_a_lane (8- and 4-bit B): B rows one lane reads per fragment
// register
template <> struct Traits<kBF16> {
  static constexpr int a_num = 2, a_den = 1, b_k_per_row = 1, b_elem = 2;
  static constexpr int step_a = 32, step_b = 16, b_mode = kBTrans;
  using Acc = float;
};
template <> struct Traits<kS8> {
  static constexpr int a_num = 1, a_den = 1, b_k_per_row = 1, b_elem = 1;
  static constexpr int step_a = 32, step_b = 32, b_mode = kBBytes, rows_a_lane = 4;
  using Acc = int;
};
template <> struct Traits<kS4> {
  static constexpr int a_num = 1, a_den = 2, b_k_per_row = 2, b_elem = 1;
  static constexpr int step_a = 32, step_b = 32, b_mode = kBBytes, rows_a_lane = 4;
  using Acc = int;
};
template <> struct Traits<kS8S4> {
  static constexpr int a_num = 1, a_den = 1, b_k_per_row = 2, b_elem = 1;
  static constexpr int step_a = 32, step_b = 16, b_mode = kBNibbles, rows_a_lane = 2;
  using Acc = int;
};

// c (16 x 8 int32) += a (16 x 64 s4, row) . b (64 x 8 s4, col); in bytes
// the fragments are laid out as m16n8k32's s8 ones
__device__ __forceinline__ void mma_s4(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KIND>
__device__ __forceinline__ void mma(typename Traits<KIND>::Acc* c, const uint32_t* a,
                                    const uint32_t* b) {
  if constexpr (KIND == kBF16) {
    mma_bf16(c, a, b);
  } else if constexpr (KIND == kS4) {
    mma_s4(c, a, b);
  } else {
    mma_s8(c, a, b);
  }
}

// the low (high) nibble of each byte of w, sign-extended to a byte
__device__ __forceinline__ uint32_t low_nibbles(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t high_nibbles(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// out[j] = byte j of w[0], w[1], w[2], w[3] (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* out) {
  const uint32_t x01l = __byte_perm(w[0], w[1], 0x5140), x01h = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t x23l = __byte_perm(w[2], w[3], 0x5140), x23h = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(x01l, x23l, 0x5410);
  out[1] = __byte_perm(x01l, x23l, 0x7632);
  out[2] = __byte_perm(x01h, x23h, 0x5410);
  out[3] = __byte_perm(x01h, x23h, 0x7632);
}

// the byte offset of (row, 16-byte chunk) in a swizzled 8- or 4-bit B stage
template <int ROWB, int RPL>
__device__ __forceinline__ int b_swizzle(int row, int chunk) {
  return row * ROWB + ((chunk ^ (((row / RPL) & 3) << 1)) << 4);
}

template <int KIND, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
struct Gemm {
  using Tr = Traits<KIND>;
  using Acc = typename Tr::Acc;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NTL = WN / 8;          // mma tiles a warp
  static constexpr int kSteps = AKB / Tr::step_a;           // mma steps a stage
  static constexpr int kBRows = Tr::step_b * kSteps;        // B rows a stage
  static constexpr bool kSwizzle = Tr::b_mode != kBTrans;
  static constexpr int kBRowB = BN * Tr::b_elem + (kSwizzle ? 0 : 16);
  static constexpr int kBChunks = BN * Tr::b_elem / 16;
  static constexpr int kStage = BM * SA + kBRows * kBRowB;
  static constexpr int kSmem = STAGES * kStage;
  static_assert(WM % 16 == 0 && WN % 32 == 0, "warp piece: 16-row, 32-column multiples");
  static_assert(!kSwizzle || kBChunks % 8 == 0, "the swizzle needs 128-byte B rows");
};

template <int KIND, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
tile_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 void* __restrict__ c, int M, int N, int K) {
  using G = Gemm<KIND, BM, BN, WARPS_M, WARPS_N, STAGES>;
  using Tr = typename G::Tr;
  using Acc = typename G::Acc;
  extern __shared__ __align__(16) int8_t smem[];  // STAGES x (A tile, B tile)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, lq = lane / 8, lr = lane % 8;
  const int wm = (warp / WARPS_N) * G::WM, wn = (warp % WARPS_N) * G::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long a_rowb = (long)K * Tr::a_num / Tr::a_den;  // A bytes a row
  const int b_rows = K / Tr::b_k_per_row;                // B rows
  const long b_rowb = (long)N * Tr::b_elem;              // B bytes a row
  // this lane's ldmatrix row and byte offset for A (see csrc/int8_gemm.cuh)
  const int a_off = (lr + (lq & 1) * 8) * SA + (lq >> 1) * 16;

  auto load_stage = [&](int s, int kt) {
    int8_t* as = smem + s * G::kStage;
    int8_t* bs = as + BM * SA;
    for (int ch = tid; ch < BM * (AKB / 16); ch += G::kThreads) {
      const int r = ch / (AKB / 16), kc = (ch % (AKB / 16)) * 16;
      const long gb = (long)kt * AKB + kc;
      const bool ok = m0 + r < M && gb < a_rowb;
      cp_async16(as + r * SA + kc, ok ? a + (long)(m0 + r) * a_rowb + gb : a, ok ? 16 : 0);
    }
    for (int ch = tid; ch < G::kBRows * G::kBChunks; ch += G::kThreads) {
      const int r = ch / G::kBChunks, cc = ch % G::kBChunks;
      const int gr = kt * G::kBRows + r;
      const long gcol = (long)n0 * Tr::b_elem + cc * 16;
      const bool ok = gr < b_rows && gcol < b_rowb;
      int8_t* dst;
      if constexpr (G::kSwizzle)
        dst = bs + b_swizzle<G::kBRowB, Tr::rows_a_lane>(r, cc);
      else
        dst = bs + r * G::kBRowB + cc * 16;
      cp_async16(dst, ok ? b + (long)gr * b_rowb + gcol : b, ok ? 16 : 0);
    }
  };

  Acc acc[G::MT][G::NTL][4];
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (int)((a_rowb + AKB - 1) / AKB);
  // one commit group per stage, empty past the end, so that group kt is
  // complete once at most STAGES - 2 groups are pending
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage read in step kt-1: every thread is past it
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next);
    cp_async_commit();
    const int8_t* as = smem + (kt % STAGES) * G::kStage;
    const int8_t* bs = as + BM * SA;
#pragma unroll
    for (int ks = 0; ks < G::kSteps; ++ks) {
      uint32_t af[G::MT][4];
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
        ldmatrix_x4(af[i], as + (wm + i * 16) * SA + ks * Tr::step_a + a_off);
      if constexpr (Tr::b_mode == kBTrans) {
        // matrices (k 0-7, n 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        // are b0, b1 of two 8-column tiles
#pragma unroll
        for (int j = 0; j < G::NTL; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bs + (ks * Tr::step_b + (lq & 1) * 8 + lr) * G::kBRowB +
                                   (wn + j * 8 + (lq >> 1) * 8) * Tr::b_elem);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
          for (int i = 0; i < G::MT; ++i) {
            mma<KIND>(acc[i][j], af[i], b0);
            mma<KIND>(acc[i][j + 1], af[i], b1);
          }
        }
      } else {
        // 32-column groups: this lane's word holds columns 4g .. 4g+3 of
        // the group, one for each of its 4 mma tiles
#pragma unroll
        for (int grp = 0; grp < G::NTL / 4; ++grp) {
          const int chunk = (wn + grp * 32 + 4 * g) >> 4, in = (4 * g) & 15;
          uint32_t bf[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t w[4];
            if constexpr (Tr::b_mode == kBBytes) {
              // b_h: k rows step + 16h + 4t .. +3 (a byte each)
              const int r0 = ks * Tr::step_b + h * 16 + 4 * t;
#pragma unroll
              for (int i = 0; i < 4; ++i)
                w[i] = *reinterpret_cast<const uint32_t*>(
                    bs + b_swizzle<G::kBRowB, Tr::rows_a_lane>(r0 + i, chunk) + in);
            } else {
              // b_h: k 16h + 4t .. +3 = packed rows step + 8h + 2t, +1
              const int r0 = ks * Tr::step_b + h * 8 + 2 * t;
              const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
                  bs + b_swizzle<G::kBRowB, Tr::rows_a_lane>(r0, chunk) + in);
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
                  bs + b_swizzle<G::kBRowB, Tr::rows_a_lane>(r0 + 1, chunk) + in);
              w[0] = low_nibbles(w0);
              w[1] = high_nibbles(w0);
              w[2] = low_nibbles(w1);
              w[3] = high_nibbles(w1);
            }
            transpose4(w, bf[h]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t bj[2] = {bf[0][j], bf[1][j]};
#pragma unroll
            for (int i = 0; i < G::MT; ++i) mma<KIND>(acc[i][grp * 4 + j], af[i], bj);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator e of tile (i, j): row g (+8 for e >= 2), mma column
  // 2t + e % 2
#pragma unroll
  for (int i = 0; i < G::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      if (row >= M) continue;
      if constexpr (Tr::b_mode == kBTrans) {
        float* out = static_cast<float*>(c) + (long)row * N;
#pragma unroll
        for (int j = 0; j < G::NTL; ++j) {
          const int col = n0 + wn + j * 8 + 2 * t;  // N is even: col + 1 < N too
          if (col < N)
            *reinterpret_cast<float2*>(out + col) = make_float2(acc[i][j][2 * h],
                                                                acc[i][j][2 * h + 1]);
        }
      } else {
        // mma column c of tile 4 grp + j is group column 4c + j: this lane
        // holds columns 8t .. 8t+7 of each group (N % 16 == 0: all in or out)
        int* out = static_cast<int*>(c) + (long)row * N;
#pragma unroll
        for (int grp = 0; grp < G::NTL / 4; ++grp) {
          const int col = n0 + wn + grp * 32 + 8 * t;
          if (col >= N) continue;
          const Acc* x0 = acc[i][grp * 4];
          const Acc* x1 = acc[i][grp * 4 + 1];
          const Acc* x2 = acc[i][grp * 4 + 2];
          const Acc* x3 = acc[i][grp * 4 + 3];
          *reinterpret_cast<int4*>(out + col) =
              make_int4(x0[2 * h], x1[2 * h], x2[2 * h], x3[2 * h]);
          *reinterpret_cast<int4*>(out + col + 4) =
              make_int4(x0[2 * h + 1], x1[2 * h + 1], x2[2 * h + 1], x3[2 * h + 1]);
        }
      }
    }
  }
}

// -- the tiles and their launch ---------------------------------------------

// BM, BN, WARPS_M, WARPS_N, STAGES of the 8 block tiles (probes/tile_gemm.py
// TILES lists the same, in the same order; tile 0 is the default)
#define BVT_TILES(X)   \
  X(0, 128, 128, 2, 4, 4) \
  X(1, 128, 128, 2, 4, 3) \
  X(2, 128, 128, 2, 4, 2) \
  X(3, 64, 128, 1, 4, 4)  \
  X(4, 128, 256, 2, 4, 3) \
  X(5, 256, 128, 4, 2, 3) \
  X(6, 64, 256, 1, 4, 4)  \
  X(7, 256, 128, 4, 2, 4)
constexpr int kTiles = 8;

struct Entry {
  int bm, bn, threads, stages, smem;
  const void* fn;
  void (*launch)(dim3, int, cudaStream_t, const int8_t*, const int8_t*, void*, int, int,
                 int);
};

template <int KIND, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
Entry entry() {
  using G = Gemm<KIND, BM, BN, WARPS_M, WARPS_N, STAGES>;
  return {BM, BN, G::kThreads, STAGES, G::kSmem,
          reinterpret_cast<const void*>(
              &tile_gemm_kernel<KIND, BM, BN, WARPS_M, WARPS_N, STAGES>),
          [](dim3 grid, int smem, cudaStream_t s, const int8_t* a, const int8_t* b, void* c,
             int M, int N, int K) {
            tile_gemm_kernel<KIND, BM, BN, WARPS_M, WARPS_N, STAGES>
                <<<grid, G::kThreads, smem, s>>>(a, b, c, M, N, K);
          }};
}

template <int KIND>
Entry sweep_entry(int tile) {
  switch (tile) {
#define BVT_CASE(i, bm, bn, wm, wn, st) \
  case i: return entry<KIND, bm, bn, wm, wn, st>();
    BVT_TILES(BVT_CASE)
#undef BVT_CASE
    default: return Entry{};
  }
}

// bf16 and s8 at every tile (the sweep); s4 and s8 x s4 at tile 0 only
Entry lookup(int kind, int tile) {
  if (tile < 0 || tile >= kTiles) return Entry{};
  switch (kind) {
    case kBF16: return sweep_entry<kBF16>(tile);
    case kS8: return sweep_entry<kS8>(tile);
    case kS4: return tile == 0 ? entry<kS4, 128, 128, 2, 4, 4>() : Entry{};
    case kS8S4: return tile == 0 ? entry<kS8S4, 128, 128, 2, 4, 4>() : Entry{};
    default: return Entry{};
  }
}

// K a multiple of one mma step's depth, N of 16
bool shape_ok(int kind, int M, int N, int K) {
  const int depth = kind == kBF16 ? 16 : kind == kS4 ? 64 : 32;
  return M >= 0 && N > 0 && K > 0 && K % depth == 0 && N % 16 == 0;
}

cudaError_t prepare(const Entry& e) {
  if (e.fn == nullptr) return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opted in
  return cudaFuncSetAttribute(e.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, e.smem);
}

}  // namespace

extern "C" {

// kind: 0 bf16 -> fp32, 1 s8 -> s32, 2 s4 x s4 -> s32, 3 s8 x s4 -> s32;
// tile: 0-7 for bf16 and s8, 0 for the others

// the tile's BM, BN, threads, stages and dynamic shared-memory bytes into
// out[0..4]; returns 0, or -1 for a (kind, tile) that is not built
int bvt_tile_gemm_describe(int kind, int tile, int* out) {
  const Entry e = lookup(kind, tile);
  if (e.fn == nullptr) return -1;
  out[0] = e.bm;
  out[1] = e.bn;
  out[2] = e.threads;
  out[3] = e.stages;
  out[4] = e.smem;
  return 0;
}

// blocks of the tile one SM holds at once (the occupancy calculator), or
// a negative cudaError_t
int bvt_tile_gemm_blocks_per_sm(int kind, int tile) {
  const Entry e = lookup(kind, tile);
  cudaError_t err = prepare(e);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, e.fn, e.threads, e.smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}


// c[M, N] = a[M, K] . b[K, N] (s4: a [M, K/2], b [K/2, N] packed bytes);
// c fp32 for bf16, int32 otherwise. Returns a cudaError_t (0 = launched).
int bvt_tile_gemm(int kind, int tile, const void* a, const void* b, void* c, int M, int N,
                  int K, void* stream) {
  if (!shape_ok(kind, M, N, K)) return cudaErrorInvalidValue;
  const Entry e = lookup(kind, tile);
  cudaError_t err = prepare(e);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  const dim3 grid((N + e.bn - 1) / e.bn, (M + e.bm - 1) / e.bm);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  e.launch(grid, e.smem, static_cast<cudaStream_t>(stream), static_cast<const int8_t*>(a),
           static_cast<const int8_t*>(b), c, M, N, K);
  return cudaGetLastError();
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
