// The GEMM probes of scripts/dev/ (bench_int8_mxu.py, bench_int8_sweep.py,
// bench_int4_mxu.py) as Hopper GEMMs over (operand types, block tile). All
// three scripts share one TPU body, `make_matmul`'s `kernel`
// (bench_int8_mxu.py:48, pallas_call :64; bench_int8_sweep.py:37, :53;
// bench_int4_mxu.py:33, :49): a tiled
//
//   C[M, N] = A[M, K] . B[K, N]      B row-major [K, N], as the scripts lay it out
//
// with the raw accumulator as output. Four kinds, two bodies:
//   kBF16  bf16 x bf16 -> fp32     wgmma m64nNk16 (wgmma_gemm.cuh)
//   kS8    s8 x s8 -> s32          wgmma m64nNk32 (exact; wgmma_gemm.cuh)
//   kS4    s4 x s4 -> s32          mma.sync m16n8k64 s4 (tile_gemm_kernel below)
//   kS8S4  s8 x s4 -> s32          B's nibbles unpacked to s8 in registers,
//                                  mma.sync m16n8k32 (weight-only int4)
// s4 operands are packed two a byte along K, the lower k in the low
// nibble (two's complement): A as [M, K/2] bytes, B as [K/2, N] bytes.
//
// bf16 and s8: the warp-specialised persistent wgmma GEMM of
// wgmma_gemm.cuh (a producer warp's TMA loads into an mbarrier ring, two
// consumer warpgroups, TMA-stored epilogue), at 8 configurations (BM x
// BN, ring depth, the consumers sharing each tile or taking whole tiles
// in turn; BVT_TILES). bf16 reads B [K, N] as it lies (MN-major). wgmma
// takes 8-bit operands K-major only, so the s8 call first lays B out as
// B^T [N, K] with transpose_s8_kernel, into stream-ordered scratch of
// this library's own pool, and the GEMM reads that (~8 MB moved at the
// probe shape). Every kind takes B [K, N] at the C interface.
//
// s4 and s8 x s4: the mma.sync design of csrc/int8_gemm.cuh (whose
// cp.async, ldmatrix and mma helpers are reused here), at one tile. A
// block of NT = 32 x WARPS_M x WARPS_N threads owns a BM x BN output tile;
// each warp a (BM / WARPS_M) x (BN / WARPS_N) piece of 16 x 8 mma tiles. K
// is walked 64 bytes of A a row per stage through a ring of STAGES
// shared-memory stages filled by cp.async (16 bytes a thread, zero-filled
// past the edges of M, N and K), one barrier a stage. A reaches its
// fragments through ldmatrix (rows padded to 80 bytes). B is [K, N]: its
// fragments need k-consecutive values of one column n, and sm_90 has no
// ldmatrix.trans for 8-bit elements, so each lane reads 32-bit words of 4
// consecutive columns from 4 (s4) or 2 (s8 x s4: 2 nibbles a byte)
// consecutive k rows and transposes the 4 x 4 bytes with prmt
// (`__byte_perm`) in registers. The word's 4 columns go to the 4 mma tiles
// of a 32-column group, so mma tile j's column c is the group's column
// 4c + j; that permutation is undone in the epilogue, where a lane then
// holds 8 consecutive columns of a row and stores them as two 16-byte
// vectors. The stage rows are not padded but XOR-swizzled by 16-byte
// chunk (chunk ^ 2 ((row / rows-a-lane) % 4)), so the 32 lanes of a word
// load hit 32 banks. s8 x s4: each nibble is sign-extended to a byte with
// `__vsub4` ((x ^ 8) - 8 a byte) and the bytes interleaved with prmt, so
// the s8 mma sees the exact values. ptxas for sm_90a takes
// `mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32` without a word; on
// the card it runs far below the s8 rate (PERF.md).
//
// Edges: K must be a multiple of one mma step's depth (16 bf16, 32 s8,
// 64 s4) and N of 16; every operand 16-byte aligned with rows a multiple
// of 16 bytes apart (the TMA's rule, and cp.async's 16-byte chunks); the
// wrapper raises otherwise. M and N are masked (zero-filled loads, clipped
// or skipped stores); the wgmma body also zero-fills K past its end.
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

#include <mutex>

#include "int8_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bvt_int8::cp_async16;
using bvt_int8::cp_async_commit;
using bvt_int8::cp_async_wait;
using bvt_int8::ldmatrix_x4;
using bvt_int8::mma_s8;

enum Kind { kBF16 = 0, kS8 = 1, kS4 = 2, kS8S4 = 3 };
enum BMode { kBBytes = 1, kBNibbles = 2 };

constexpr int AKB = 64;        // A bytes a row per stage
constexpr int SA = AKB + 16;   // A shared-memory row stride (bytes)

template <int KIND> struct Traits;
// (the s4 kinds) a_num / a_den: A bytes per k; b_k_per_row: k values per
// B row; b_elem: B bytes per column; step_a: A bytes per mma step; step_b:
// B rows per mma step; rows_a_lane: B rows one lane reads per fragment
// register
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
  if constexpr (KIND == kS4) {
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
  static constexpr int kBRowB = BN * Tr::b_elem;
  static constexpr int kBChunks = BN * Tr::b_elem / 16;
  static constexpr int kStage = BM * SA + kBRows * kBRowB;
  static constexpr int kSmem = STAGES * kStage;
  static_assert(WM % 16 == 0 && WN % 32 == 0, "warp piece: 16-row, 32-column multiples");
  static_assert(kBChunks % 8 == 0, "the swizzle needs 128-byte B rows");
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
      cp_async16(bs + b_swizzle<G::kBRowB, Tr::rows_a_lane>(r, cc),
                 ok ? b + (long)gr * b_rowb + gcol : b, ok ? 16 : 0);
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
  cp_async_wait<0>();

  // accumulator e of tile (i, j): row g (+8 for e >= 2), mma column
  // 2t + e % 2
#pragma unroll
  for (int i = 0; i < G::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      if (row >= M) continue;
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

// -- B^T for the s8 wgmma ------------------------------------------------------

// bt[N, K] = b[K, N]^T (bytes; K % 32 == 0, N % 16 == 0). A thread takes 32
// rows of 4 columns: 32 coalesced word loads (a warp reads 128 bytes a
// row), eight 4 x 4 byte transposes, and 32 bytes written to each of its
// 4 rows of bt.
__global__ void __launch_bounds__(128)
transpose_s8_kernel(const uint32_t* __restrict__ b, uint8_t* __restrict__ bt, int K, int N) {
  const int n4 = blockIdx.x * blockDim.x + threadIdx.x;
  if (n4 * 4 >= N) return;
  const int k0 = blockIdx.y * 32;
  const int words = N / 4;
  uint32_t w[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) w[i] = __ldg(b + (long)(k0 + i) * words + n4);
  uint32_t col[4][8];  // col[j][g]: column 4 n4 + j, rows k0 + 4g .. + 3
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    uint32_t out[4];
    transpose4(w + 4 * g, out);
#pragma unroll
    for (int j = 0; j < 4; ++j) col[j][g] = out[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint4* dst = reinterpret_cast<uint4*>(bt + (long)(4 * n4 + j) * K + k0);
    dst[0] = make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
    dst[1] = make_uint4(col[j][4], col[j][5], col[j][6], col[j][7]);
  }
}

// -- the tiles and their launch ---------------------------------------------

// BM, BN, STAGES and schedule of the 8 wgmma configurations of bf16 and
// s8 (384 threads: a producer and two consumer warpgroups;
// probes/tile_gemm.py TILES lists the same, in the same order; tile 0 is
// the default)
#define BVT_TILES(X)                        \
  X(0, 128, 128, 6, bvt_wgmma::kPingPong)  \
  X(1, 128, 128, 5, bvt_wgmma::kPingPong)  \
  X(2, 128, 128, 4, bvt_wgmma::kPingPong)  \
  X(3, 64, 256, 4, bvt_wgmma::kPingPong)   \
  X(4, 128, 256, 4, bvt_wgmma::kCoop)      \
  X(5, 128, 256, 3, bvt_wgmma::kCoop)      \
  X(6, 256, 128, 4, bvt_wgmma::kCoop)      \
  X(7, 128, 256, 2, bvt_wgmma::kCoop)
constexpr int kTiles = 8;

// the s4 kinds' one tile: BM, BN, WARPS_M, WARPS_N, STAGES
#define BVT_S4_TILE 128, 128, 2, 4, 4

using Run = int (*)(const void*, const void*, void*, int, int, int, cudaStream_t);

struct Entry {
  int bm, bn, threads, stages, smem;
  int schedule;  // bvt_wgmma::WgSchedule, or -1 (the mma.sync kernel)
  const void* fn;
  Run run;
};

template <int KIND, int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
Entry mma_entry() {
  using G = Gemm<KIND, BM, BN, WARPS_M, WARPS_N, STAGES>;
  auto* kernel = &tile_gemm_kernel<KIND, BM, BN, WARPS_M, WARPS_N, STAGES>;
  return {BM, BN, G::kThreads, STAGES, G::kSmem, -1, reinterpret_cast<const void*>(kernel),
          [](const void* a, const void* b, void* c, int M, int N, int K,
             cudaStream_t s) -> int {
            auto* k = &tile_gemm_kernel<KIND, BM, BN, WARPS_M, WARPS_N, STAGES>;
            // above 48 KB a launch is refused unless the kernel opted in
            cudaError_t err =
                cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
            if (err != cudaSuccess || M == 0) return err;
            const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
            if (grid.y > 65535) return cudaErrorInvalidValue;
            k<<<grid, G::kThreads, G::kSmem, s>>>(static_cast<const int8_t*>(a),
                                                  static_cast<const int8_t*>(b), c, M, N, K);
            return cudaGetLastError();
          }};
}

// the pool the s8 kind's B^T scratch comes from, one a device: it keeps
// what it has grown to between calls (release threshold: all), so a call
// allocates nothing once it has seen its largest B
cudaError_t scratch_pool(cudaMemPool_t* pool) {
  constexpr int kMaxDevices = 64;
  static cudaMemPool_t pools[kMaxDevices] = {};
  static std::mutex mutex;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mutex);
  if (pools[dev] == nullptr) {
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = dev;
    cudaMemPool_t p;
    err = cudaMemPoolCreate(&p, &props);
    if (err != cudaSuccess) return err;
    uint64_t all = UINT64_MAX;
    err = cudaMemPoolSetAttribute(p, cudaMemPoolAttrReleaseThreshold, &all);
    if (err != cudaSuccess) return err;
    pools[dev] = p;
  }
  *pool = pools[dev];
  return cudaSuccess;
}

// s8: B^T [N, K] laid out from B [K, N] into stream-ordered scratch, then
// the wgmma GEMM on it, on one stream
template <int BM, int BN, int STAGES, int SCHED>
int run_s8(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t stream) {
  if (M == 0) return bvt_wgmma::wgmma_gemm<bvt_wgmma::kWgS8, BM, BN, STAGES, SCHED>(
                  a, nullptr, c, M, N, K, stream);
  const dim3 grid((N / 4 + 127) / 128, K / 32);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaMemPool_t pool;
  cudaError_t err = scratch_pool(&pool);
  void* bt = nullptr;
  if (err == cudaSuccess)
    err = cudaMallocFromPoolAsync(&bt, static_cast<size_t>(N) * K, pool, stream);
  if (err != cudaSuccess) return err;
  transpose_s8_kernel<<<grid, 128, 0, stream>>>(static_cast<const uint32_t*>(b),
                                                static_cast<uint8_t*>(bt), K, N);
  int e = cudaGetLastError();
  if (e == cudaSuccess)
    e = bvt_wgmma::wgmma_gemm<bvt_wgmma::kWgS8, BM, BN, STAGES, SCHED>(a, bt, c, M, N, K,
                                                                        stream);
  err = cudaFreeAsync(bt, stream);
  return e != cudaSuccess ? e : err;
}

template <int KIND, int BM, int BN, int STAGES, int SCHED>
Entry wgmma_entry() {
  using L = bvt_wgmma::WgLayout<KIND, BM, BN, STAGES, SCHED>;
  Run run;
  if constexpr (KIND == bvt_wgmma::kWgS8)
    run = &run_s8<BM, BN, STAGES, SCHED>;
  else
    run = &bvt_wgmma::wgmma_gemm<KIND, BM, BN, STAGES, SCHED>;
  return {BM, BN, bvt_wgmma::kThreads, STAGES, L::kSmem, SCHED,
          reinterpret_cast<const void*>(
              &bvt_wgmma::wgmma_gemm_kernel<KIND, BM, BN, STAGES, SCHED>),
          run};
}

template <int KIND>
Entry sweep_entry(int tile) {
  switch (tile) {
#define BVT_CASE(i, bm, bn, st, sched) \
  case i: return wgmma_entry<KIND, bm, bn, st, sched>();
    BVT_TILES(BVT_CASE)
#undef BVT_CASE
    default: return Entry{};
  }
}

// bf16 and s8 at every tile (the sweep); s4 and s8 x s4 at their one tile
Entry lookup(int kind, int tile) {
  if (tile < 0 || tile >= kTiles) return Entry{};
  switch (kind) {
    case kBF16: return sweep_entry<bvt_wgmma::kWgBF16>(tile);
    case kS8: return sweep_entry<bvt_wgmma::kWgS8>(tile);
    case kS4: return tile == 0 ? mma_entry<kS4, BVT_S4_TILE>() : Entry{};
    case kS8S4: return tile == 0 ? mma_entry<kS8S4, BVT_S4_TILE>() : Entry{};
    default: return Entry{};
  }
}

// K a multiple of one mma step's depth, N of 16
bool shape_ok(int kind, int M, int N, int K) {
  const int depth = kind == kBF16 ? 16 : kind == kS4 ? 64 : 32;
  return M >= 0 && N > 0 && K > 0 && K % depth == 0 && N % 16 == 0;
}

}  // namespace

extern "C" {

// kind: 0 bf16 -> fp32, 1 s8 -> s32, 2 s4 x s4 -> s32, 3 s8 x s4 -> s32;
// tile: 0-7 for bf16 and s8, 0 for the others

// the tile's BM, BN, threads, stages, dynamic shared-memory bytes and
// schedule (0 cooperative, 1 ping-pong, -1 the mma.sync kernel) into
// out[0..5]; returns 0, or -1 for a (kind, tile) that is not built
int bvt_tile_gemm_describe(int kind, int tile, int* out) {
  const Entry e = lookup(kind, tile);
  if (e.fn == nullptr) return -1;
  out[0] = e.bm;
  out[1] = e.bn;
  out[2] = e.threads;
  out[3] = e.stages;
  out[4] = e.smem;
  out[5] = e.schedule;
  return 0;
}

// blocks of the tile one SM holds at once (the occupancy calculator), or
// a negative cudaError_t
int bvt_tile_gemm_blocks_per_sm(int kind, int tile) {
  const Entry e = lookup(kind, tile);
  if (e.fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(e.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, e.smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, e.fn, e.threads, e.smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// registers a thread of the tile's kernel at launch (cudaFuncGetAttributes;
// the wgmma kernel's warpgroups then move to 40 and 232 with setmaxnreg),
// or a negative cudaError_t
int bvt_tile_gemm_registers(int kind, int tile) {
  const Entry e = lookup(kind, tile);
  if (e.fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return bvt_wgmma::kernel_registers(e.fn);
}

// c[M, N] = a[M, K] . B; c fp32 for bf16, int32 otherwise. b is B [K, N]
// for bf16 and s8, packed [K/2, N] bytes for the s4 kinds (a [M, K/2]
// packed for s4 x s4). Returns 0 when
// launched (or M == 0), a cudaError_t, or a tensor-map code
// (bvt_error_string).
int bvt_tile_gemm(int kind, int tile, const void* a, const void* b, void* c, int M, int N,
                  int K, void* stream) {
  if (!shape_ok(kind, M, N, K)) return cudaErrorInvalidValue;
  const Entry e = lookup(kind, tile);
  if (e.fn == nullptr) return cudaErrorInvalidValue;
  return e.run(a, b, c, M, N, K, static_cast<cudaStream_t>(stream));
}

const char* bvt_error_string(int err) {
  switch (err) {
    case bvt_wgmma::kErrNoEncoder:
      return "cuTensorMapEncodeTiled not found (cudaGetDriverEntryPoint)";
    case bvt_wgmma::kErrEncode:
      return "cuTensorMapEncodeTiled refused an operand's tensor map";
    case bvt_wgmma::kErrRegisters:
      return "the wgmma kernel has too few registers at launch for its setmaxnreg split";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
