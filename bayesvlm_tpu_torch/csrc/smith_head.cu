// Fused probit zero-shot head: the tail of the Smith chain in one kernel,
//
//   mean  = e_s . e_t^T / (sqrt(E_s) sqrt(E_t))                  [B, C]
//   var   = (n_s . sigma_t^T + sigma_s . (e_t^2)^T) / (E_s E_t)  [B, C]
//   probs = softmax(mean e^s / sqrt(1 + pi/8 var e^{2s}))   over the C columns
//
// with n = e^2 + sigma and E = sum_k n per row: the TPU kernel's row-scaled
// operands (smith_pallas.py:161-171), the scales applied after the
// products instead of before them. The [B, C] mean and variance never
// reach device memory.
//
// Replaces the TPU kernel `_smith_kernel` of
// bayesvlm_tpu/probforward/kernels/smith_pallas.py (called through
// `fused_probit_probs`), which takes every operand in fp32. The products
// run on the tensor cores as TF32 wgmma in three passes (3xTF32): each
// operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
// a . b is summed as hi.hi + hi.lo + lo.hi in fp32. One TF32 pass keeps 10
// mantissa bits and misses the head's 1e-4 tolerance at SigLIP's logit
// scale (s = 4.7651); three passes keep ~21 bits and hold it
// (tests/test_torch_smith_fused.py emulates both). Nine wgmma a k8 step:
// the mean three, the two variance products three each into one
// accumulator. The probit is mu * rsqrt(1 + v) with the MUFU's rsqrt (2
// ulp; the plain version's IEEE sqrt and divide differ from it by ~1e-7
// relative, the tolerance is 1e-4), the softmax expf and a rounded
// reciprocal of the row sum.
//
// What bounds it on an H100: 18 B C D operations (three products of 2 B C
// D, three passes each) at 494.7 TFLOP/s of dense TF32: 7.6 us at B =
// 2048, C = 100, D = 1024, against 18.4 MB of operands and output, 5.5 us
// at 3.35 TB/s. The old yardstick, 6 B C D fp32 FMAs on the CUDA cores at
// 67 TFLOP/s, is 2.5x longer. Every 64-row tile reads the whole class side
// (6 C D floats of split parts) from L2: ~6 TB/s of L2 reads at the
// zero-shot shape, where the main loop runs at ~70% of the TF32 rate. The
// times are in PERF.md (chip_smoke.py, probes/compare_builds.py --smith).
//
// Design: two launches on the caller's stream, from one C entry point.
//
// class_split_kernel (a block of 128 threads a class row): the hi and lo
// TF32 parts of e_t, sigma_t and e_t^2 into cls [6, Cp, Dp] (Cp = C rounded
// up to 8, wgmma's N step; Dp = D rounded up to 4, the TMA's 16-byte row
// rule; the pad is zero), 6 C D floats, 2.5 MB at C = 100, D = 1024, and
// the rows' 1 / sqrt(E_t) and 1 / E_t.
//
// smith_head_kernel<NT>: C is cut into even column tiles of NT <= 128 (a
// multiple of 8: C = 100 is one tile of 104, C = 1000 eight of 128; one
// instantiation for each NT). A cluster of cs CTAs shares one 64-row tile
// of the image side. A CTA is a producer warp and one consumer warpgroup
// (160 threads, one CTA an SM).
//   - the producer's one thread keeps TMA loads in flight into a ring of
//     stages of BK = 16 k values (64-byte rows, the TMA's 64-byte swizzle,
//     which the consumers' reads and wgmma's descriptors both take without
//     bank conflicts): the image side's e_s and sigma_s straight from the
//     caller's row-major [B, D] tensors (rows >= B zero-filled by the TMA),
//     and the six class parts of the column tile, NT rows each (rows past
//     Cp zero-filled). It first brings the class scales of the CTA's tiles
//     by bulk copies.
//   - the consumers read their A fragments (rows g and g + 8 of each warp's
//     16, k t and t + 4) from the stage, derive n_s = e_s^2 + sigma_s,
//     split e_s, n_s and sigma_s into hi and lo, add n_s into the rows'
//     E_s, and issue the register-A form of wgmma.m64nNTk8.f32.tf32.tf32
//     with B (the class parts) from shared memory. The fragments of two k8
//     steps alternate, so the next step's are made while the last step's
//     products run; a stage is handed back once its products have retired.
//   - one column tile (C <= 128): the cluster splits k. After its last
//     stage each CTA writes its partial mean, var and E_s over the drained
//     ring and sends each CTA the rows it owns (rank o: rows o * 64 / cs
//     ..) by bulk copies into that CTA's shared memory; the owner adds the
//     slots in rank order (two calls give equal bits), applies the row
//     scales, e^s, e^{2s} and the probit, and runs the row softmax.
//   - more tiles: the cluster splits the tiles (rank o takes o, o + cs, ...)
//     and each CTA runs all of k, so no partial sums cross CTAs: a tile's
//     logits go from the accumulators into shared memory (columns >= C as
//     -inf, as the TPU masked its lane padding); then each row's max and
//     sum over the CTA's columns go to every CTA of the cluster
//     (st.shared::cluster), and each CTA writes its columns of the softmax
//     from the cluster's maxima and sums, added in rank order.
//   - the width cs (1 to 8) is chosen at the call from the occupancy
//     calculator: the cluster that finishes first by (work a CTA) x (waves
//     of clusters the card holds at once). At B = 2048, C = 100 that is 3
//     (96 CTAs in one wave; clusters of 4 fit 30 at once, two waves for 32
//     row tiles), at C = 1000 it is 8, one tile a CTA.
// Shared memory: the ring (as many stages as fit, 2 to 8), the logits, the
// barriers. C past max_classes (3,072 on an H100: three tiles a CTA in a
// cluster of 8) is refused (cudaErrorInvalidValue); the wrapper raises
// before it launches.
//
// Tried and measured (PERF.md): generic-pointer shared-memory accesses
// and remote stores of the partial sums (twice the epilogue time), one
// split-k path for every C (logits of many tiles in shared memory, a
// combine a tile: 0.29 ms at C = 1000 against 0.16), and the class side
// multicast by the TMA to two row tiles of a cluster (slower main loop).
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"  // mbarriers, TMA loads, fences, the tensor-map encoder

namespace cg = cooperative_groups;
namespace wg = bvt_wgmma;

namespace {

constexpr int BM = 64;         // image rows a cluster: one m64 tile
constexpr int BK = 16;         // k values a stage: 64-byte rows
constexpr int NT_MAX = 128;    // class columns a tile
constexpr int MAX_CS = 8;      // CTAs a cluster (portable)
constexpr int MAX_STAGES = 8;
constexpr int CONSUMERS = 128;              // one warpgroup
constexpr int THREADS = CONSUMERS + 32;     // and the producer warp
constexpr int A_BOX = BM * BK * 4;          // bytes of an image-side box
constexpr int SPLIT_THREADS = 128;          // class_split_kernel's block
constexpr float kPi8 = 0.39269908169872414f;  // pi / 8

__host__ __device__ constexpr int stage_bytes(int nt) { return 2 * A_BOX + 6 * nt * BK * 4; }
// floats a row of the partial sums, = 8 (mod 32): a warp's float2 stores
// and the combine's reads meet few bank conflicts
__host__ __device__ constexpr int part_stride(int nt) { return nt + (40 - nt % 32) % 32; }
// the most rows of the tile a CTA of a cluster of cs owns (rank o owns
// rows o * 64 / cs .. (o + 1) * 64 / cs - 1)
__host__ __device__ constexpr int rows_max(int cs) { return (BM + cs - 1) / cs; }
__host__ __device__ constexpr int row_lo(int o, int cs) { return o * BM / cs; }

// the column tiles of NT a CTA of a cluster of cs takes: all of them when
// it splits k (one tile), else every cs-th
__host__ __device__ constexpr int own_tiles(int tiles, int cs) {
  return tiles == 1 ? 1 : (tiles + cs - 1) / cs;
}

// byte offsets in the dynamic shared memory (after aligning it to 1024).
// Split k (C <= 128, one column tile): the ring, and over it after the
// tile the CTA's partial sums (sent: mean and var [64, NTP], E_s [64]) and
// its rows' slots from every CTA of the cluster (received: mean and var
// [cs, rows_max, NTP], E_s [cs, 64]); the logits [rows_max, C]. Split
// columns: the ring; the logits of the CTA's tiles [64, own tiles x NT
// (+ pad)]; every CTA's row maxima and sums [cs, 64, 2]. Then the class
// scales of the CTA's tiles [2, own tiles x NT]; the barriers.
struct Layout {
  long recv, logits, stats, scales, bars, total;
  int ld;  // floats a row of the logits
};

__host__ __device__ inline Layout layout(int nt, int stages, int cs, int C) {
  const int tiles = (C + nt - 1) / nt, cl = own_tiles(tiles, cs) * nt;
  const long ring = (long)stages * stage_bytes(nt);
  Layout l;
  if (tiles == 1) {
    const long ntp = part_stride(nt), rm = rows_max(cs);
    const long sent = ((2 * BM * ntp + BM) * 4 + 127) / 128 * 128;
    const long recv = ((2 * cs * rm * ntp + cs * BM) * 4 + 127) / 128 * 128;
    l.ld = C;
    l.recv = sent;
    l.logits = ring > sent + recv ? ring : sent + recv;
    l.stats = l.logits + (rm * C * 4 + 15) / 16 * 16;
    l.scales = l.stats;
  } else {
    l.ld = part_stride(cl);
    l.recv = 0;
    l.logits = ring;
    l.stats = l.logits + (long)BM * l.ld * 4;
    l.scales = l.stats + MAX_CS * BM * 2 * 4;
  }
  l.bars = l.scales + 2L * cl * 4;
  l.total = 1024 + l.bars + 8 * (2 * MAX_STAGES + 2);
  return l;
}

struct Params {
  const float* rt;         // [C] 1 / sqrt(E_t)
  const float* it;         // [C] 1 / E_t
  const float* log_scale;  // s, on the device
  float* out;              // [B, C]
  int B, C;
  int n_ks;                // k stages of BK in all (Dp / BK rounded up)
  int tiles, stages;       // column tiles of NT; ring stages
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ what TF32 cannot hold): hi and lo as TF32 bit patterns
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// a K-major operand in the 64-byte swizzle: rows 64 bytes apart, 8-row
// groups 512 bytes apart (layout type 2)
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// d (64 x N, this thread's N / 2 accumulators) (+)= A (64 x 8) . B (8 x N):
// A from four registers a thread (its warp's 16 rows: rows g, g + 8 at k t,
// then at k t + 4), B from a descriptor, both K-major; scale_d 0 overwrites d
#define BVT_ACC4(d, i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define BVT_TF32_HEAD(pred) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" pred ", 0;\nwgmma.mma_async.sync.aligned."
#define BVT_TF32_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t db,
                                           int scale_d) {
  if constexpr (N == 8) {
    asm volatile(BVT_TF32_HEAD("9") "m64n8k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3"
                 "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0)
                 : BVT_TF32_IN);
  } else if constexpr (N == 16) {
    asm volatile(BVT_TF32_HEAD("13") "m64n16k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7"
                 "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4)
                 : BVT_TF32_IN);
  } else if constexpr (N == 24) {
    asm volatile(BVT_TF32_HEAD("17") "m64n24k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
                 "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8)
                 : BVT_TF32_IN);
  } else if constexpr (N == 32) {
    asm volatile(BVT_TF32_HEAD("21") "m64n32k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
                 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12)
                 : BVT_TF32_IN);
  } else if constexpr (N == 40) {
    asm volatile(BVT_TF32_HEAD("25") "m64n40k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19"
                 "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16)
                 : BVT_TF32_IN);
  } else if constexpr (N == 48) {
    asm volatile(BVT_TF32_HEAD("29") "m64n48k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23"
                 "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20)
                 : BVT_TF32_IN);
  } else if constexpr (N == 56) {
    asm volatile(BVT_TF32_HEAD("33") "m64n56k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
                 "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24)
                 : BVT_TF32_IN);
  } else if constexpr (N == 64) {
    asm volatile(BVT_TF32_HEAD("37") "m64n64k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
                 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28)
                 : BVT_TF32_IN);
  } else if constexpr (N == 72) {
    asm volatile(BVT_TF32_HEAD("41") "m64n72k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35"
                 "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28),
                   BVT_ACC4(d, 32)
                 : BVT_TF32_IN);
  } else if constexpr (N == 80) {
    asm volatile(BVT_TF32_HEAD("45") "m64n80k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39"
                 "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28),
                   BVT_ACC4(d, 32), BVT_ACC4(d, 36)
                 : BVT_TF32_IN);
  } else if constexpr (N == 88) {
    asm volatile(BVT_TF32_HEAD("49") "m64n88k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43"
                 "}, {%44, %45, %46, %47}, %48, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28),
                   BVT_ACC4(d, 32), BVT_ACC4(d, 36), BVT_ACC4(d, 40)
                 : BVT_TF32_IN);
  } else if constexpr (N == 96) {
    asm volatile(BVT_TF32_HEAD("53") "m64n96k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
                 "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28),
                   BVT_ACC4(d, 32), BVT_ACC4(d, 36), BVT_ACC4(d, 40), BVT_ACC4(d, 44)
                 : BVT_TF32_IN);
  } else if constexpr (N == 104) {
    asm volatile(BVT_TF32_HEAD("57") "m64n104k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51"
                 "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28),
                   BVT_ACC4(d, 32), BVT_ACC4(d, 36), BVT_ACC4(d, 40), BVT_ACC4(d, 44),
                   BVT_ACC4(d, 48)
                 : BVT_TF32_IN);
  } else if constexpr (N == 112) {
    asm volatile(BVT_TF32_HEAD("61") "m64n112k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55"
                 "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28),
                   BVT_ACC4(d, 32), BVT_ACC4(d, 36), BVT_ACC4(d, 40), BVT_ACC4(d, 44),
                   BVT_ACC4(d, 48), BVT_ACC4(d, 52)
                 : BVT_TF32_IN);
  } else if constexpr (N == 120) {
    asm volatile(BVT_TF32_HEAD("65") "m64n120k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
                 "}, {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28),
                   BVT_ACC4(d, 32), BVT_ACC4(d, 36), BVT_ACC4(d, 40), BVT_ACC4(d, 44),
                   BVT_ACC4(d, 48), BVT_ACC4(d, 52), BVT_ACC4(d, 56)
                 : BVT_TF32_IN);
  } else if constexpr (N == 128) {
    asm volatile(BVT_TF32_HEAD("69") "m64n128k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : BVT_ACC4(d, 0), BVT_ACC4(d, 4), BVT_ACC4(d, 8), BVT_ACC4(d, 12),
                   BVT_ACC4(d, 16), BVT_ACC4(d, 20), BVT_ACC4(d, 24), BVT_ACC4(d, 28),
                   BVT_ACC4(d, 32), BVT_ACC4(d, 36), BVT_ACC4(d, 40), BVT_ACC4(d, 44),
                   BVT_ACC4(d, 48), BVT_ACC4(d, 52), BVT_ACC4(d, 56), BVT_ACC4(d, 60)
                 : BVT_TF32_IN);
  }
}

// the shared-memory address `addr` of this CTA in the CTA `rank` of the
// cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

// `bytes` of this CTA's shared memory at src to the shared memory of a
// cluster peer at dst, completing on the peer's barrier bar (dst and bar
// from peer_addr)
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(wg::smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// element (r, k) of a [64, BK] fp32 box in the 64-byte swizzle: the 16-byte
// chunk k / 4 of row r sits at chunk (k / 4) ^ ((r / 2) % 4)
__device__ __forceinline__ float box_at(const float* box, int r, int k) {
  return box[r * BK + (((k >> 2) ^ ((r >> 1) & 3)) << 2) + (k & 3)];
}

// k8 step s of a stage: this thread's A fragments, f[4 op + v] for op = e
// hi, e lo, n hi, n lo, sigma hi, sigma lo and v = (r0, k), (r0 + 8, k),
// (r0, k + 4), (r0 + 8, k + 4) with k = 8 s + t; n added into the rows' E
__device__ __forceinline__ void fragments(const uint8_t* stage, int s, int r0, int t,
                                          uint32_t* f, float& e0, float& e1) {
  const float* be = reinterpret_cast<const float*>(stage);
  const float* bs = be + BM * BK;
  const int k0 = 8 * s + t;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int r = r0 + 8 * (v & 1), k = k0 + 4 * (v >> 1);
    const float e = box_at(be, r, k), sg = box_at(bs, r, k);
    const float n = __fadd_rn(__fmul_rn(e, e), sg);
    if (v & 1) e1 = __fadd_rn(e1, n);
    else e0 = __fadd_rn(e0, n);
    split(e, f[v], f[4 + v]);
    split(n, f[8 + v], f[12 + v]);
    split(sg, f[16 + v], f[20 + v]);
  }
}

// one k8 step's nine products: mean += e_s . e_t, var += n_s . sigma_t +
// sigma_s . e_t^2, each as hi.hi + hi.lo + lo.hi; b: the stage's class
// parts (e_t, sigma_t, e_t^2, hi then lo, NT rows each) at this step's k
template <int NT>
__device__ __forceinline__ void products(float* mean, float* var, const uint32_t* f,
                                         uint32_t b, int acc) {
  constexpr uint32_t part = NT * BK * 4;
  wgmma_tf32<NT>(mean, f + 0, desc64(b), acc);
  wgmma_tf32<NT>(mean, f + 0, desc64(b + part), 1);
  wgmma_tf32<NT>(mean, f + 4, desc64(b), 1);
  wgmma_tf32<NT>(var, f + 8, desc64(b + 2 * part), acc);
  wgmma_tf32<NT>(var, f + 8, desc64(b + 3 * part), 1);
  wgmma_tf32<NT>(var, f + 12, desc64(b + 2 * part), 1);
  wgmma_tf32<NT>(var, f + 16, desc64(b + 4 * part), 1);
  wgmma_tf32<NT>(var, f + 16, desc64(b + 5 * part), 1);
  wgmma_tf32<NT>(var, f + 20, desc64(b + 4 * part), 1);
}

// class row blockIdx.x: the six TF32 parts (e hi, e lo, sigma hi, sigma lo,
// e^2 hi, e^2 lo) into cls [6, Cp, Dp], zero past C and D, and the row's
// scales 1 / sqrt(E_t), 1 / E_t into scales [2, Cp]
__global__ void __launch_bounds__(SPLIT_THREADS)
class_split_kernel(const float* __restrict__ te, const float* __restrict__ tc,
                   float* __restrict__ cls, float* __restrict__ scales, int C, int D,
                   int Cp, int Dp) {
  __shared__ float warp_sums[SPLIT_THREADS / 32];
  const int r = blockIdx.x;
  const long plane = (long)Cp * Dp;
  float E = 0.f;
  for (int k0 = 4 * threadIdx.x; k0 < Dp; k0 += 4 * SPLIT_THREADS) {
    float x[4], s[4];
    uint32_t o[6][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + i;
      const bool in = r < C && k < D;
      x[i] = in ? te[(long)r * D + k] : 0.f;
      s[i] = in ? tc[(long)r * D + k] : 0.f;
      const float x2 = __fmul_rn(x[i], x[i]);
      E = __fadd_rn(E, __fadd_rn(x2, s[i]));
      split(x[i], o[0][i], o[1][i]);
      split(s[i], o[2][i], o[3][i]);
      split(x2, o[4][i], o[5][i]);
    }
#pragma unroll
    for (int p = 0; p < 6; ++p)
      *reinterpret_cast<uint4*>(cls + p * plane + (long)r * Dp + k0) =
          make_uint4(o[p][0], o[p][1], o[p][2], o[p][3]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) E += __shfl_xor_sync(0xffffffffu, E, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = E;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int w = 0; w < SPLIT_THREADS / 32; ++w) sum = __fadd_rn(sum, warp_sums[w]);
    scales[r] = __frcp_rn(__fsqrt_rn(sum));
    scales[Cp + r] = __frcp_rn(sum);
  }
}

// -- the epilogues -------------------------------------------------------------

// split k: every CTA's partial sums (mean, var, E_s over its k stages) go
// by bulk copies into the CTA that owns their rows (rank o owns rows
// row_lo(o) ..), which adds the slots in rank order and writes its rows'
// probit logits [rows, C]. The partial sums sit over the drained ring.
template <int NT>
__device__ __forceinline__ void combine_k(uint8_t* smem, const Layout& l,
                                          cg::cluster_group& cluster, int cs, int rank,
                                          int r0, int t, const float* mean,
                                          const float* var, float e0, float e1, float scale,
                                          const float* cscale, int C, uint64_t* arrived,
                                          uint64_t* scaled) {
  constexpr int NTP = part_stride(NT);
  const int rm = rows_max(cs), lo = row_lo(rank, cs), my_rows = row_lo(rank + 1, cs) - lo;
  float* sent = reinterpret_cast<float*>(smem);
  float* recv = reinterpret_cast<float*>(smem + l.recv);
  float* logits = reinterpret_cast<float*>(smem + l.logits);
  cluster.sync();  // every CTA of the cluster has drained its ring
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = sent + (r0 + 8 * h) * NTP + 2 * t;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(mean[4 * j + 2 * h], mean[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(dst + BM * NTP + 8 * j) =
          make_float2(var[4 * j + 2 * h], var[4 * j + 2 * h + 1]);
    }
  }
  if (t == 0) {
    sent[2 * BM * NTP + r0] = e0;
    sent[2 * BM * NTP + r0 + 8] = e1;
  }
  wg::fence_proxy_async();  // the copies read `sent` through the async proxy
  wg::named_sync(1, CONSUMERS);
  if (threadIdx.x < cs) {
    const int o = threadIdx.x, olo = row_lo(o, cs);
    const uint32_t rows = (row_lo(o + 1, cs) - olo) * NTP * 4;
    const uint32_t bar = peer_addr(wg::smem_u32(arrived), o);
    const uint32_t at = peer_addr(wg::smem_u32(recv), o) + rank * rm * NTP * 4;
    bulk_to_peer(at, sent + olo * NTP, rows, bar);
    bulk_to_peer(at + cs * rm * NTP * 4, sent + BM * NTP + olo * NTP, rows, bar);
    bulk_to_peer(peer_addr(wg::smem_u32(recv + 2 * cs * rm * NTP + rank * BM), o),
                 sent + 2 * BM * NTP, BM * 4, bar);
  }
  wg::mbar_wait(scaled, 0);
  wg::mbar_wait(arrived, 0);  // every CTA's sums of this CTA's rows

  // the slots added in rank order, the row scales (e^s and pi/8 e^{2s}
  // folded into them), the probit; tpr threads a row (a power of two:
  // neighbouring lanes), a thread's columns u, u + tpr, ... eight at a
  // time, their loads and arithmetic independent
  int tpr = 2;
  while (2 * tpr * rm <= CONSUMERS) tpr *= 2;
  const int lr = threadIdx.x / tpr, u = threadIdx.x % tpr;
  if (lr < my_rows) {
    const float* rmn = recv + lr * NTP;
    const float* rvr = recv + cs * rm * NTP + lr * NTP;
    float Es = 0.f;
    for (int q = 0; q < cs; ++q) Es = __fadd_rn(Es, recv[2 * cs * rm * NTP + q * BM + lo + lr]);
    const float a_row = __fmul_rn(__frcp_rn(__fsqrt_rn(Es)), scale);
    const float b_row = __fmul_rn(__fmul_rn(__frcp_rn(Es), __fmul_rn(scale, scale)), kPi8);
    const int ncol = (min(NT, C) - u + tpr - 1) / tpr;
    for (int k0 = 0; k0 < ncol; k0 += 8) {
      float m[8], v[8];
      int c[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        c[k] = k0 + k < ncol ? u + tpr * (k0 + k) : 0;
        m[k] = v[k] = 0.f;
      }
      for (int q = 0; q < cs; ++q)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          m[k] = __fadd_rn(m[k], rmn[q * rm * NTP + c[k]]);
          v[k] = __fadd_rn(v[k], rvr[q * rm * NTP + c[k]]);
        }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k0 + k < ncol) {
          const float mu = __fmul_rn(__fmul_rn(m[k], a_row), cscale[c[k]]);
          const float va = __fmul_rn(__fmul_rn(v[k], b_row), cscale[NT + c[k]]);
          logits[lr * C + c[k]] = __fmul_rn(mu, rsqrtf(__fadd_rn(va, 1.0f)));
        }
    }
  }
  wg::fence_proxy_async();  // the ring's memory is the TMA's again
  cluster.sync();           // every CTA has read its slots
}

// split k: the row softmax of this CTA's rows over the C columns
__device__ __forceinline__ void softmax_rows(float* logits, int rank, int cs, const Params& p,
                                             int row0) {
  const int rm = rows_max(cs), lo = row_lo(rank, cs), my_rows = row_lo(rank + 1, cs) - lo;
  int tpr = 2;
  while (2 * tpr * rm <= CONSUMERS) tpr *= 2;
  const int lr = threadIdx.x / tpr, u = threadIdx.x % tpr;
  const bool mine = lr < my_rows;
  float* lrow = logits + lr * p.C;
  const int ncol = mine ? (p.C - u + tpr - 1) / tpr : 0;
  float mx = -CUDART_INF_F;
  for (int k0 = 0; k0 < ncol; k0 += 4)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k0 + k < ncol) mx = fmaxf(mx, lrow[u + tpr * (k0 + k)]);
  for (int off = tpr / 2; off > 0; off /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
  for (int k0 = 0; k0 < ncol; k0 += 4) {
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      e[k] = k0 + k < ncol ? expf(lrow[u + tpr * (k0 + k)] - mx) : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k0 + k < ncol) {
        lrow[u + tpr * (k0 + k)] = e[k];
        sum += e[k];
      }
  }
  for (int off = tpr / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float inv = __frcp_rn(sum);
  const int grow = row0 + lo + lr;
  if (mine && grow < p.B) {
    float* dst = p.out + (long)grow * p.C;
    for (int c = u; c < p.C; c += tpr) dst[c] = __fmul_rn(lrow[c], inv);
  }
}

// split columns: tile ct's probit logits straight from the accumulators
// (this thread's rows r0, r0 + 8 and columns 8 j + 2 t, + 1), the row
// scales from this CTA's E_s over all k; columns >= C become -inf
template <int NT>
__device__ __forceinline__ void logits_of_tile(float* logits, int ld, const float* cscale,
                                               int cl, int lt, int ct, int r0, int t,
                                               const float* mean, const float* var, float e0,
                                               float e1, float scale, int C,
                                               uint64_t* scaled, bool first) {
  if (first) wg::mbar_wait(scaled, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float E = h ? e1 : e0;
    const float a_row = __fmul_rn(__frcp_rn(__fsqrt_rn(E)), scale);
    const float b_row = __fmul_rn(__fmul_rn(__frcp_rn(E), __fmul_rn(scale, scale)), kPi8);
    float* dst = logits + (r0 + 8 * h) * ld + lt * NT;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float x[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = 8 * j + 2 * t + k, i = 4 * j + 2 * h + k;
        const float mu = __fmul_rn(__fmul_rn(mean[i], a_row), cscale[lt * NT + c]);
        const float va = __fmul_rn(__fmul_rn(var[i], b_row), cscale[cl + lt * NT + c]);
        x[k] = ct * NT + c < C ? __fmul_rn(mu, rsqrtf(__fadd_rn(va, 1.0f)))
                               : -CUDART_INF_F;
      }
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) = make_float2(x[0], x[1]);
    }
  }
}

// split columns: each row's max and sum over this CTA's columns, pushed to
// every CTA of the cluster; then the rows' softmax from the cluster's
// [cs, 64, 2] maxima and sums. A row is 8 neighbouring lanes (a warp takes
// 4 rows at a time), lane u of the 8 its columns u, u + 8, ..., and in the
// second pass the cluster's rank u; the sums over the 8 lanes go in a fixed
// order (xor 4, 2, 1)
template <int NT>
__device__ __forceinline__ void softmax_columns(float* logits, int ld, uint8_t* stats_at,
                                                cg::cluster_group& cluster, int cs, int rank,
                                                int ct0, int dct, const Params& p, int row0) {
  float* stats = reinterpret_cast<float*>(stats_at);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, u = lane % 8;
  const int mine = (p.tiles - ct0 + dct - 1) / dct * NT;  // <= cl: the last ranks may own one fewer
  wg::named_sync(1, CONSUMERS);  // every warp's logits are in
  for (int r = 4 * warp + lane / 8; r < BM; r += CONSUMERS / 8) {
    float* lrow = logits + r * ld;
    float mx = -CUDART_INF_F;
    for (int c = u; c < mine; c += 8) mx = fmaxf(mx, lrow[c]);
#pragma unroll
    for (int off = 4; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = u; c < mine; c += 8) {
      const float e = expf(lrow[c] - mx);
      lrow[c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 4; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (u < cs) st_peer(peer_addr(wg::smem_u32(stats + (rank * BM + r) * 2), u), mx, sum);
  }
  cluster.sync();  // every CTA's maxima and sums are in
  for (int r = 4 * warp + lane / 8; r < BM; r += CONSUMERS / 8) {
    const bool in = u < cs;
    const float m = in ? stats[(u * BM + r) * 2] : -CUDART_INF_F;
    float M = m;
#pragma unroll
    for (int off = 4; off > 0; off /= 2) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float S = in ? __fmul_rn(stats[(u * BM + r) * 2 + 1], expf(m - M)) : 0.f;
#pragma unroll
    for (int off = 4; off > 0; off /= 2) S += __shfl_xor_sync(0xffffffffu, S, off);
    const float f = __fmul_rn(expf(__shfl_sync(0xffffffffu, m, (lane & ~7) + rank) - M),
                              __frcp_rn(S));
    if (row0 + r >= p.B) continue;
    const float* lrow = logits + r * ld;
    float* dst = p.out + (long)(row0 + r) * p.C;
    for (int ct = ct0, lt = 0; ct < p.tiles; ct += dct, ++lt)
      for (int c = u; c < NT; c += 8)
        if (ct * NT + c < p.C) dst[ct * NT + c] = __fmul_rn(lrow[lt * NT + c], f);
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
smith_head_kernel(const __grid_constant__ CUtensorMap map_se,   // [B, lds] e_s
                  const __grid_constant__ CUtensorMap map_sc,   // [B, lds] sigma_s
                  const __grid_constant__ CUtensorMap map_cls,  // [6, Cp, Dp] class parts
                  const Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // aligned to 1024 by an offset from the shared array, so that the
  // compiler keeps shared-memory (32-bit) addressing for every access
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.y * BM;
  const bool split_k = p.tiles == 1;  // else the cluster splits the column tiles
  const Layout l = layout(NT, p.stages, cs, p.C);
  const int cl = own_tiles(p.tiles, cs) * NT;  // columns of the CTA's tiles
  float* logits = reinterpret_cast<float*>(smem + l.logits);
  float* cscale = reinterpret_cast<float*>(smem + l.scales);  // [2, cl]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bars);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* arrived = empty + MAX_STAGES;  // split k: the received slots' bytes
  uint64_t* scaled = arrived + 1;          // the CTA's class scales
  // this CTA's k stages [ks0, ks0 + n_st) (none when cs > n_ks) and column
  // tiles ct0, ct0 + dct, ...
  const int ks0 = split_k ? rank * p.n_ks / cs : 0;
  const int n_st = split_k ? (rank + 1) * p.n_ks / cs - ks0 : p.n_ks;
  const int ct0 = split_k ? 0 : rank, dct = split_k ? 1 : cs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      wg::mbar_init(&full[s], 1);  // the producer's expect_tx, then the bytes
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    wg::mbar_init(arrived, 1);
    wg::mbar_init(scaled, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // -- producer: one thread brings the class scales of the CTA's tiles and
    // keeps the ring full; the warp takes part in the cluster's barriers
    if (lane == 0) {
      wg::prefetch_map(&map_se);
      wg::prefetch_map(&map_sc);
      wg::prefetch_map(&map_cls);
      uint32_t bytes = 0;
      for (int ct = ct0; ct < p.tiles; ct += dct)
        bytes += 2 * ((min(NT, p.C - ct * NT) + 3) / 4 * 16);
      wg::mbar_expect_tx(scaled, bytes);
      for (int ct = ct0, lt = 0; ct < p.tiles; ct += dct, ++lt) {
        const uint32_t w = (min(NT, p.C - ct * NT) + 3) / 4 * 16;  // bytes, <= Cp
        wg::bulk_load(cscale + lt * NT, p.rt + ct * NT, w, scaled);
        wg::bulk_load(cscale + cl + lt * NT, p.it + ct * NT, w, scaled);
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int ct = ct0; ct < p.tiles; ct += dct)
        for (int j = 0; j < n_st; ++j) {
          wg::mbar_wait(&empty[slot], phase ^ 1);  // the first round passes
          uint8_t* st = smem + (long)slot * stage_bytes(NT);
          wg::mbar_expect_tx(&full[slot], stage_bytes(NT));
          const int k = (ks0 + j) * BK;
          wg::tma_load_2d(st, &map_se, &full[slot], k, row0);
          wg::tma_load_2d(st + A_BOX, &map_sc, &full[slot], k, row0);
#pragma unroll
          for (int q = 0; q < 6; ++q)
            wg::tma_load_3d(st + 2 * A_BOX + q * NT * BK * 4, &map_cls, &full[slot], k,
                            ct * NT, q);
          if (++slot == p.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
    }
    __syncwarp();
    cluster.sync();                // split k: every CTA has drained its ring
    if (split_k) cluster.sync();   // every CTA has read its slots
    return;
  }

  // -- consumers ---------------------------------------------------------------
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;  // this thread's rows r0 and r0 + 8 of the tile
  const float scale = expf(*p.log_scale);
  // zero: a CTA with no k stages (cs > k stages) sends these
  float mean[NT / 2], var[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) mean[i] = var[i] = 0.f;
  uint32_t f0[24], f1[24];
  int slot = 0, prev = 0;
  uint32_t phase = 0;
  if (split_k && threadIdx.x == 0)
    wg::mbar_expect_tx(arrived, cs * (2 * (row_lo(rank + 1, cs) - row_lo(rank, cs)) *
                                          part_stride(NT) + BM) * 4);

  for (int ct = ct0, lt = 0; ct < p.tiles; ct += dct, ++lt) {
    float e0 = 0.f, e1 = 0.f;
    for (int j = 0; j < n_st; ++j) {
      wg::mbar_wait(&full[slot], phase);
      const uint8_t* st = smem + (long)slot * stage_bytes(NT);
      const uint32_t b = wg::smem_u32(st + 2 * A_BOX);
      fragments(st, 0, r0, t, f0, e0, e1);
      wg::wgmma_fence();
      products<NT>(mean, var, f0, b, j > 0);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();  // the last stage's second step has retired
      if (j > 0) wg::mbar_arrive(&empty[prev]);
      fragments(st, 1, r0, t, f1, e0, e1);
      wg::wgmma_fence();
      products<NT>(mean, var, f1, b + 32, 1);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      prev = slot;
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_regs<NT / 2>(mean);
    wg::fence_regs<NT / 2>(var);
    if (n_st > 0) wg::mbar_arrive(&empty[prev]);
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {  // the rows' E over the quad's k
      e0 += __shfl_xor_sync(0xffffffffu, e0, off);
      e1 += __shfl_xor_sync(0xffffffffu, e1, off);
    }
    if (split_k)
      combine_k<NT>(smem, l, cluster, cs, rank, r0, t, mean, var, e0, e1, scale, cscale, p.C,
                    arrived, scaled);
    else
      logits_of_tile<NT>(logits, l.ld, cscale, cl, lt, ct, r0, t, mean, var, e0, e1, scale,
                         p.C, scaled, lt == 0);
  }
  if (split_k)
    softmax_rows(logits, rank, cs, p, row0);
  else
    softmax_columns<NT>(logits, l.ld, smem + l.stats, cluster, cs, rank, ct0, dct, p, row0);
}

// -- host ----------------------------------------------------------------------

struct Plan {
  int nt, tiles, cs, stages, n_ks;
  long smem;
};

// the most dynamic shared memory a block of the current device may opt in to
int smem_limit(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// the most classes a launch takes: split columns over a cluster of 8 with
// tiles of 128 and a ring of two stages, as many tiles a CTA as its logits
// then leave room for
int max_classes_for(int smem_optin) {
  int own = 0;
  while (layout(NT_MAX, 2, MAX_CS, (own + 1) * MAX_CS * NT_MAX).total <= smem_optin) ++own;
  return own > 0 ? own * MAX_CS * NT_MAX : NT_MAX;
}

const void* kernel_for(int nt);

// a launch of cs-wide clusters over `row_tiles` 64-row tiles
cudaLaunchConfig_t launch_config(int cs, long smem, int row_tiles, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, row_tiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of cs CTAs with `smem` bytes each the card holds at once (the
// occupancy calculator; its answers kept), or 0
int active_clusters(int nt, int cs, long smem) {
  struct Entry {
    int nt, cs;
    long smem;
    int n;
  };
  static Entry seen[64];
  static int filled = 0;
  for (int i = 0; i < filled; ++i)
    if (seen[i].nt == nt && seen[i].cs == cs && seen[i].smem == smem) return seen[i].n;
  const void* kernel = kernel_for(nt);
  int n = 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(cs, smem, 1, nullptr, attr);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (filled < 64) seen[filled++] = {nt, cs, smem, n};
  return n;
}

// the column tile, the cluster and the ring of a call: C split into even
// tiles of NT <= 128 (a multiple of 8). One tile: the cluster's cs CTAs
// (1 to 8) split k; more: they split the tiles (cs <= tiles). The cs that
// finishes first by the count (k stages a CTA, a tenth more at three
// stages and two fifths at two, and the epilogue, about four) x (waves
// of clusters the card holds at once); its logits beside a ring of as many
// stages as fit
int make_plan(int B, int C, int D, Plan* pl) {
  int optin = 0;
  const int err = smem_limit(&optin);
  if (err != cudaSuccess) return err;
  if (C < 1 || D < 1 || B < 0 || C > max_classes_for(optin)) return cudaErrorInvalidValue;
  const int t0 = (C + NT_MAX - 1) / NT_MAX;
  pl->nt = ((C + t0 - 1) / t0 + 7) / 8 * 8;
  pl->tiles = (C + pl->nt - 1) / pl->nt;
  pl->n_ks = ((D + 3) / 4 * 4 + BK - 1) / BK;
  const long row_tiles = (B + BM - 1) / BM > 0 ? (B + BM - 1) / BM : 1;
  long best = -1;
  for (int cs = 1; cs <= MAX_CS; ++cs) {
    if (pl->tiles > 1 && cs > pl->tiles) break;
    int stages = MAX_STAGES;
    while (stages >= 2 && layout(pl->nt, stages, cs, C).total > optin) --stages;
    if (stages < 2) continue;
    const long smem = layout(pl->nt, stages, cs, C).total;
    const int n = active_clusters(pl->nt, cs, smem);
    if (n <= 0) continue;
    const long k_stages = pl->tiles == 1 ? (pl->n_ks + cs - 1) / cs
                                         : (long)own_tiles(pl->tiles, cs) * pl->n_ks;
    const long per_cta = k_stages * (stages == 2 ? 14 : stages == 3 ? 11 : 10) + 40;
    const long waves = (row_tiles + n - 1) / n;
    const long cost = 2 * per_cta * waves + (cs > pl->n_ks);  // idle CTAs last
    if (best < 0 || cost < best) {
      best = cost;
      pl->cs = cs;
      pl->stages = stages;
      pl->smem = smem;
    }
  }
  return best < 0 ? cudaErrorInvalidValue : 0;
}

#define BVT_NT_CASE(n) \
  case n:              \
    return reinterpret_cast<const void*>(smith_head_kernel<n>);

const void* kernel_for(int nt) {
  switch (nt) {
    BVT_NT_CASE(8) BVT_NT_CASE(16) BVT_NT_CASE(24) BVT_NT_CASE(32)
    BVT_NT_CASE(40) BVT_NT_CASE(48) BVT_NT_CASE(56) BVT_NT_CASE(64)
    BVT_NT_CASE(72) BVT_NT_CASE(80) BVT_NT_CASE(88) BVT_NT_CASE(96)
    BVT_NT_CASE(104) BVT_NT_CASE(112) BVT_NT_CASE(120) BVT_NT_CASE(128)
    default:
      return nullptr;
  }
}

// an fp32 tensor of 2 or 3 dimensions (innermost first) in the 64-byte
// swizzle, zero fill past its edges
int encode_f32(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box) {
  const wg::EncodeTiled fn = wg::encoder();
  if (fn == nullptr) return wg::kErrNoEncoder;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : wg::kErrEncode;
}

}  // namespace

extern "C" {

// the most classes a call takes on the current device, or a negative
// cudaError_t
int bvt_smith_head_max_classes(void) {
  int optin = 0;
  const int err = smem_limit(&optin);
  return err != cudaSuccess ? -err : max_classes_for(optin);
}

// a call's plan and its kernel's resources into out[0..8]: NT, column
// tiles, cluster width, ring stages, dynamic shared memory, registers a
// thread, local memory a thread (spills), clusters the card holds at once,
// k stages. Returns 0 or a cudaError_t.
int bvt_smith_head_resources(int B, int C, int D, int* out) {
  Plan pl;
  int err = make_plan(B, C, D, &pl);
  if (err != 0) return err;
  const void* kernel = kernel_for(pl.nt);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int clusters = 0;
  if (err == cudaSuccess) {
    cudaLaunchAttribute la[1];
    const cudaLaunchConfig_t cfg = launch_config(pl.cs, pl.smem, 1, nullptr, la);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  const int vals[9] = {pl.nt, pl.tiles, pl.cs, pl.stages, static_cast<int>(pl.smem),
                       attr.numRegs, static_cast<int>(attr.localSizeBytes), clusters, pl.n_ks};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// se, sc [B, lds] fp32 row-major (image embeddings and diagonal
// covariances, D values a row and zeros past them; lds a multiple of 4,
// both 16-byte aligned: the TMA's rules), te, tc [C, D] fp32 row-major (the
// class ones); log_scale: the fp32 logit scale s on the device; cls [6,
// Cp, Dp] and scales [2, Cp] fp32 scratch (Cp = C rounded up to 8, Dp = D
// rounded up to 4; cls 16-byte aligned); out [B, C] fp32. Two launches on
// `stream`. Returns a cudaError_t (0 = launched) or an encoder code of
// csrc/wgmma_gemm.cuh.
int bvt_smith_head(const float* se, const float* sc, int lds, const float* te,
                   const float* tc, const float* log_scale, float* cls, float* scales,
                   float* out, int B, int C, int D, void* stream) {
  if (B < 0 || lds < D || lds % 4 || reinterpret_cast<uintptr_t>(se) % 16 ||
      reinterpret_cast<uintptr_t>(sc) % 16 || reinterpret_cast<uintptr_t>(cls) % 16)
    return cudaErrorInvalidValue;
  Plan pl;
  int err = make_plan(B, C, D, &pl);
  if (err != 0) return err;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Cp = (C + 7) / 8 * 8, Dp = (D + 3) / 4 * 4;
  class_split_kernel<<<Cp, SPLIT_THREADS, 0, st>>>(te, tc, cls, scales, C, D, Cp, Dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap maps[3];
  const cuuint64_t img_dims[2] = {static_cast<cuuint64_t>(lds), static_cast<cuuint64_t>(B)};
  const cuuint64_t img_strides[1] = {static_cast<cuuint64_t>(lds) * 4};
  const cuuint32_t img_box[2] = {BK, BM};
  const cuuint64_t cls_dims[3] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(Cp), 6};
  const cuuint64_t cls_strides[2] = {static_cast<cuuint64_t>(Dp) * 4,
                                     static_cast<cuuint64_t>(Cp) * Dp * 4};
  const cuuint32_t cls_box[3] = {BK, static_cast<cuuint32_t>(pl.nt), 1};
  if ((err = encode_f32(&maps[0], se, 2, img_dims, img_strides, img_box)) != 0 ||
      (err = encode_f32(&maps[1], sc, 2, img_dims, img_strides, img_box)) != 0 ||
      (err = encode_f32(&maps[2], cls, 3, cls_dims, cls_strides, cls_box)) != 0)
    return err;

  const Params prm{scales, scales + Cp, log_scale, out, B, C, pl.n_ks, pl.tiles, pl.stages};
  const void* kernel = kernel_for(pl.nt);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute la[1];
  const cudaLaunchConfig_t cfg = launch_config(pl.cs, pl.smem, (B + BM - 1) / BM, st, la);
  void* args[4] = {&maps[0], &maps[1], &maps[2], const_cast<Params*>(&prm)};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* bvt_error_string(int err) { return wg::error_string(err); }

}  // extern "C"
