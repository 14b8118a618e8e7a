// A warp-specialised, persistent Hopper GEMM: wgmma fed by TMA through
// an mbarrier ring.
//
//   C[M, N] = epilogue(A[M, K] . B)
//   kWgBF16:  bf16 x bf16 -> fp32, B row-major [K, N] (read MN-major)
//   kWgS8:    s8 x s8 -> s32, B given as B^T [N, K] (wgmma reads 8-bit
//             operands K-major only; the caller lays B out, or has it so:
//             an nn.Linear weight [N, K] is B^T)
//   kWgBF16T: bf16 x bf16 -> fp32, B given as B^T [N, K] and read K-major
//             as A is (imm-trans-b 0): an nn.Linear weight in place; BN 128
//
// The epilogue is a compile-time policy (EPI):
//   EpiRaw (the default): the raw accumulators, fp32 / s32 (the GEMM-tile
//     probes, csrc/tile_gemm.cu);
//   EpiDequant<Out, RESIDUAL> (s8): the W8A8 dequantisation of
//     csrc/int8_gemm.cuh, y = ((float(h) * xs[row]) * ws[col]) + bias[col],
//     then with RESIDUAL a residual add, in fp32 and in that order
//     (explicit __fmul_rn / __fadd_rn), stored as Out (fp32 or bf16),
//     optionally as N / chunk contiguous [M, chunk] blocks (a fused QKV's
//     q, k, v). Each variant is its own instantiation: a branch per value
//     costs registers the accumulators need. (An activation here, with
//     each row's max |y| taken by atomics for the next quantize, was
//     measured and left out: the accurate tanhf on a consumer's 4 warps
//     outlasts the other consumer's mainloop; csrc/mlp_int8.cu.)
//   EpiBias<RESIDUAL> (kWgBF16T): the attention sublayer's projections
//     (csrc/attention_block.cu), y = round(acc + float(bias[col])), then
//     with RESIDUAL y = round(float(residual) + float(y)), in fp32 with
//     explicit __fadd_rn, stored as bf16. Its B is up to three weights read
//     in place (`parts`, one tensor map each), the output `parts` contiguous
//     [M, N] blocks (q, k, v): a tile column belongs to one part, so no tile
//     straddles two weights or two outputs, and every box goes out by the
//     TMA, clipped at N, whatever N is.
//
// Design (one block of 384 threads an SM, walking output tiles):
//   - warpgroup 0 is the producer: setmaxnreg drops it to 40 registers
//     and one thread keeps TMA loads of A and B in flight into a ring of
//     STAGES stages (full / empty mbarriers; the TMA's byte count
//     completes a full barrier). Every stage row is 128 bytes of K (64
//     bf16, 128 s8), written by the TMA in its 128-byte swizzle, the
//     layout wgmma reads without bank conflicts.
//   - warpgroups 1 and 2 are the consumers (setmaxnreg raises them to
//     232). Each issues 4 wgmma k-steps a stage (k16 bf16, k32 s8, from
//     descriptors that step 32 bytes along the swizzled rows) of its m64
//     x BN products, and waits for the group one stage behind before it
//     frees that stage, so the next stage's products are issued before
//     the last ones retire. Two schedules:
//       kCoop: both consumers share each BM x BN tile, BM / 2 rows each;
//       kPingPong: each owns whole BM x BN tiles, the block's tiles in
//         turn, so one consumer's epilogue runs while the other's
//         products do. A pair of order barriers hands the mainloop from
//         one consumer to the other once it has issued a tile's last
//         products: besides keeping the two mainloops apart, this keeps
//         each consumer's wait on a full barrier at most one phase ahead
//         of it (a parity wait cannot tell phase r from r + 2).
//   - the epilogue: each consumer writes its outputs into two 8 KB
//     shared-memory boxes (64 rows of 128 bytes, 128-byte swizzle: 32
//     fp32 / s32 or 64 bf16 columns, so a box row is one swizzle span) in
//     turn, and one thread stores each box with a TMA store; the stores
//     drain while the next products run, and the producer's loads for
//     the next tile are already in flight. EpiDequant stages its tile's
//     row scales, column scales and biases in shared memory (each
//     consumer thread loads one of each before the tile's mainloop and
//     stores them after it), so the epilogue holds no more than the
//     accumulators in registers and waits on no device-memory load but the
//     residual's; and where a box could straddle a chunk of the output (a
//     chunk that is no multiple of the box's columns, chosen at launch)
//     the consumer copies the box out by plain stores instead of the TMA.
//     EpiBias stages its tile's biases the same way; with RESIDUAL the
//     consumer prefetches its tile's residual rows into L2 before the
//     mainloop and loads each box's residual pairs before it uses the
//     first (measured: the out-projection 0.096 -> 0.078 ms, PERF.md).
//   - tiles are walked in groups of kGroupM tile rows along M, column by
//     column inside a group, so the blocks at work share A and B in L2.
//   - edges: the TMA zero-fills loads past M, N and K (so K need not be
//     a multiple of a stage) and clips stores past M and N.
// Every operand's base must be 16-byte aligned and its rows a multiple of
// 16 bytes apart (the TMA's rule); the caller checks.
//
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (no -lcuda), and passed as
// __grid_constant__ parameters. A wait on an mbarrier that lasts more
// than ~2^34 cycles traps, so a fault in the ring ends the kernel with an
// error and not a hang.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"  // the dequantising epilogue's loads and stores

namespace bvt_wgmma {

enum WgKind { kWgBF16 = 0, kWgS8 = 1, kWgBF16T = 2 };
enum WgSchedule { kCoop = 0, kPingPong = 1 };

constexpr int kThreads = 384;      // producer warpgroup + 2 consumers
constexpr int kRowBytes = 128;     // bytes of K a stage row (the swizzle span)
constexpr int kEpiCols = 32;       // output columns of an epilogue box
constexpr int kEpiBox = 64 * kEpiCols * 4;  // 64 rows of 128 bytes
constexpr int kGroupM = 8;         // tile rows a raster group
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr long long kWatchdogCycles = 1LL << 34;

// -- epilogue policies (see the top of the file) -------------------------------

struct EpiRaw {
  static constexpr bool kRaw = true;
  static constexpr bool kBias = false;
  struct Params {};
  // fp32 values staged in shared memory a consumer
  __host__ __device__ static constexpr int staging(int, int) { return 0; }
};

template <typename OutT, bool RESIDUAL>
struct EpiDequant {
  static constexpr bool kRaw = false;
  static constexpr bool kBias = false;
  static constexpr bool kResidual = RESIDUAL;
  using Out = OutT;
  static constexpr CUtensorMapDataType out_type =
      sizeof(OutT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  struct Params {
    const float* xs;       // [M] row scales
    const float* ws;       // [N] column scales
    const float* bias;     // [N]
    const OutT* residual;  // kResidual: [M, N], added last in fp32
    OutT* out;             // N / chunk contiguous [M, chunk] blocks
    int chunk;
    int direct;            // boxes copied out by plain stores, not by the TMA
  };
  // a consumer's rows' scales, then its tile's column scales and biases
  __host__ __device__ static constexpr int staging(int rows, int bn) { return rows + 2 * bn; }
};

template <bool RESIDUAL>
struct EpiBias {
  static constexpr bool kRaw = false;
  static constexpr bool kBias = true;
  static constexpr bool kResidual = RESIDUAL;
  static constexpr int kMaxParts = 3;
  using Out = __nv_bfloat16;
  struct Params {
    CUtensorMap b[kMaxParts];             // part p's weight, B^T [N, K] (box 64 x BN)
    const __nv_bfloat16* bias[kMaxParts];  // part p's [N]
    const __nv_bfloat16* residual;        // kResidual: [M, N] (one part)
    int parts;                            // 1 .. kMaxParts
  };
  // the tile's biases
  __host__ __device__ static constexpr int staging(int, int bn) { return bn; }
};

template <int KIND> struct WgTraits;
template <> struct WgTraits<kWgBF16> {
  using Acc = float;
  static constexpr int elem = 2;
  static constexpr CUtensorMapDataType in_type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType out_type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct WgTraits<kWgBF16T> : WgTraits<kWgBF16> {};
template <> struct WgTraits<kWgS8> {
  using Acc = int;
  static constexpr int elem = 1;
  static constexpr CUtensorMapDataType in_type = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType out_type = CU_TENSOR_MAP_DATA_TYPE_INT32;
};

template <int KIND, int BM, int BN, int STAGES, int SCHED>
struct WgLayout {
  // m64 products a consumer a k-step: half the tile's rows, or all of them
  static constexpr int MW = SCHED == kCoop ? BM / 128 : BM / 64;
  static_assert(BM % (SCHED == kCoop ? 128 : 64) == 0, "whole m64 products a consumer");
  static_assert(BN == 128 || BN == 256, "wgmma n128 or n256");
  static_assert(MW * BN <= 256, "at most 128 accumulators a consumer thread");
  static constexpr int kBK = kRowBytes / WgTraits<KIND>::elem;  // K a stage
  static constexpr int kA = BM * kRowBytes, kB = BN * kRowBytes;
  static constexpr int kStage = kA + kB;  // the bytes a full barrier waits for
  static constexpr int kEpi = 2 * 2 * kEpiBox;  // two boxes a consumer
  // 1024: slack to align the ring to the swizzle's 1024-byte period; the
  // barriers: full and empty a stage, and two order barriers
  static constexpr int kSmem = 1024 + STAGES * kStage + kEpi + (2 * STAGES + 2) * 8;
  // the epilogue's staging after the barriers, fp32 (EPI::staging): a
  // consumer's rows and its tile's columns
  static constexpr int kRowsC = MW * 64;
  template <class EPI>
  __host__ __device__ static constexpr int staged() {
    return EPI::staging(kRowsC, BN);
  }
  template <class EPI>
  static constexpr int smem() {
    return kSmem + 2 * staged<EPI>() * 4;
  }
};

// -- PTX -----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - start > kWatchdogCycles) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a box of a rank-1 tensor map (no swizzle) at element c0
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// a box of a rank-3 tensor map at (c0, c1, c2), innermost first
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes of device memory at src into shared memory at
// dst (no tensor map): both 16-byte aligned, bytes a multiple of 16; the
// copy completes on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes of shared memory at src to device memory at dst,
// in this thread's bulk group: both 16-byte aligned, bytes a multiple of 16
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk stores still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128-byte line at p into L2 (generic address)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the accumulators' reads and writes on their side of a wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// a shared-memory matrix descriptor in the 128-byte swizzle: start, leading
// and stride byte offsets in 16-byte units, layout 1 (128B) in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d (64 x N, this thread's N / 2 accumulators) (+)= A (64 x k) . B (k x N)
// from descriptors; scale_d 0 overwrites d. bf16: A K-major, B MN-major
// (imm-trans-b 1; TRANS_B 0 reads B K-major); s8: both K-major.
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_bf16_n256(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The register-A forms: d (64 x N) (+)= A (64 x k) . B (k x N), A from four
// registers a thread (its warp's 16 rows, laid out as mma.sync's m16n8k16
// bf16 / m16n8k32 s8 A fragment: rows g and g + 8, bytes 4 t and 16 + 4 t
// of the k-step's 32), B from a descriptor, K-major (bf16 also MN-major).
#define BVT_WG_ACC8(c, d, i)                                                            \
  c(d[i]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3]), c(d[(i) + 4]), c(d[(i) + 5]), \
      c(d[(i) + 6]), c(d[(i) + 7])
#define BVT_WG_ACC32(c, d) \
  BVT_WG_ACC8(c, d, 0), BVT_WG_ACC8(c, d, 8), BVT_WG_ACC8(c, d, 16), BVT_WG_ACC8(c, d, 24)
#define BVT_WG_REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"              \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// TRANS_B 1 reads B MN-major (imm-trans-b 1; bf16 only)
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_rs_bf16_n64(float* d, const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BVT_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : BVT_WG_ACC32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// the descriptor form at n64: A K-major, B MN-major (TRANS_B 1) or K-major
// (TRANS_B 0), as wgmma_bf16_n128
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BVT_WG_REGS32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : BVT_WG_ACC32("+f", d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_rs_s8_n64(int* d, const uint32_t* a, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " BVT_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : BVT_WG_ACC32("+r", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int KIND, int BN>
__device__ __forceinline__ void wgmma(typename WgTraits<KIND>::Acc* d, uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (KIND == kWgBF16) {
    if constexpr (BN == 128) wgmma_bf16_n128(d, da, db, scale_d);
    else wgmma_bf16_n256(d, da, db, scale_d);
  } else if constexpr (KIND == kWgBF16T) {
    static_assert(BN == 128, "kWgBF16T: n128");
    wgmma_bf16_n128<0>(d, da, db, scale_d);
  } else {
    if constexpr (BN == 128) wgmma_s8_n128(d, da, db, scale_d);
    else wgmma_s8_n256(d, da, db, scale_d);
  }
}

// tile t's (row, column) in the grouped raster
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int group = t / per_group, first = group * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int in = t - group * per_group;
  tm = first + in % rows;
  tn = in / rows;
}

// EpiBias: tile t's part, row and column. The parts' tile columns are
// walked as one raster of parts x tiles_n columns, so the blocks at work
// share A across the parts.
__device__ __forceinline__ void part_coords(int t, int tiles_m, int tiles_n, int parts,
                                            int& part, int& tm, int& tn) {
  int tc;
  tile_coords(t, tiles_m, parts * tiles_n, tm, tc);
  part = tc / tiles_n;
  tn = tc - part * tiles_n;
}

// EpiBias: part p's weight map and bias, by static indices into the
// parameter
template <class P>
__device__ __forceinline__ const CUtensorMap* part_map(const P& ep, int part) {
  return part == 0 ? &ep.b[0] : part == 1 ? &ep.b[1] : &ep.b[2];
}
template <class P>
__device__ __forceinline__ const __nv_bfloat16* part_bias(const P& ep, int part) {
  return part == 0 ? ep.bias[0] : part == 1 ? ep.bias[1] : ep.bias[2];
}

// a box's rows and columns inside [M, N], one element at a time, into
// out's N / chunk contiguous [M, chunk] blocks (for a box that may straddle
// a chunk): thread tid copies half of row tid / 2
template <typename Out>
__device__ __forceinline__ void store_box_plain(const uint8_t* buf, Out* out, int row0, int col0,
                                                int M, int N, int chunk, int tid) {
  constexpr int kCols = kRowBytes / static_cast<int>(sizeof(Out));
  const int r = tid / 2, row = row0 + r;
  if (row >= M) return;
  for (int c = (tid % 2) * (kCols / 2); c < (tid % 2 + 1) * (kCols / 2); ++c) {
    const int col = col0 + c;
    if (col >= N) break;
    const int byte = c * static_cast<int>(sizeof(Out));
    const Out v = *reinterpret_cast<const Out*>(buf + r * kRowBytes +
                                                (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15));
    const int k = col / chunk;
    out[(static_cast<long>(k) * M + row) * chunk + (col - k * chunk)] = v;
  }
}

// -- the kernel ------------------------------------------------------------------

// tma_a: A [M, K] (box kBK x BM); tma_b: bf16 B [K, N] (box 64 x 64), s8
// B^T [N, K] (box 128 x BN; EpiBias: unused, its parts' B^T maps are in
// ep.b); tma_c: EpiRaw C [M, N] fp32 / s32 (box 32 x 64), EpiDequant [N /
// chunk, M, chunk] of Out (box 128 bytes x 64 x 1; unused with ep.direct),
// EpiBias [parts, M, N] bf16 (box 64 x 64 x 1); all in the 128-byte
// swizzle. N is a part's width (EpiBias) or the whole output's.
template <int KIND, int BM, int BN, int STAGES, int SCHED, class EPI = EpiRaw>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  const __grid_constant__ CUtensorMap tma_c, int M, int N, int K,
                  const __grid_constant__ typename EPI::Params ep) {
  using L = WgLayout<KIND, BM, BN, STAGES, SCHED>;
  using Acc = typename WgTraits<KIND>::Acc;
  // EpiDequant dequantises s8 products, EpiBias (alone) bf16 ones read
  // K-major, and their staging gives each consumer thread BN / 128 of a
  // tile's columns
  static_assert(EPI::kBias ? KIND == kWgBF16T && BN == 128
                           : KIND != kWgBF16T && (EPI::kRaw || (KIND == kWgS8 && BN % 128 == 0)),
                "EpiRaw: bf16 or s8; EpiDequant: s8, BN % 128 == 0; EpiBias: kWgBF16T, BN 128");
  constexpr int kConsumers = SCHED == kCoop ? 2 : 1;  // consumers a stage
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* epi = ring + STAGES * L::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + L::kEpi);
  uint64_t* empty = full + STAGES;
  uint64_t* order = empty + STAGES;  // kPingPong: order[c] lets consumer c run
  float* staging = reinterpret_cast<float*>(order + 2);  // EpiDequant, EpiBias
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx, then the bytes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(&order[0], 1);
    mbar_init(&order[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  int parts = 1;  // EpiBias: the weights side by side
  if constexpr (EPI::kBias) parts = ep.parts;
  const int tiles = parts * tiles_m * tiles_n;
  const int ktiles = (K + L::kBK - 1) / L::kBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == 0) {
    // -- producer: one thread keeps the ring full ---------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (tid != 0) return;
    prefetch_map(&tma_a);
    if constexpr (EPI::kBias) {
      for (int p = 0; p < parts; ++p) prefetch_map(part_map(ep, p));
    } else {
      prefetch_map(&tma_b);
    }
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int part = 0, tm, tn;
      if constexpr (EPI::kBias) part_coords(t, tiles_m, tiles_n, parts, part, tm, tn);
      else tile_coords(t, tiles_m, tiles_n, tm, tn);
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % STAGES;
        const uint32_t round = static_cast<uint32_t>(it / STAGES);
        mbar_wait(&empty[s], (round & 1) ^ 1);  // round 0 passes: the ring starts empty
        mbar_expect_tx(&full[s], L::kStage);
        uint8_t* a_s = ring + s * L::kStage;
        uint8_t* b_s = a_s + L::kA;
        tma_load_2d(a_s, &tma_a, &full[s], kt * L::kBK, tm * BM);
        if constexpr (KIND == kWgBF16) {
          // [64 k][64 n] boxes side by side, 8 KB apart along N
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b_s + j * 64 * kRowBytes, &tma_b, &full[s], tn * BN + 64 * j,
                        kt * L::kBK);
        } else if constexpr (EPI::kBias) {
          // BN rows of the part's B^T (zero past its N)
          tma_load_2d(b_s, part_map(ep, part), &full[s], kt * L::kBK, tn * BN);
        } else {
          tma_load_2d(b_s, &tma_b, &full[s], kt * L::kBK, tn * BN);  // BN rows of B^T
        }
      }
    }
    return;
  }

  // -- consumers -------------------------------------------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;  // this consumer: its rows (kCoop) or its tiles
  const int warp = tid / 32, lane = tid % 32;
  constexpr int R = BN / 2;  // accumulators a thread an m64 product
  Acc d[L::MW][R];
#pragma unroll
  for (int mi = 0; mi < L::MW; ++mi)
#pragma unroll
    for (int i = 0; i < R; ++i) d[mi][i] = 0;
  if constexpr (EPI::kRaw || EPI::kBias) {
    if (tid == 0) prefetch_map(&tma_c);
  } else {
    if (tid == 0 && !ep.direct) prefetch_map(&tma_c);
  }
  uint8_t* my_epi = epi + cw * 2 * kEpiBox;
  // the block's n-th tile is blockIdx.x + n gridDim.x; its stages are the
  // ring's n ktiles .. (n + 1) ktiles - 1
  constexpr int kStep = SCHED == kCoop ? 1 : 2;
  const int first = SCHED == kCoop ? 0 : cw;
  // the row of this consumer's first m64 product in a tile
  const int m_off = SCHED == kCoop ? cw * L::MW * 64 : 0;
  // the boxes this consumer has stored: box & 1 is the buffer of the next
  int box = 0;
  for (int n = first; blockIdx.x + n * gridDim.x < tiles; n += kStep) {
    int part = 0, tm, tn;
    if constexpr (EPI::kBias)
      part_coords(blockIdx.x + n * gridDim.x, tiles_m, tiles_n, parts, part, tm, tn);
    else
      tile_coords(blockIdx.x + n * gridDim.x, tiles_m, tiles_n, tm, tn);
    int prev = 0, it = n * ktiles;
    // EpiDequant: this thread's share of the tile's row scale, column
    // scales and biases (EpiBias: its bias), loaded now and staged after
    // the mainloop
    constexpr int kPerC = BN / 128;  // columns a consumer thread stages
    float pre_x = 0.f, pre_w[kPerC], pre_b[kPerC];
    if constexpr (EPI::kBias) {
      const __nv_bfloat16* bias = part_bias(ep, part);
      const int col = tn * BN + tid;
      pre_b[0] = col < N ? bvt_cvt::to_f(bias[col]) : 0.f;
      if constexpr (EPI::kResidual) {
        // this consumer's rows of the tile's residual into L2 while the
        // products run: BN bf16 a row, two lines
        for (int r = tid; r < L::kRowsC; r += 128) {
          const int row = tm * BM + m_off + r;
          if (row >= M) break;
          const __nv_bfloat16* res = ep.residual + static_cast<long>(row) * N + tn * BN;
          prefetch_l2(res);
          if (tn * BN + 64 < N) prefetch_l2(res + 64);
        }
      }
    } else if constexpr (!EPI::kRaw) {
      const int row = tm * BM + m_off + tid;
      if (tid < L::kRowsC && row < M) pre_x = ep.xs[row];
#pragma unroll
      for (int c = 0; c < kPerC; ++c) {
        const int col = tn * BN + c * 128 + tid;
        pre_w[c] = col < N ? ep.ws[col] : 0.f;
        pre_b[c] = col < N ? ep.bias[col] : 0.f;
      }
    }
    // kPingPong: wait for the other consumer to hand over the mainloop
    // (its n / 2-th handover; consumer 0's first tile waits for none)
    if (SCHED == kPingPong && n > 0) mbar_wait(&order[cw], ((n - 1) / 2) & 1);
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], static_cast<uint32_t>(it / STAGES) & 1);
      const uint32_t a_s = smem_u32(ring + s * L::kStage);
      const uint32_t b_s = a_s + L::kA;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // bf16 B is MN-major: 16 k rows of 128 bytes a step, the next 64
        // columns one box (8 KB) on (leading offset), the next 8 k rows
        // 1 KB on (stride offset); s8 and kWgBF16T's B^T are K-major as A is
        const uint64_t db =
            KIND == kWgBF16 ? smem_desc(b_s + ks * 16 * kRowBytes, 64 * kRowBytes, 1024)
                            : smem_desc(b_s + ks * 32, 16, 1024);
#pragma unroll
        for (int mi = 0; mi < L::MW; ++mi) {
          const uint64_t da =
              smem_desc(a_s + (m_off + mi * 64) * kRowBytes + ks * 32, 16, 1024);
          wgmma<KIND, BN>(d[mi], da, db, (kt | ks) != 0);
        }
      }
      wgmma_commit();
      if (kt > 0) {
        // the group of stage kt-1 is done: free its stage
        wgmma_wait<1>();
        if (tid == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    // every product of the tile is issued: hand the mainloop over
    if (SCHED == kPingPong && tid == 0) mbar_arrive(&order[cw ^ 1]);
    wgmma_wait<0>();
    if (tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int mi = 0; mi < L::MW; ++mi) fence_regs<R>(d[mi]);

    if constexpr (EPI::kRaw) {
      // -- EpiRaw: 64 x 32 boxes of the accumulators, TMA stores ------------
#pragma unroll
      for (int mi = 0; mi < L::MW; ++mi) {
        const int row0 = tm * BM + m_off + mi * 64;
#pragma unroll
        for (int j = 0; j < BN / kEpiCols; ++j) {
          // a box wholly past M or N is skipped before it touches a buffer
          // (the TMA clips the rest): every box written is stored, so the
          // store before the last one, which read this buffer, is the one
          // bulk_wait_read<1> waits for
          const int col0 = tn * BN + j * kEpiCols;
          if (row0 >= M || col0 >= N) continue;
          uint8_t* buf = my_epi + (box++ & 1) * kEpiBox;
          if (tid == 0) bulk_wait_read<1>();
          named_sync(1 + cw, 128);
          // accumulator 4 jn + 2 h + e: row 16 warp + lane / 4 + 8 h, column
          // 8 jn + 2 (lane % 4) + e; in the box, 16-byte chunk c of row r
          // sits at chunk c ^ (r % 8)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int jn = j * 4 + q;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = warp * 16 + lane / 4 + 8 * h;
              const int chunk = 2 * q + (lane % 4) / 2;
              uint8_t* p = buf + r * 128 + ((chunk ^ (r & 7)) << 4) + (lane & 1) * 8;
              if constexpr (KIND == kWgBF16)
                *reinterpret_cast<float2*>(p) =
                    make_float2(d[mi][4 * jn + 2 * h], d[mi][4 * jn + 2 * h + 1]);
              else
                *reinterpret_cast<int2*>(p) =
                    make_int2(d[mi][4 * jn + 2 * h], d[mi][4 * jn + 2 * h + 1]);
            }
          }
          fence_proxy_async();
          named_sync(1 + cw, 128);
          if (tid == 0) {
            tma_store_2d(&tma_c, buf, col0, row0);
            bulk_commit();
          }
        }
      }
    } else {
      // -- EpiDequant, EpiBias: 64-row boxes of kCols Out columns (128-byte
      // rows), column by column. First the tile's scales and biases go into
      // the staging (the last reads of the previous tile's came before its
      // last box's second barrier)
      using Out = typename EPI::Out;
      constexpr int kCols = kRowBytes / static_cast<int>(sizeof(Out));  // 32 fp32, 64 bf16
      constexpr int kQ = kCols / 8;  // 8-column accumulator groups a box
      float* st_x = staging + cw * L::template staged<EPI>();
      float* st_w = st_x + L::kRowsC;
      float* st_b = EPI::kBias ? st_x : st_w + BN;
      if constexpr (!EPI::kBias) {
        if (tid < L::kRowsC) st_x[tid] = pre_x;
      }
#pragma unroll
      for (int c = 0; c < kPerC; ++c) {
        if constexpr (!EPI::kBias) st_w[c * 128 + tid] = pre_w[c];
        st_b[c * 128 + tid] = pre_b[c];
      }
      named_sync(1 + cw, 128);
      const int rl = warp * 16 + lane / 4;  // this thread's rows: rl and rl + 8
      float xs[L::MW][2];
      if constexpr (!EPI::kBias) {
#pragma unroll
        for (int mi = 0; mi < L::MW; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) xs[mi][h] = st_x[mi * 64 + rl + 8 * h];
      }
#pragma unroll
      for (int j = 0; j < BN / kCols; ++j) {
        const int col0 = tn * BN + j * kCols;
        if (col0 >= N) continue;
#pragma unroll
        for (int mi = 0; mi < L::MW; ++mi) {
          // as EpiRaw: a box wholly past M or N is skipped before it
          // touches a buffer, and the buffers are counted by stored boxes
          const int row0 = tm * BM + m_off + mi * 64;
          if (row0 >= M) continue;
          // EpiBias<true>: the box's residual pairs, every load issued
          // before the first is used (zero past M and N, which the store
          // clips)
          __nv_bfloat162 res[kQ][2];
          if constexpr (EPI::kBias && EPI::kResidual) {
#pragma unroll
            for (int q = 0; q < kQ; ++q)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = row0 + rl + 8 * h, col = col0 + 8 * q + 2 * (lane % 4);
                res[q][h] = row < M && col < N
                                ? *reinterpret_cast<const __nv_bfloat162*>(
                                      ep.residual + static_cast<long>(row) * N + col)
                                : __floats2bfloat162_rn(0.f, 0.f);
              }
          }
          uint8_t* buf = my_epi + (box++ & 1) * kEpiBox;
          if (tid == 0) bulk_wait_read<1>();
          named_sync(1 + cw, 128);
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int jn = j * kQ + q;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rl + 8 * h, row = row0 + r;
              const int col = col0 + 8 * q + 2 * (lane % 4);
              // this pair's column scales and biases (zero past N)
              const int c = j * kCols + 8 * q + 2 * (lane % 4);
              const float2 b2 = *reinterpret_cast<const float2*>(st_b + c);
              float v[2];
              if constexpr (EPI::kBias) {
                // round(acc + bias), then round(residual + that): the pair
                // lies wholly inside or past N (N even)
                v[0] = __fadd_rn(d[mi][4 * jn + 2 * h], b2.x);
                v[1] = __fadd_rn(d[mi][4 * jn + 2 * h + 1], b2.y);
                if constexpr (EPI::kResidual) {
                  v[0] = __fadd_rn(bvt_cvt::to_f(res[q][h].x),
                                   bvt_cvt::to_f(bvt_cvt::from_f<Out>(v[0])));
                  v[1] = __fadd_rn(bvt_cvt::to_f(res[q][h].y),
                                   bvt_cvt::to_f(bvt_cvt::from_f<Out>(v[1])));
                }
              } else {
                const float2 w2 = *reinterpret_cast<const float2*>(st_w + c);
                const float wv[2] = {w2.x, w2.y}, bv[2] = {b2.x, b2.y};
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float y = __fadd_rn(
                      __fmul_rn(__fmul_rn(__int2float_rn(d[mi][4 * jn + 2 * h + e]), xs[mi][h]),
                                wv[e]),
                      bv[e]);
                  if constexpr (EPI::kResidual) {
                    if (row < M && col + e < N)
                      y = __fadd_rn(
                          y, bvt_cvt::to_f(ep.residual[static_cast<long>(row) * N + col + e]));
                  }
                  v[e] = y;
                }
              }
              // the pair's bytes in row r; 16-byte chunk c sits at c ^ (r % 8)
              const int byte = (8 * q + 2 * (lane % 4)) * static_cast<int>(sizeof(Out));
              bvt_cvt::store2<Out>(
                  reinterpret_cast<Out*>(buf + r * kRowBytes + (((byte >> 4) ^ (r & 7)) << 4) +
                                         (byte & 15)),
                  v[0], v[1]);
            }
          }
          fence_proxy_async();
          named_sync(1 + cw, 128);
          if constexpr (EPI::kBias) {
            if (tid == 0) {
              tma_store_3d(&tma_c, buf, col0, row0, part);
              bulk_commit();
            }
          } else if (ep.direct) {
            store_box_plain<Out>(buf, ep.out, row0, col0, M, N, ep.chunk, tid);
          } else if (tid == 0) {
            tma_store_3d(&tma_c, buf, col0 % ep.chunk, row0, col0 / ep.chunk);
            bulk_commit();
          }
        }
      }
    }
  }
  if (tid == 0) bulk_wait_all();
}

// -- the host side -----------------------------------------------------------------

// error codes past cudaError_t's range, for bvt_error_string
constexpr int kErrNoEncoder = 10001;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 10002;     // it refused an operand
constexpr int kErrRegisters = 10003;  // too few registers at launch for setmaxnreg

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major tensor of 2 or 3 dimensions (dims and box innermost first;
// byte strides of dimensions 1 and 2), 128-byte swizzle, zero fill
inline int encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                  const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  cuuint64_t d[3], st[2];
  cuuint32_t b[3], unit[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i > 0) st[i - 1] = strides[i - 1];
  }
  const CUresult r =
      fn(map, type, rank, const_cast<void*>(base), d, st, b, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// a 2D row-major tensor [outer, inner] of row_bytes-apart rows, read or
// written in boxes of box_outer x box_inner
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                     uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                     uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint32_t box[2] = {box_inner, box_outer};
  return encode(map, type, base, 2, dims, &row_bytes, box);
}

// a kernel's registers a thread at launch, from cudaFuncGetAttributes (or
// a negative cudaError_t)
inline int kernel_registers(const void* kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  return err == cudaSuccess ? attr.numRegs : -static_cast<int>(err);
}

// the kernel opted in to its shared memory, and started with the registers
// its warpgroups ask for: setmaxnreg only moves registers between them, so
// with fewer a consumer would wait forever. Returns 0, a cudaError_t or
// kErrRegisters.
template <int KIND, int BM, int BN, int STAGES, int SCHED, class EPI>
int prepare() {
  using L = WgLayout<KIND, BM, BN, STAGES, SCHED>;
  auto* kernel = wgmma_gemm_kernel<KIND, BM, BN, STAGES, SCHED, EPI>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::template smem<EPI>());
  if (err != cudaSuccess) return err;
  const int regs = kernel_registers(reinterpret_cast<const void*>(kernel));
  if (regs < 0) return -regs;
  if (regs * kThreads < 128 * kProducerRegs + 256 * kConsumerRegs) return kErrRegisters;
  return 0;
}

// as many blocks as the card has SMs, at most one a tile (of `parts`
// outputs of N columns each)
template <int KIND, int BM, int BN, int STAGES, int SCHED, class EPI>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mc, int M, int N,
           int K, const typename EPI::Params& ep, cudaStream_t stream, int parts = 1) {
  using L = WgLayout<KIND, BM, BN, STAGES, SCHED>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long tiles =
      static_cast<long>(parts) * ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  wgmma_gemm_kernel<KIND, BM, BN, STAGES, SCHED, EPI>
      <<<grid, kThreads, L::template smem<EPI>(), stream>>>(ma, mb, mc, M, N, K, ep);
  return cudaGetLastError();
}

// C[M, N] = A[M, K] . B on `stream`, the raw accumulators (b: bf16 B [K,
// N]; s8 B^T [N, K]). Returns 0, a cudaError_t or one of the codes above.
// M == 0 launches nothing.
template <int KIND, int BM, int BN, int STAGES, int SCHED>
int wgmma_gemm(const void* a, const void* b, void* c, int M, int N, int K,
               cudaStream_t stream) {
  using L = WgLayout<KIND, BM, BN, STAGES, SCHED>;
  using Tr = WgTraits<KIND>;
  const int ready = prepare<KIND, BM, BN, STAGES, SCHED, EpiRaw>();
  if (ready != 0) return ready;
  if (M == 0) return cudaSuccess;
  CUtensorMap ma, mb, mc;
  int e = encode_2d(&ma, Tr::in_type, a, K, M, static_cast<uint64_t>(K) * Tr::elem, L::kBK,
                    BM);
  if (e == 0) {
    if constexpr (KIND == kWgBF16)
      e = encode_2d(&mb, Tr::in_type, b, N, K, static_cast<uint64_t>(N) * Tr::elem, 64,
                    L::kBK);
    else
      e = encode_2d(&mb, Tr::in_type, b, K, N, static_cast<uint64_t>(K), L::kBK, BN);
  }
  if (e == 0)
    e = encode_2d(&mc, Tr::out_type, c, N, M, static_cast<uint64_t>(N) * 4, kEpiCols, 64);
  if (e != 0) return e;
  return launch<KIND, BM, BN, STAGES, SCHED, EpiRaw>(ma, mb, mc, M, N, K, {}, stream);
}

// whether a dequantising GEMM's output goes out by the TMA: the output is
// one matrix, or its chunks are whole boxes wide, and its rows are a
// multiple of 16 bytes apart (the TMA's rule); else by plain stores
template <typename Out>
bool tma_output(int N, int chunk) {
  constexpr int kCols = kRowBytes / static_cast<int>(sizeof(Out));
  return (chunk == N || chunk % kCols == 0) && (chunk * sizeof(Out)) % 16 == 0;
}

// the dequantising GEMMs' one configuration: ping-pong 128 x 128 tiles,
// 5 stages (6 and the staging pass the shared-memory limit by 1,136 B)
constexpr int kDqBM = 128, kDqBN = 128, kDqStages = 5, kDqSched = kPingPong;
using DqLayout = WgLayout<kWgS8, kDqBM, kDqBN, kDqStages, kDqSched>;

// out = EPI(a . w^T) on `stream`, EPI an EpiDequant: a [M, K] s8, w [N, K]
// s8 (K a multiple of 16, both 16-byte aligned), ep as EpiDequant::Params
// describes (ep.direct is set here, from the shape). Returns 0, a
// cudaError_t or one of the codes above; M == 0 launches nothing.
template <class EPI>
int wgmma_gemm_dequant(const int8_t* a, const int8_t* w, int M, int N, int K,
                       typename EPI::Params ep, cudaStream_t stream) {
  using Out = typename EPI::Out;
  using L = DqLayout;
  static_assert(L::template smem<EPI>() <= 232448, "past the shared memory of a block");
  if (K <= 0 || K % 16 != 0 || N <= 0 || ep.chunk <= 0 || N % ep.chunk != 0)
    return cudaErrorInvalidValue;
  const int ready = prepare<kWgS8, kDqBM, kDqBN, kDqStages, kDqSched, EPI>();
  if (ready != 0) return ready;
  if (M == 0) return cudaSuccess;
  constexpr uint32_t kCols = kRowBytes / sizeof(Out);
  ep.direct = tma_output<Out>(N, ep.chunk) ? 0 : 1;
  CUtensorMap ma, mb, mc = {};
  int e = encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, K, M, static_cast<uint64_t>(K),
                    L::kBK, kDqBM);
  if (e == 0)
    e = encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, static_cast<uint64_t>(K),
                  L::kBK, kDqBN);
  if (e == 0 && !ep.direct) {
    // [N / chunk, M, chunk]: a box never leaves its chunk
    const uint64_t dims[3] = {static_cast<uint64_t>(ep.chunk), static_cast<uint64_t>(M),
                              static_cast<uint64_t>(N / ep.chunk)};
    const uint64_t row = static_cast<uint64_t>(ep.chunk) * sizeof(Out);
    const uint64_t strides[2] = {row, row * M};
    const uint32_t box[3] = {kCols, 64, 1};
    e = encode(&mc, EPI::out_type, ep.out, 3, dims, strides, box);
  }
  if (e != 0) return e;
  return launch<kWgS8, kDqBM, kDqBN, kDqStages, kDqSched, EPI>(ma, mb, mc, M, N, K, ep,
                                                                stream);
}

// an instantiation's dynamic shared memory, blocks an SM (the occupancy
// calculator), registers a thread at launch and local memory a thread
// (spills) into out[0..3]; returns 0 or a cudaError_t
template <int KIND, int BM, int BN, int STAGES, int SCHED, class EPI>
int kernel_resources(int* out) {
  constexpr int smem = WgLayout<KIND, BM, BN, STAGES, SCHED>::template smem<EPI>();
  const void* kernel =
      reinterpret_cast<const void*>(wgmma_gemm_kernel<KIND, BM, BN, STAGES, SCHED, EPI>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = smem;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// a dequantising GEMM's dynamic shared memory, blocks an SM and registers a
// thread at launch into out[0..2]; returns 0 or a cudaError_t
template <class EPI>
int resources(int* out) {
  int r[4];
  const int err = kernel_resources<kWgS8, kDqBM, kDqBN, kDqStages, kDqSched, EPI>(r);
  if (err != 0) return err;
  for (int i = 0; i < 3; ++i) out[i] = r[i];
  return 0;
}

// the bias GEMMs' one configuration: ping-pong 128 x 128 tiles, 6 stages
// (EpiBias stages 512 B a consumer, so a sixth stage fits: 231,536 B)
constexpr int kBiBM = 128, kBiBN = 128, kBiStages = 6, kBiSched = kPingPong;
using BiasLayout = WgLayout<kWgBF16T, kBiBM, kBiBN, kBiStages, kBiSched>;

// out[p] = round(a . w[p]^T + bias[p]) for p < parts, and with RESIDUAL
// (parts 1) out = round(residual + round(a . w^T + bias)), on `stream`: a
// [M, K], each w[p] [N, K] (torch's [out, in], read in place), bias[p] [N],
// residual [M, N], out `parts` contiguous [M, N] blocks, all bf16; K and N
// multiples of 8, every base 16-byte aligned (the TMA's rules). Returns 0,
// a cudaError_t or one of the codes above; M == 0 launches nothing.
template <bool RESIDUAL>
int wgmma_gemm_bias(const __nv_bfloat16* a, const __nv_bfloat16* const* w,
                    const __nv_bfloat16* const* bias, int parts,
                    const __nv_bfloat16* residual, __nv_bfloat16* out, int M, int N, int K,
                    cudaStream_t stream) {
  using EPI = EpiBias<RESIDUAL>;
  using L = BiasLayout;
  static_assert(L::template smem<EPI>() <= 232448, "past the shared memory of a block");
  if (M < 0 || K <= 0 || K % 8 != 0 || N <= 0 || N % 8 != 0 || parts < 1 ||
      parts > EPI::kMaxParts || (RESIDUAL && (parts != 1 || residual == nullptr)))
    return cudaErrorInvalidValue;
  const int ready = prepare<kWgBF16T, kBiBM, kBiBN, kBiStages, kBiSched, EPI>();
  if (ready != 0) return ready;
  if (M == 0) return cudaSuccess;
  typename EPI::Params ep = {};
  ep.parts = parts;
  ep.residual = residual;
  CUtensorMap ma, mc, unused = {};
  int e = encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, K, M,
                    static_cast<uint64_t>(K) * 2, L::kBK, kBiBM);
  for (int p = 0; p < parts && e == 0; ++p) {
    e = encode_2d(&ep.b[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w[p], K, N,
                  static_cast<uint64_t>(K) * 2, L::kBK, kBiBN);
    ep.bias[p] = bias[p];
  }
  if (e == 0) {
    // [parts, M, N]: a box never leaves its part
    const uint64_t dims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M),
                              static_cast<uint64_t>(parts)};
    const uint64_t row = static_cast<uint64_t>(N) * 2;
    const uint64_t strides[2] = {row, row * M};
    const uint32_t box[3] = {64, 64, 1};
    e = encode(&mc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, 3, dims, strides, box);
  }
  if (e != 0) return e;
  return launch<kWgBF16T, kBiBM, kBiBN, kBiStages, kBiSched, EPI>(ma, unused, mc, M, N, K, ep,
                                                                  stream, parts);
}

// the message of a code returned above
inline const char* error_string(int err) {
  switch (err) {
    case kErrNoEncoder:
      return "cuTensorMapEncodeTiled not found (cudaGetDriverEntryPoint)";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused an operand's tensor map";
    case kErrRegisters:
      return "the wgmma kernel has too few registers at launch for its setmaxnreg split";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // namespace bvt_wgmma
