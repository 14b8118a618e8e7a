// A warp-specialised, persistent Hopper GEMM: wgmma fed by TMA through
// an mbarrier ring.
//
//   C[M, N] = A[M, K] . B          raw accumulator out
//   kWgBF16: bf16 x bf16 -> fp32, B row-major [K, N] (read MN-major)
//   kWgS8:   s8 x s8 -> s32, B given as B^T [N, K] (wgmma reads 8-bit
//            operands K-major only; the caller lays B out)
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
//   - the epilogue: each consumer writes its accumulators into two 8 KB
//     shared-memory boxes (64 rows x 32 columns, 128-byte swizzle) in
//     turn, and one thread stores each box with a TMA store; the stores
//     drain while the next products run, and the producer's loads for
//     the next tile are already in flight.
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

namespace bvt_wgmma {

enum WgKind { kWgBF16 = 0, kWgS8 = 1 };
enum WgSchedule { kCoop = 0, kPingPong = 1 };

constexpr int kThreads = 384;      // producer warpgroup + 2 consumers
constexpr int kRowBytes = 128;     // bytes of K a stage row (the swizzle span)
constexpr int kEpiCols = 32;       // output columns of an epilogue box
constexpr int kEpiBox = 64 * kEpiCols * 4;  // 64 rows of 128 bytes
constexpr int kGroupM = 8;         // tile rows a raster group
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr long long kWatchdogCycles = 1LL << 34;

template <int KIND> struct WgTraits;
template <> struct WgTraits<kWgBF16> {
  using Acc = float;
  static constexpr int elem = 2;
  static constexpr CUtensorMapDataType in_type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType out_type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
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

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
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
// (imm-trans-b 1); s8: both K-major.
__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
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


template <int KIND, int BN>
__device__ __forceinline__ void wgmma(typename WgTraits<KIND>::Acc* d, uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (KIND == kWgBF16) {
    if constexpr (BN == 128) wgmma_bf16_n128(d, da, db, scale_d);
    else wgmma_bf16_n256(d, da, db, scale_d);
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

// -- the kernel ------------------------------------------------------------------

// tma_a: A [M, K] (box kBK x BM); tma_b: bf16 B [K, N] (box 64 x 64), s8
// B^T [N, K] (box 128 x BN); tma_c: C [M, N] fp32 / s32 (box 32 x 64); all
// in the 128-byte swizzle
template <int KIND, int BM, int BN, int STAGES, int SCHED>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  const __grid_constant__ CUtensorMap tma_c, int M, int N, int K) {
  using L = WgLayout<KIND, BM, BN, STAGES, SCHED>;
  using Acc = typename WgTraits<KIND>::Acc;
  constexpr int kConsumers = SCHED == kCoop ? 2 : 1;  // consumers a stage
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* epi = ring + STAGES * L::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + L::kEpi);
  uint64_t* empty = full + STAGES;
  uint64_t* order = empty + STAGES;  // kPingPong: order[c] lets consumer c run
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
  const int tiles = tiles_m * tiles_n;
  const int ktiles = (K + L::kBK - 1) / L::kBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == 0) {
    // -- producer: one thread keeps the ring full ---------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (tid != 0) return;
    prefetch_map(&tma_a);
    prefetch_map(&tma_b);
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
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
  if (tid == 0) prefetch_map(&tma_c);
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
    int tm, tn;
    tile_coords(blockIdx.x + n * gridDim.x, tiles_m, tiles_n, tm, tn);
    int prev = 0, it = n * ktiles;
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
        // 1 KB on (stride offset); s8 B^T is K-major as A is
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

    // -- epilogue: 64 x 32 boxes through shared memory, TMA stores -------
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

// a 2D row-major tensor [outer, inner] of row_bytes-apart rows, read or
// written in boxes of box_outer x box_inner, 128-byte swizzle, zero fill
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                     uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                     uint32_t box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// a kernel's registers a thread at launch, from cudaFuncGetAttributes (or
// a negative cudaError_t)
inline int kernel_registers(const void* kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  return err == cudaSuccess ? attr.numRegs : -static_cast<int>(err);
}

// C[M, N] = A[M, K] . B on `stream`, one block an SM over the output tiles
// (b: bf16 B [K, N]; s8 B^T [N, K]). Returns 0, a cudaError_t or one of
// the codes above. M == 0 launches nothing.
template <int KIND, int BM, int BN, int STAGES, int SCHED>
int wgmma_gemm(const void* a, const void* b, void* c, int M, int N, int K,
               cudaStream_t stream) {
  using L = WgLayout<KIND, BM, BN, STAGES, SCHED>;
  using Tr = WgTraits<KIND>;
  auto* kernel = wgmma_gemm_kernel<KIND, BM, BN, STAGES, SCHED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  // setmaxnreg only moves registers between the warpgroups: the block
  // must start with what the three ask for, or a consumer waits forever
  const int regs = kernel_registers(reinterpret_cast<const void*>(kernel));
  if (regs < 0) return -regs;
  if (regs * kThreads < 128 * kProducerRegs + 256 * kConsumerRegs) return kErrRegisters;
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
  // as many blocks as the card has SMs, at most one a tile
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long tiles = static_cast<long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(ma, mb, mc, M, N, K);
  return cudaGetLastError();
}

}  // namespace bvt_wgmma
