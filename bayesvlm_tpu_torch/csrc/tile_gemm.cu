// The GEMM probes of scripts/dev/ (bench_int8_mxu.py, bench_int8_sweep.py,
// bench_int4_mxu.py) as Hopper GEMMs over (operand types, block tile). All
// three scripts share one TPU body, `make_matmul`'s `kernel`
// (bench_int8_mxu.py:48, pallas_call :64; bench_int8_sweep.py:37, :53;
// bench_int4_mxu.py:33, :49): a tiled
//
//   C[M, N] = A[M, K] . B[K, N]      B row-major [K, N], as the scripts lay it out
//
// with the raw accumulator as output. Four kinds, one body: the
// warp-specialised persistent wgmma GEMM of wgmma_gemm.cuh (a producer
// warp's TMA loads into an mbarrier ring, two consumer warpgroups,
// TMA-stored epilogue):
//   kBF16  bf16 x bf16 -> fp32     wgmma m64nNk16, B [K, N] read as it lies (MN-major)
//   kS8    s8 x s8 -> s32          wgmma m64nNk32 (exact), after a B^T pass
//   kS4    s4 x s4 -> s32          A and B unpacked to s8 by one prepass, then kS8's GEMM
//   kS8S4  s8 x s4 -> s32          B unpacked to s8 by the prepass, then kS8's GEMM
// s4 operands are packed two a byte along K, the lower k in the low
// nibble (two's complement): A as [M, K/2] bytes, B as [K/2, N] bytes.
// Every kind takes B [K, N] (packed for the s4 kinds) at the C interface.
//
// bf16 and s8 run at 8 configurations (BM x BN, ring depth, the consumers
// sharing each tile or taking whole tiles in turn; BVT_TILES), the s4
// kinds at tile 0. wgmma takes 8-bit operands K-major only, so the s8
// call first lays B out as B^T [N, K] with transpose_s8_kernel, into
// stream-ordered scratch of this library's own pool, and the GEMM reads
// that (~8 MB moved at the probe shape).
//
// The s4 kinds: Hopper's wgmma has no int4 form, and it is the only way
// to the tensor cores' full rate, so the nibbles are widened to s8 first.
// One launch of unpack_s4_kernel writes B^T s8 [N, K] from the packed B
// (transpose_s8_kernel's layout, reading one packed row for every two k:
// 2.1 MB read, 4.2 MB written at the probe shape) and, for s4 x s4, A s8
// [M, K] from the packed A (8.4 MB read, 16.8 MB written), its blocks split
// between the two by blockIdx; then the s8 GEMM runs on those. Each nibble
// is sign-extended to a byte with `__vsub4` ((x ^ 8) - 8 a byte). Integer
// sums are exact, so both kinds give the same int32 outputs as any other
// order. Nor has the H100 a native 4-bit mma.sync: ptxas takes the
// m16n8k64 4-bit shape, but the SASS of a kernel built on it (the s4
// kinds' kernel before this design; cuobjdump -sass) holds no IMMA with
// 4-bit operands, only 32 calls of one 190-instruction subroutine that
// sign-extends both fragments' nibbles to bytes with shifts and masks and
// issues two IMMA.16832.S8.S8 (m16n8k32 s8) from a zero accumulator, the
// caller adding the sums: 44 TOP/s, 3.1 ms at the probe shape (PERF.md
// section 7).
//
// Edges: K must be a multiple of 16 (bf16) or 32 (s8, and the s4 kinds:
// whole k32 steps, 16-byte packed A rows) and N of 16; every operand
// 16-byte aligned with rows a multiple of 16 bytes apart (the TMA's
// rule); the wrapper raises otherwise. M, N and K are masked by the TMA
// (zero-filled loads, clipped or skipped stores).
//
// What bounds it on an H100 at the probes' M, K, N = 16384, 1024, 4096:
// bf16 the operations (137.4 G at 989 TFLOP/s: 0.139 ms; bytes 0.093);
// s8 the bytes, chiefly the 268 MB int32 output (0.086 ms; operations at
// 1,979 TOP/s 0.069); s4 x s4 and s8 x s4 the bytes (0.083, 0.086 ms;
// NVIDIA publishes no int4 tensor rate for the H100, so the operations
// are held to the int8 rate, 0.069 ms). The design moves more than the
// bound counts: the prepass's 31.5 MB (s4 x s4) or 6.3 MB (s8 x s4), and
// the GEMM's read of A at a byte a value: 0.096 / 0.088 ms at 3.35 TB/s.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <stdint.h>

#include <mutex>

#include "wgmma_gemm.cuh"

namespace {

enum Kind { kBF16 = 0, kS8 = 1, kS4 = 2, kS8S4 = 3 };

// -- B^T and the s4 prepass ----------------------------------------------------

constexpr int kPrepThreads = 128;  // threads a block of both passes

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

// w[i]: bytes of B rows k0 + i (i < 32), columns 4 n4 .. 4 n4 + 3; eight
// 4 x 4 byte transposes, and 32 bytes written to each of bt's rows 4 n4 ..
// 4 n4 + 3
__device__ __forceinline__ void store_bt(const uint32_t* w, uint8_t* bt, int n4, int k0,
                                         int K) {
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

// bt[N, K] = b[K, N]^T (bytes; K % 32 == 0, N % 16 == 0). A thread takes 32
// rows of 4 columns: 32 coalesced word loads (a warp reads 128 bytes a
// row), then store_bt.
__global__ void __launch_bounds__(kPrepThreads)
transpose_s8_kernel(const uint32_t* __restrict__ b, uint8_t* __restrict__ bt, int K, int N) {
  const int n4 = blockIdx.x * blockDim.x + threadIdx.x;
  if (n4 * 4 >= N) return;
  const int k0 = blockIdx.y * 32;
  const int words = N / 4;
  uint32_t w[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) w[i] = __ldg(b + (long)(k0 + i) * words + n4);
  store_bt(w, bt, n4, k0, K);
}

// the 8 nibbles of w in order, low first, as 8 sign-extended bytes
__device__ __forceinline__ uint2 widen8(uint32_t w) {
  const uint32_t lo = low_nibbles(w), hi = high_nibbles(w);
  return make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
}

// The s4 kinds' prepass, one launch (K % 32 == 0, N % 16 == 0):
//   blocks [0, b_cols K / 32): bt[N, K] s8 = B^T from b packed [K/2, N], as
//     transpose_s8_kernel lays it out: a thread takes 32 k of 4 columns
//     from 16 packed rows (a warp reads 128 bytes a row), the low nibbles
//     of packed row r being B row 2r and the high ones row 2r + 1;
//   the blocks after them (s4 x s4; none when a_chunks == 0): a8[M, K] s8
//     from a packed [M, K/2]. Packed A's bytes in order hold A's values in
//     order, two a byte, low nibble first, so a thread reads one 16-byte
//     chunk and writes its 32 values as two 16-byte chunks.
__global__ void __launch_bounds__(kPrepThreads)
unpack_s4_kernel(const uint32_t* __restrict__ b, uint8_t* __restrict__ bt,
                 const uint4* __restrict__ a, uint4* __restrict__ a8, long a_chunks, int K,
                 int N, int b_cols) {
  const int b_blocks = b_cols * (K / 32);
  if (static_cast<int>(blockIdx.x) < b_blocks) {
    const int n4 = (blockIdx.x % b_cols) * kPrepThreads + threadIdx.x;
    if (n4 * 4 >= N) return;
    const int k0 = (blockIdx.x / b_cols) * 32;
    const int words = N / 4;
    uint32_t w[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t p = __ldg(b + (long)(k0 / 2 + i) * words + n4);
      w[2 * i] = low_nibbles(p);
      w[2 * i + 1] = high_nibbles(p);
    }
    store_bt(w, bt, n4, k0, K);
    return;
  }
  const long i = (long)(blockIdx.x - b_blocks) * kPrepThreads + threadIdx.x;
  if (i >= a_chunks) return;
  const uint4 p = __ldg(a + i);
  const uint2 x = widen8(p.x), y = widen8(p.y), z = widen8(p.z), w = widen8(p.w);
  a8[2 * i] = make_uint4(x.x, x.y, y.x, y.y);
  a8[2 * i + 1] = make_uint4(z.x, z.y, w.x, w.y);
}

// the prepass on `stream`: bt [N, K] s8 from b packed [K/2, N] and, when a
// is given (s4 x s4), a8 [M, K] s8 from a packed [M, K/2]
int unpack_s4(const void* a, const void* b, void* a8, void* bt, int M, int N, int K,
              cudaStream_t stream) {
  const int b_cols = (N / 4 + kPrepThreads - 1) / kPrepThreads;
  const long a_chunks = a == nullptr ? 0 : (long)M * K / 32;
  const long blocks = (long)b_cols * (K / 32) + (a_chunks + kPrepThreads - 1) / kPrepThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  unpack_s4_kernel<<<static_cast<unsigned>(blocks), kPrepThreads, 0, stream>>>(
      static_cast<const uint32_t*>(b), static_cast<uint8_t*>(bt), static_cast<const uint4*>(a),
      static_cast<uint4*>(a8), a_chunks, K, N, b_cols);
  return cudaGetLastError();
}

// -- the tiles and their launch ---------------------------------------------

// BM, BN, STAGES and schedule of the 8 wgmma configurations of bf16 and
// s8 (384 threads: a producer and two consumer warpgroups;
// probes/tile_gemm.py TILES lists the same, in the same order; tile 0 is
// the default, and the s4 kinds' only one)
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

using Run = int (*)(const void*, const void*, void*, int, int, int, cudaStream_t);

struct Entry {
  int bm, bn, threads, stages, smem;
  int schedule;  // bvt_wgmma::WgSchedule
  const void* fn;
  Run run;
};

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

// the 8-bit kinds: B laid out as B^T s8 [N, K] into stream-ordered
// scratch (s8: transpose_s8_kernel; the s4 kinds: the prepass, which for
// s4 x s4 also writes A s8 [M, K] after it), then the s8 wgmma GEMM on
// it, on one stream
template <int KIND, int BM, int BN, int STAGES, int SCHED>
int run_s8(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t stream) {
  if (M == 0) return bvt_wgmma::wgmma_gemm<bvt_wgmma::kWgS8, BM, BN, STAGES, SCHED>(
                  a, nullptr, c, M, N, K, stream);
  const dim3 grid((N / 4 + kPrepThreads - 1) / kPrepThreads, K / 32);
  if (KIND == kS8 && grid.y > 65535) return cudaErrorInvalidValue;
  const size_t bt_bytes = static_cast<size_t>(N) * K;
  const size_t a_bytes = KIND == kS4 ? static_cast<size_t>(M) * K : 0;
  cudaMemPool_t pool;
  cudaError_t err = scratch_pool(&pool);
  uint8_t* bt = nullptr;
  if (err == cudaSuccess)
    err = cudaMallocFromPoolAsync(reinterpret_cast<void**>(&bt), bt_bytes + a_bytes, pool,
                                  stream);
  if (err != cudaSuccess) return err;
  uint8_t* a8 = KIND == kS4 ? bt + bt_bytes : nullptr;  // N K: a multiple of 512
  int e;
  if constexpr (KIND == kS8) {
    transpose_s8_kernel<<<grid, kPrepThreads, 0, stream>>>(static_cast<const uint32_t*>(b), bt,
                                                           K, N);
    e = cudaGetLastError();
  } else {
    e = unpack_s4(KIND == kS4 ? a : nullptr, b, a8, bt, M, N, K, stream);
  }
  if (e == cudaSuccess)
    e = bvt_wgmma::wgmma_gemm<bvt_wgmma::kWgS8, BM, BN, STAGES, SCHED>(
        KIND == kS4 ? a8 : a, bt, c, M, N, K, stream);
  err = cudaFreeAsync(bt, stream);
  return e != cudaSuccess ? e : err;
}

template <int KIND, int BM, int BN, int STAGES, int SCHED>
Entry wgmma_entry() {
  constexpr int WG = KIND == kBF16 ? bvt_wgmma::kWgBF16 : bvt_wgmma::kWgS8;
  using L = bvt_wgmma::WgLayout<WG, BM, BN, STAGES, SCHED>;
  Run run;
  if constexpr (KIND == kBF16)
    run = &bvt_wgmma::wgmma_gemm<WG, BM, BN, STAGES, SCHED>;
  else
    run = &run_s8<KIND, BM, BN, STAGES, SCHED>;
  return {BM, BN, bvt_wgmma::kThreads, STAGES, L::kSmem, SCHED,
          reinterpret_cast<const void*>(&bvt_wgmma::wgmma_gemm_kernel<WG, BM, BN, STAGES, SCHED>),
          run};
}

// bf16 and s8 at every tile (the sweep); s4 and s8 x s4 at tile 0
template <int KIND>
Entry kind_entry(int tile) {
  switch (tile) {
#define BVT_CASE(i, bm, bn, st, sched)                    \
  case i:                                                 \
    if constexpr (i == 0 || KIND == kBF16 || KIND == kS8) \
      return wgmma_entry<KIND, bm, bn, st, sched>();      \
    else                                                  \
      return Entry{};
    BVT_TILES(BVT_CASE)
#undef BVT_CASE
    default: return Entry{};
  }
}

Entry lookup(int kind, int tile) {
  if (tile < 0 || tile >= kTiles) return Entry{};
  switch (kind) {
    case kBF16: return kind_entry<kBF16>(tile);
    case kS8: return kind_entry<kS8>(tile);
    case kS4: return kind_entry<kS4>(tile);
    case kS8S4: return kind_entry<kS8S4>(tile);
    default: return Entry{};
  }
}

// K a multiple of one wgmma step's depth (16 bf16, 32 s8; the s4 kinds run
// the s8 product), N of 16
bool shape_ok(int kind, int M, int N, int K) {
  const int depth = kind == kBF16 ? 16 : 32;
  return M >= 0 && N > 0 && K > 0 && K % depth == 0 && N % 16 == 0;
}

}  // namespace

extern "C" {

// kind: 0 bf16 -> fp32, 1 s8 -> s32, 2 s4 x s4 -> s32, 3 s8 x s4 -> s32;
// tile: 0-7 for bf16 and s8, 0 for the others

// the tile's BM, BN, threads, stages, dynamic shared-memory bytes and
// schedule (0 cooperative, 1 ping-pong) into out[0..5]; returns 0, or -1
// for a (kind, tile) that is not built
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
// packed for s4 x s4). Returns 0 when launched (or M == 0), a
// cudaError_t, or a tensor-map code (bvt_error_string).
int bvt_tile_gemm(int kind, int tile, const void* a, const void* b, void* c, int M, int N,
                  int K, void* stream) {
  if (!shape_ok(kind, M, N, K)) return cudaErrorInvalidValue;
  const Entry e = lookup(kind, tile);
  if (e.fn == nullptr) return cudaErrorInvalidValue;
  return e.run(a, b, c, M, N, K, static_cast<cudaStream_t>(stream));
}

// the s4 kinds' prepass alone, as bvt_tile_gemm launches it: bt [N, K]
// s8 = B^T from b packed [K/2, N] and, unless a is null, a8 [M, K] s8
// from a packed [M, K/2]. K % 32 == 0, N % 16 == 0. Returns 0 when
// launched, or a cudaError_t.
int bvt_tile_gemm_unpack_s4(const void* a, const void* b, void* a8, void* bt, int M, int N,
                            int K, void* stream) {
  if (!shape_ok(kS4, M, N, K)) return cudaErrorInvalidValue;
  return unpack_s4(a, b, a8, bt, M, N, K, static_cast<cudaStream_t>(stream));
}

const char* bvt_error_string(int err) { return bvt_wgmma::error_string(err); }

}  // extern "C"
