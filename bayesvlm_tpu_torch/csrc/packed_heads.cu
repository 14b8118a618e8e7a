// The packed-head probe of scripts/dev/probe_packed_heads.py, as Hopper
// kernels: the two halves of attention (scores and p . v) alone, per head
// or for a pair of heads packed into one 128-wide product against a
// block-diagonal operand. q, k, v, o: [B, T, H*64] bf16, heads side by
// side; Dh = 64 only (the probe's question is about two 64-wide heads
// filling a 128-wide unit).
//
// (a) qk_kernel<kPacked> replaces `_qk_perhead_kernel`
//     (scripts/dev/probe_packed_heads.py:46; kPacked = false) and
//     `_qk_packed_kernel` (:58; kPacked = true), both called by `make_qk`
//     (:134):
//       per head:  s[b, h]    = fp32(q_h . k_h^T) * SCALE       [B, H, T, T]
//       per pair:  s[b, p]    = fp32(q_ab . Kp^T) * SCALE       [B, H/2, T, 2T]
//     where q_ab is the pair's 128 columns and Kp [2T, 128] is
//     block-diagonal: rows 0:T hold k of head 2p in lanes 0:64 (zeros in
//     64:128), rows T:2T hold k of head 2p+1 in lanes 64:128. Head 2p's
//     scores fill columns 0:T, head 2p+1's T:2T. The scale multiplies the
//     fp32 sum once, after the dot (__fmul_rn), as the TPU body does.
//
// (b) pv_kernel<kPacked> replaces `_pv_perhead_kernel` (:86) and
//     `_pv_packed_kernel` (:97), both called by `make_pv` (:159):
//       per head:  o[:, h*64:(h+1)*64] = bf16(fp32 p_h . v_h)
//       per pair:  o[:, p*128:(p+1)*128] = bf16(fp32 P' . V')
//     p fp32 [B, H, T, T] (or P' [B, H/2, T, 2T], the pair's blocks side
//     by side), V' [2T, 128] block-diagonal like Kp.
//     Precision: p is fp32 and the tensor cores take no fp32 operand; TF32
//     or one bf16 rounding of p would change the function. So each p is
//     split into three bf16 parts, hi = bf16(p), mid = bf16(p - hi), lo =
//     bf16(p - hi - mid), whose sum is p exactly (each residual is exact in
//     fp32 and has at most 16, then 8, significant bits). v is bf16, so
//     every product of a part and v is exact in the fp32 accumulator, and
//     o differs from the fp32 product only by the order of the fp32 sums.
//
// What bounds them on an H100: the fp32 score or probability tensor.
// At the probe's B=80, T=257, H=16 it is 338,170,880 B, and each kernel
// moves it once plus 84,213,760 B of bf16 operands: 0.126 ms at 3.35
// TB/s. The operations (2 B H T^2 64 products per head; twice that
// packed, and three bf16 passes for pv) need 0.011-0.066 ms at the bf16
// tensor rate, so all four are bound by bytes.
//
// The constraint that shapes both designs: the fp32 tensor's rows are T * 4
// bytes apart (2T * 4 packed), 1,028 or 2,056 at T = 257, no multiple of 16,
// so no tensor map can address it (the TMA's rule). But the rows of one
// (b, head or pair) are contiguous: a strip of consecutive rows is one run
// of bytes whose two ends alone are off 16-byte alignment, by at most 12.
// q, k, v and o have rows H * 128 bytes apart, and move by the TMA through a
// 3-D map [B, T, H*64], so that the zero fill (loads) and the clipping
// (stores) happen at T and never reach the next image's rows.
//
// qk design: a persistent block an SM of 288 threads, two consumer
// warpgroups and a producer warp (csrc/wgmma_gemm.cuh's PTX).
//   - Work: strips of `rows` (64, or fewer where a long T leaves a strip
//     too large for the staging) consecutive query rows of one (b, head or
//     pair), B * G * ceil(T / rows) of them, walked by the blocks in turn.
//   - Loads: one producer thread keeps TMA loads in flight: each strip's q
//     (64 rows x 64 bf16, a pair's two such boxes packed) into one of two
//     slots, and its key tiles (64 keys x 64 bf16 of one head, zero past T)
//     into a ring of kQkStages; all in the 128-byte swizzle.
//   - Products: wgmma m64n64k16 from descriptors, B read K-major as A is
//     (a key's 64 dims are its row). The consumers take a strip's key tiles
//     in turn (tile n of the block to consumer n % 2), each tile 4 k16 steps
//     (8 packed) and one commit group. Packed, the contraction is the pair's
//     128 columns: for head 2p's keys steps 4-7, for head 2p+1's steps 0-3,
//     read a zero tile written once a block in shared memory, through its
//     own descriptor. Every zero product runs (the probe's question); none
//     is loaded.
//   - Epilogue: each consumer writes its tile's scaled sums into a staging
//     buffer that holds the strip in its global byte order, starting at the
//     strip's address mod 16, one float a store (a row's first float is
//     only 4-byte aligned at an odd T; lanes of odd and even t4 take the two
//     rows of their fragment in opposite order, which halves the bank
//     conflicts at T = 257; only the T columns of a side and the strip's
//     rows are written). Then one thread sends the strip out: its
//     16-byte-aligned middle by 1-D bulk copies (cp.async.bulk, shared ->
//     global, 16 KB each), the <= 3 floats at each end by plain stores. The
//     copies drain while the next strip's products run; the buffer is
//     rewritten once they have read it (bulk_wait_read).
//   - Staging budget: 232,448 B a block = 1,024 alignment slack + 4 key
//     stages (32 KB) + two q slots (16 KB; packed 32 KB) + the zero tile
//     (packed, 8 KB) + barriers; the rest is staging, 182,176 B per head
//     and 157,600 B packed. A strip of 64 rows takes 64 * T * 4 B (+ 12 of
//     shift): 65,808 at T = 257, so two strips are in flight per head; the
//     packed strip (131,600 B) fits once (twice up to T = 153), so its
//     copies drain while the next strip's q and keys load and its first
//     products run. Past T = 355 (per head) two no longer fit; past 307
//     (packed) one strip holds fewer than 64 rows (qk_plan). (Strips of 32
//     rows, two in flight, measured slower packed: twice the key tiles and
//     products.)
//
// pv design: blocks of 160 threads, a consumer warpgroup and a producer
// warp, two blocks an SM (112,704 B of shared memory per head, 114,752
// packed), each walking strips of 64 query rows of one (b, head or pair).
//   - p loads: the producer warp brings a strip's p a chunk at a time: for
//     each side (head of the pair), all its T keys of a row where a row's
//     1,104-byte slot holds them (T <= 273; else 256 keys at a time), by
//     one 1-D bulk copy a row (cp.async.bulk, global -> shared, lane r
//     issuing rows r and r + 32), the row's keys widened to 16-byte ends
//     (1,040 bytes at T = 257), so key j sits at (the row's address mod
//     16) + 4 j of its slot. Every copy completes on the chunk's full
//     barrier, whose expected bytes are the warp's sum. The one window that
//     would cross the tensor's end (the last row's, where the end is not
//     16-byte aligned) is clamped to end before it, and its last <= 3
//     floats are read by plain loads: no copy reads past the tensor. No
//     4-byte async copies. (Copies of 64 keys, 272 bytes a row into a ring,
//     measured at 1.2 TB/s: per-copy cost, not bytes, bound them.)
//   - v loads: after each chunk's copies the producer issues its 64-key x
//     64-column tiles of the side's head by TMA through the 3-D map (zero
//     past T) into a ring of kPvVStages, read MN-major (imm-trans-b 1). (A
//     second producer warp running the v tiles ahead of the chunks measured
//     no faster.)
//   - Edges: keys past the tile's valid ones inside a widened window belong
//     to the next row, or to nothing; the consumer zeroes them with a
//     select (a product with v's zero fill would not do: 0 * NaN is NaN).
//     k16 steps wholly past them are skipped. Rows past T are neither
//     copied nor stored (the TMA clips o at T).
//   - Products: a k16 step at a time, each consumer thread reads its A
//     fragment (rows g and g + 8 of its warp's 16; keys 2t, 2t+1, 2t+8, 2t+9)
//     as single floats from the chunk, splits each pair into hi, mid and lo
//     bf16 (split3), already in the m16n8k16 A-fragment layout that the
//     register-A wgmma reads, and issues m64n64k16 with A from registers,
//     three a step in the order lo, mid, hi (the next step's fragment is
//     split while they run). Packed, a step issues those three against v
//     into the output half of the side's head and three against a 2 KB zero
//     region (16 keys x 128 bytes) into the other half: two n64 products,
//     not an n128 one with the zero half at its leading offset beside every
//     stage, so one zero region serves the whole block and the per-head and
//     packed kernels share one product loop. Every zero product runs.
//   - Output: the accumulators rounded to bf16 into a 64 x 64 box (two
//     packed) in the 128-byte swizzle, stored by the TMA through the 3-D
//     map, clipped at T (per head two box sets in turn, so a store drains
//     while the next strip runs).
//   - Budget: the packed products are 3 x 21.6 GFLOP, 0.066 ms at 989
//     TFLOP/s (more with T = 257's ragged last strip), against 0.126 ms of
//     bytes. One chunk a block: while one block's products run, the other
//     block's chunk loads. (One block an SM with two chunks in flight and
//     its two consumers splitting the key tiles measured slower packed.)
//
// q, k, v must start 16-byte aligned (the TMA's rule; the wrapper raises
// otherwise); p and s may start at any 4-byte boundary.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <stdint.h>

#include "wgmma_gemm.cuh"  // wgmma, TMA, bulk copy and mbarrier PTX, the tensor-map encoder

namespace {

namespace wg = bvt_wgmma;

constexpr int DH = 64;                          // head dim
constexpr int BQ = 64;                          // query rows a product (wgmma's m64)
constexpr int BK = 64;                          // keys a tile
constexpr int kTile = BK * wg::kRowBytes;       // a q, k, v or o box: 64 rows of 128 B
constexpr int kSmemMax = 232448;                // the opt-in shared memory of a block

// -- (a) scores ----------------------------------------------------------------

constexpr int kQkThreads = 288;  // consumer warpgroups 0 and 1, producer warp 8
constexpr int kQkStages = 4;     // even: a consumer's tiles reuse only its own stages
constexpr int kQkCopy = 16384;   // bytes a bulk store at most

template <bool kPacked> struct QkLayout {
  static constexpr int kQ = (kPacked ? 2 : 1) * kTile;  // a strip's q: 1 or 2 boxes
  static constexpr int kQOff = kQkStages * kTile;       // after the key ring
  static constexpr int kZero = kQOff + 2 * kQ;          // packed: the zero key tile
  static constexpr int kStaging = kZero + (kPacked ? kTile : 0);
  static constexpr int kBarriers = 8 * (2 * kQkStages + 4);
  static constexpr int kSmem = kSmemMax;
  static constexpr int kStagingBytes = (kSmem - 1024 - kStaging - kBarriers) / 16 * 16;
};

// the staging's use at this T: rows a strip, buffers (1 or 2) and their
// pitch in bytes; rows = 0 if one row does not fit
struct QkPlan {
  int rows, nbuf, pitch;
};

template <bool kPacked>
QkPlan qk_plan(int T) {
  const long long nk = kPacked ? 2LL * T : T;
  const long long cap = QkLayout<kPacked>::kStagingBytes;
  // a strip of r rows and its shift (<= 12 bytes), in whole 16-byte pieces
  auto pitch = [&](long long r) { return (r * nk * 4 + 12 + 15) / 16 * 16; };
  if (2 * pitch(BQ) <= cap) return {BQ, 2, static_cast<int>(pitch(BQ))};
  if (pitch(BQ) <= cap) return {BQ, 1, static_cast<int>(pitch(BQ))};
  const long long rows = (cap - 12) / (nk * 4);
  if (rows < 1) return {0, 0, 0};
  return {static_cast<int>(rows), 1, static_cast<int>(pitch(rows))};
}

// tma_q, tma_k: [B, T, H*64] bf16 (box 64 x 64 x 1); s: [B, G, T, nk] fp32
template <bool kPacked>
__global__ void __launch_bounds__(kQkThreads, 1)
qk_kernel(const __grid_constant__ CUtensorMap tma_q, const __grid_constant__ CUtensorMap tma_k,
          float* __restrict__ s, int T, int H, float scale, int rows, int nbuf, int pitch,
          int strips) {
  using L = QkLayout<kPacked>;
  constexpr int kSteps = kPacked ? 8 : 4;  // k16 steps of the contraction (64 or 128)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = base;
  uint8_t* qs = base + L::kQOff;
  uint8_t* zero = base + L::kZero;
  uint8_t* staging = base + L::kStaging;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + L::kStagingBytes);
  uint64_t* empty = full + kQkStages;
  uint64_t* qfull = empty + kQkStages;
  uint64_t* qempty = qfull + 2;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kQkStages; ++st) {
      wg::mbar_init(&full[st], 1);   // the producer's expect_tx, then the bytes
      wg::mbar_init(&empty[st], 1);  // the consumer of the tile
    }
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(&qfull[i], 1);
      wg::mbar_init(&qempty[i], 2);  // both consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kPacked) {
    // the zero tile, read by wgmma (the async proxy) from here on
    for (int i = threadIdx.x; i < kTile / 16; i += kQkThreads)
      reinterpret_cast<uint4*>(zero)[i] = make_uint4(0, 0, 0, 0);
    wg::fence_proxy_async();
  }
  __syncthreads();

  const int G = kPacked ? H / 2 : H;
  const int nk = kPacked ? 2 * T : T;            // columns of s
  const int per_side = (T + BK - 1) / BK;        // key tiles a head
  const int nt = (kPacked ? 2 : 1) * per_side;   // key tiles a strip
  const int strips_bg = (T + rows - 1) / rows;   // strips of one (b, g)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 8) {
    // -- producer: one thread keeps the q slots and the key ring full --------
    if (lane != 0) return;
    wg::prefetch_map(&tma_q);
    wg::prefetch_map(&tma_k);
    int it = 0;
    for (int i = 0, n = blockIdx.x; n < strips; ++i, n += gridDim.x) {
      const int bg = n / strips_bg, q0 = (n % strips_bg) * rows;
      const int b = bg / G, g = bg - b * G;
      const int slot = i & 1;
      wg::mbar_wait(&qempty[slot], ((i >> 1) & 1) ^ 1);  // rounds 0 pass: the slots start empty
      wg::mbar_expect_tx(&qfull[slot], L::kQ);
#pragma unroll
      for (int hh = 0; hh < (kPacked ? 2 : 1); ++hh)
        wg::tma_load_3d(qs + slot * L::kQ + hh * kTile, &tma_q, &qfull[slot],
                        ((kPacked ? 2 * g : g) + hh) * DH, q0, b);
      for (int j = 0; j < nt; ++j, ++it) {
        const int st = it % kQkStages;
        wg::mbar_wait(&empty[st], ((it / kQkStages) & 1) ^ 1);
        wg::mbar_expect_tx(&full[st], kTile);
        const int side = j / per_side, key0 = (j - side * per_side) * BK;
        wg::tma_load_3d(ring + st * kTile, &tma_k, &full[st],
                        (kPacked ? 2 * g + side : g) * DH, key0, b);
      }
    }
    return;
  }

  // -- consumers -----------------------------------------------------------------
  const int c = warp / 4, tid = threadIdx.x % 128, w = tid / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const bool issuer = threadIdx.x == 0;  // consumer 0's first thread sends the strips out
  const uint64_t s_addr = reinterpret_cast<uint64_t>(s);
  const uint32_t z_s = wg::smem_u32(zero);
  float d[32] = {};
  int it0 = 0;  // the block's key tiles before this strip
  for (int i = 0, n = blockIdx.x; n < strips; ++i, n += gridDim.x, it0 += nt) {
    const int bg = n / strips_bg, q0 = (n % strips_bg) * rows;
    const int nrows = min(rows, T - q0);
    const int slot = i & 1;
    uint8_t* buf = staging + (nbuf == 2 ? slot : 0) * pitch;
    // the strip's first byte in s, and where it sits in the staging
    const uint64_t g0 = s_addr + 4ull * (static_cast<uint64_t>(bg) * T + q0) * nk;
    float* sf = reinterpret_cast<float*>(buf + (g0 & 15));
    wg::mbar_wait(&qfull[slot], (i >> 1) & 1);
    const uint32_t q_s = wg::smem_u32(qs + slot * L::kQ);
    bool ready = false;
    for (int j = (it0 & 1) == c ? 0 : 1; j < nt; j += 2) {
      const int it = it0 + j, st = it % kQkStages;
      wg::mbar_wait(&full[st], (it / kQkStages) & 1);
      const int side = kPacked ? j / per_side : 0;
      const int key0 = (j - side * per_side) * BK;
      const uint32_t k_s = wg::smem_u32(ring + st * kTile);
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        // A: q's box ks / 4 (the pair's head), 32 bytes along its rows; B: the
        // key tile where the step's lanes are its head's, else the zero tile
        const uint64_t da = wg::smem_desc(q_s + (ks / 4) * kTile + (ks % 4) * 32, 16, 1024);
        const uint32_t b_s = (!kPacked || ks / 4 == side) ? k_s : z_s;
        wg::wgmma_bf16_n64<0>(d, da, wg::smem_desc(b_s + (ks % 4) * 32, 16, 1024), ks != 0);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs<32>(d);
      if (tid == 0) wg::mbar_arrive(&empty[st]);
      if (!ready) {
        // the buffer's last bulk stores (nbuf strips back) have read it
        if (issuer) {
          if (nbuf == 2) wg::bulk_wait_read<1>();
          else wg::bulk_wait_read<0>();
        }
        wg::named_sync(2, 256);
        ready = true;
      }
      // the scaled sums into the staging, one float a store (a row's first
      // float is only 4-byte aligned at an odd T): accumulator 4 jn + 2 h + e
      // is row 16 w + g8 + 8 h, key 8 jn + 2 t4 + e. Lanes of odd t4 store
      // the lower row while those of even t4 store the upper one, and then
      // the other way round: the rows 8 apart move a store's banks by 8 nk,
      // which spreads the lanes of a warp over twice as many banks at T = 257
      // (2-way conflicts, not 4). Only the strip's rows and the side's T keys.
      const int nvalid = min(BK, T - key0);
      float* tile = sf + (16 * w + g8) * nk + side * T + key0;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int turn = 0; turn < 2; ++turn) {
            const int h = (t4 & 1) ^ turn;
            const int col = 8 * jn + 2 * t4 + e;
            const float v = h ? d[4 * jn + 2 + e] : d[4 * jn + e];
            if (16 * w + g8 + 8 * h < nrows && col < nvalid)
              tile[8 * h * nk + col] = __fmul_rn(v, scale);
          }
    }
    if (!ready) {  // no tile of this strip was this consumer's
      if (issuer) {
        if (nbuf == 2) wg::bulk_wait_read<1>();
        else wg::bulk_wait_read<0>();
      }
      wg::named_sync(2, 256);
    }
    if (tid == 0) wg::mbar_arrive(&qempty[slot]);
    wg::fence_proxy_async();
    wg::named_sync(1, 256);  // both consumers' writes are in
    if (issuer) {
      // [g0, g1): the 16-byte-aligned middle by bulk copies, the ends by
      // plain stores; the staging holds byte x at buf + (g0 & 15) + (x - g0)
      const uint64_t g1 = g0 + 4ull * nrows * nk;
      const uint64_t a0 = (g0 + 15) & ~15ull, a1 = g1 & ~15ull;
      const uint8_t* s0 = reinterpret_cast<const uint8_t*>(sf);
      uint64_t head_end = g1, tail_start = g1;
      if (a1 > a0) {
        for (uint64_t x = a0; x < a1; x += kQkCopy)
          wg::bulk_store(reinterpret_cast<void*>(x), s0 + (x - g0),
                         static_cast<uint32_t>(a1 - x < kQkCopy ? a1 - x : kQkCopy));
        head_end = a0;
        tail_start = a1;
      }
      for (uint64_t x = g0; x < head_end; x += 4)
        *reinterpret_cast<float*>(x) = *reinterpret_cast<const float*>(s0 + (x - g0));
      for (uint64_t x = tail_start; x < g1; x += 4)
        *reinterpret_cast<float*>(x) = *reinterpret_cast<const float*>(s0 + (x - g0));
      wg::bulk_commit();
    }
  }
  if (issuer) wg::bulk_wait_all();
}

// -- (b) p . v -------------------------------------------------------------------

constexpr int kPvThreads = 160;             // consumer warpgroup, producer warp 4
constexpr int kPvVStages = 3;               // v tiles in flight
constexpr int kPRowMax = 1104;              // a p row's slot: <= 273 keys and their shift
constexpr int kZeroBytes = 16 * wg::kRowBytes;  // one k16 step of B: 16 keys x 128 B

template <bool kPacked> struct PvLayout {
  static constexpr int kHalves = kPacked ? 2 : 1;   // n64 products a part a step
  static constexpr int kOutSets = kPacked ? 1 : 2;  // output box sets in turn
  static constexpr int kV = 0;                      // the v ring, 1024-aligned
  static constexpr int kZero = kPvVStages * kTile;  // packed: the zero region
  static constexpr int kOut = kZero + (kPacked ? kZeroBytes : 0);
  static constexpr int kP = kOut + kOutSets * kHalves * kTile;  // the p chunk
  static constexpr int kBar = kP + BQ * kPRowMax;
  static constexpr int kSmem = 1024 + kBar + 8 * (2 + 2 * kPvVStages);
};

// the p chunk at this T: keys a row copy (all T where a row's slot holds
// them, else 256) and the slot's bytes, an odd number of 16-byte pieces
// (a row's first word then moves 4 banks mod 8 from the last row's)
struct PvPlan {
  int chunk, pitch;
};

inline int pv_pitch(int keys) {
  int pieces = (keys * 4 + 12 + 15) / 16;
  return (pieces | 1) * 16;
}

inline PvPlan pv_plan(int T) {
  if (pv_pitch(T) <= kPRowMax) return {T, pv_pitch(T)};
  const int chunk = (kPRowMax - 16 - 12) / 4 / BK * BK;
  return {chunk, pv_pitch(chunk)};
}

// fp32 (x, y) -> three bf16x2 parts (hi, mid, lo) with hi + mid + lo = (x, y)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 r1 = make_float2(__fsub_rn(x, __low2float(h)), __fsub_rn(y, __high2float(h)));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r1.x, r1.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r1.x, __low2float(m)),
                                                 __fsub_rn(r1.y, __high2float(m)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// one k16 step's A fragment as [lo, mid, hi][reg]: rows r0 and r1 (8 below),
// keys k, k + 1, k + 8, k + 9 of the stage rows; kEdge: keys from nvalid on
// are another row's, or nothing's, and read as 0
template <bool kEdge>
__device__ __forceinline__ void fragment(const float* r0, const float* r1, int k, int nvalid,
                                         uint32_t (&f)[3][4]) {
  auto at = [&](const float* row, int key) {
    return !kEdge || key < nvalid ? row[key] : 0.f;
  };
  split3(at(r0, k), at(r0, k + 1), f[2][0], f[1][0], f[0][0]);
  split3(at(r1, k), at(r1, k + 1), f[2][1], f[1][1], f[0][1]);
  split3(at(r0, k + 8), at(r0, k + 9), f[2][2], f[1][2], f[0][2]);
  split3(at(r1, k + 8), at(r1, k + 9), f[2][3], f[1][3], f[0][3]);
}

// tma_v, tma_o: [B, T, H*64] bf16 (box 64 x 64 x 1); p: [B, G, T, nk] fp32
template <bool kPacked>
__global__ void __launch_bounds__(kPvThreads, 2)
pv_kernel(const __grid_constant__ CUtensorMap tma_v, const __grid_constant__ CUtensorMap tma_o,
          const float* __restrict__ p, int B, int T, int H, int strips, int chunk, int pitch) {
  using L = PvLayout<kPacked>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* vt = base + L::kV;
  uint8_t* outs = base + L::kOut;
  uint8_t* pt = base + L::kP;
  uint64_t* pfull = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* pempty = pfull + 1;
  uint64_t* vfull = pempty + 1;
  uint64_t* vempty = vfull + kPvVStages;
  if (threadIdx.x == 0) {
    wg::mbar_init(pfull, 1);   // the producer's expect_tx, then the bytes
    wg::mbar_init(pempty, 4);  // the consumer's four warps
#pragma unroll
    for (int st = 0; st < kPvVStages; ++st) {
      wg::mbar_init(&vfull[st], 1);
      wg::mbar_init(&vempty[st], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kPacked) {
    // the zero region, read by wgmma (the async proxy) from here on
    for (int i = threadIdx.x; i < kZeroBytes / 16; i += kPvThreads)
      reinterpret_cast<uint4*>(base + L::kZero)[i] = make_uint4(0, 0, 0, 0);
    wg::fence_proxy_async();
  }
  __syncthreads();

  const int G = kPacked ? H / 2 : H;
  const int nk = kPacked ? 2 * T : T;            // columns of p
  const int sides = kPacked ? 2 : 1;
  const int strips_bg = (T + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint64_t p_addr = reinterpret_cast<uint64_t>(p);

  if (warp == 4) {
    // -- producer warp: p chunks by bulk copies, v tiles by the TMA ------------
    const uint64_t p_end = p_addr + 4ull * B * G * T * nk;
    if (lane == 0) wg::prefetch_map(&tma_v);
    int pit = 0, vit = 0;
    for (int n = blockIdx.x; n < strips; n += gridDim.x) {
      const int bg = n / strips_bg, q0 = (n % strips_bg) * BQ;
      const int b = bg / G, g = bg - b * G;
      for (int side = 0; side < sides; ++side)
        for (int c0 = 0; c0 < T; c0 += chunk, ++pit) {
          const int nkc = min(chunk, T - c0);
          wg::mbar_wait(pempty, (pit & 1) ^ 1);  // round 0 passes: the stage starts empty
          uint64_t w0[2];
          uint32_t len[2] = {0, 0};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = lane + 32 * h;
            w0[h] = 0;
            if (q0 + r >= T) continue;
            // the row's keys c0 .. c0 + nkc, widened to 16-byte ends
            const uint64_t a0 = p_addr + 4ull * ((static_cast<uint64_t>(bg) * T + q0 + r) * nk +
                                                 side * T + c0);
            const uint64_t a1 = a0 + 4ull * nkc;
            uint64_t hi = (a1 + 15) & ~15ull;
            w0[h] = a0 & ~15ull;
            if (hi > p_end) {
              // the tensor's end is not 16-byte aligned: copy up to its last
              // 16-byte boundary, and the floats past it by plain loads
              hi = p_end & ~15ull;
              uint8_t* dst = pt + r * pitch;
              for (uint64_t x = hi > a0 ? hi : a0; x < a1; x += 4)
                *reinterpret_cast<float*>(dst + (x - w0[h])) = *reinterpret_cast<const float*>(x);
            }
            len[h] = hi > w0[h] ? static_cast<uint32_t>(hi - w0[h]) : 0u;
          }
          uint32_t bytes = len[0] + len[1];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
          __syncwarp();  // the plain stores above before lane 0's arrive
          if (lane == 0) wg::mbar_expect_tx(pfull, bytes);
          __syncwarp();  // the expected bytes are set before any copy lands
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (len[h] != 0)
              wg::bulk_load(pt + (lane + 32 * h) * pitch, reinterpret_cast<const void*>(w0[h]),
                            len[h], pfull);
          // the chunk's v tiles
          for (int key0 = c0; key0 < c0 + nkc; key0 += BK, ++vit) {
            const int st = vit % kPvVStages;
            wg::mbar_wait(&vempty[st], ((vit / kPvVStages) & 1) ^ 1);
            if (lane == 0) {
              wg::mbar_expect_tx(&vfull[st], kTile);
              wg::tma_load_3d(vt + st * kTile, &tma_v, &vfull[st],
                              (kPacked ? 2 * g + side : g) * DH, key0, b);
            }
          }
        }
    }
    return;
  }

  // -- the consumer warpgroup ----------------------------------------------------
  const int tid = threadIdx.x, w = warp;
  const int g8 = lane / 4, t4 = lane % 4;
  if (tid == 0) wg::prefetch_map(&tma_o);
  const uint32_t z_s = wg::smem_u32(base + L::kZero);
  float d[L::kHalves][32] = {};
  int pit = 0, vit = 0, box = 0;
  for (int n = blockIdx.x; n < strips; n += gridDim.x, ++box) {
    const int bg = n / strips_bg, q0 = (n % strips_bg) * BQ;
    const int b = bg / G, g = bg - b * G;
    // this thread's rows: 16 w + g8 and 8 below it, whose windows start at
    // the same offset mod 16 (8 rows are 32 nk bytes apart)
    const uint64_t row0 = static_cast<uint64_t>(bg) * T + q0 + 16 * w + g8;
    int accumulate = 0;
    for (int side = 0; side < sides; ++side)
      for (int c0 = 0; c0 < T; c0 += chunk, ++pit) {
        const int shift =
            static_cast<int>((p_addr + 4ull * (row0 * nk + side * T + c0)) & 15);
        const float* r0 = reinterpret_cast<const float*>(pt + (16 * w + g8) * pitch + shift);
        const float* r1 = reinterpret_cast<const float*>(reinterpret_cast<const uint8_t*>(r0) +
                                                         8 * pitch);
        wg::mbar_wait(pfull, pit & 1);
        for (int key0 = c0; key0 < c0 + min(chunk, T - c0); key0 += BK, ++vit) {
          const int st = vit % kPvVStages;
          const int nvalid = min(BK, T - key0), nsteps = (nvalid + 15) / 16;
          const uint32_t v_s = wg::smem_u32(vt + st * kTile);
          wg::mbar_wait(&vfull[st], (vit / kPvVStages) & 1);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            if (ks >= nsteps) break;  // steps wholly past the valid keys add nothing
            // this step's fragment, then its products: the next step's
            // fragment is split while these run
            uint32_t f[3][4];
            const int k = key0 - c0 + 16 * ks + 2 * t4;
            if (nvalid == BK) fragment<false>(r0, r1, k, nvalid + key0 - c0, f);
            else fragment<true>(r0, r1, k, nvalid + key0 - c0, f);
            // B MN-major: 16 keys of 128 bytes a step, the next 8 keys 1 KB on
            const uint64_t dv = wg::smem_desc(v_s + ks * kZeroBytes, kTile, 1024);
            const uint64_t dz = wg::smem_desc(z_s, kTile, 1024);
            wg::wgmma_fence();
#pragma unroll
            for (int hf = 0; hf < L::kHalves; ++hf) {
              const uint64_t db = (!kPacked || hf == side) ? dv : dz;
#pragma unroll
              for (int part = 0; part < 3; ++part)  // lo, mid, hi
                wg::wgmma_rs_bf16_n64<1>(d[hf], f[part], db, accumulate | part);
            }
            wg::wgmma_commit();
            accumulate = 1;
          }
          wg::wgmma_wait<0>();
#pragma unroll
          for (int hf = 0; hf < L::kHalves; ++hf) wg::fence_regs<32>(d[hf]);
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(&vempty[st]);
        }
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(pempty);  // this warp is done with the chunk
      }

    // -- epilogue: bf16 boxes in the 128-byte swizzle, TMA stores -------------
    uint8_t* ob = outs + (box % L::kOutSets) * L::kHalves * kTile;
    if (tid == 0) wg::bulk_wait_read<L::kOutSets - 1>();  // the set's last stores read it
    wg::named_sync(1, 128);
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // accumulator 4 jn + 2 h + e: row 16 w + g8 + 8 h, column 8 jn + 2 t4
          // + e; 16-byte chunk c of row r sits at c ^ (r % 8)
          const int r = 16 * w + g8 + 8 * h, byte = (8 * jn + 2 * t4) * 2;
          *reinterpret_cast<__nv_bfloat162*>(ob + hf * kTile + r * wg::kRowBytes +
                                             (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)) =
              __floats2bfloat162_rn(d[hf][4 * jn + 2 * h], d[hf][4 * jn + 2 * h + 1]);
        }
    wg::fence_proxy_async();
    wg::named_sync(1, 128);
    if (tid == 0) {
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf)
        wg::tma_store_3d(&tma_o, ob + hf * kTile, ((kPacked ? 2 * g : g) + hf) * DH, q0, b);
      wg::bulk_commit();
    }
  }
  if (tid == 0) wg::bulk_wait_all();
}

// -- launch ----------------------------------------------------------------------

enum Kernel { kQk = 0, kPv = 1 };

const void* kernel_fn(int kernel, int packed) {
  if (kernel == kQk)
    return packed ? reinterpret_cast<const void*>(qk_kernel<true>)
                  : reinterpret_cast<const void*>(qk_kernel<false>);
  return packed ? reinterpret_cast<const void*>(pv_kernel<true>)
                : reinterpret_cast<const void*>(pv_kernel<false>);
}

int smem_bytes(int kernel, int packed) {
  if (kernel == kQk) return packed ? QkLayout<true>::kSmem : QkLayout<false>::kSmem;
  return packed ? PvLayout<true>::kSmem : PvLayout<false>::kSmem;
}

int threads(int kernel) { return kernel == kQk ? kQkThreads : kPvThreads; }

static_assert(QkLayout<false>::kSmem <= kSmemMax && QkLayout<true>::kSmem <= kSmemMax,
              "qk: past the shared memory of a block");
static_assert(2 * (PvLayout<true>::kSmem + 1024) <= 233472 &&
                  2 * (PvLayout<false>::kSmem + 1024) <= 233472,
              "pv: two blocks an SM (each also reserves 1 KB)");

// the kernel opted in to its shared memory (above 48 KB a launch is
// refused unless it did)
cudaError_t prepare(int kernel, int packed) {
  return cudaFuncSetAttribute(kernel_fn(kernel, packed),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(kernel, packed));
}

// blocks of the kernel an SM, times the SMs of the current device: the
// persistent grid's most blocks (read once a device)
cudaError_t resident_blocks(int kernel, int packed, int* out) {
  static int seen[2][2][16];
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && seen[kernel][packed][dev] > 0) {
    *out = seen[kernel][packed][dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_fn(kernel, packed),
                                                        threads(kernel), smem_bytes(kernel, packed));
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  *out = blocks * sms;
  if (dev < 16) seen[kernel][packed][dev] = *out;
  return cudaSuccess;
}

bool shape_ok(int B, int T, int H, int packed) {
  return B >= 0 && T > 0 && H > 0 && (!packed || H % 2 == 0);
}

// [B, T, H*64] bf16 as a 3-D tensor map, boxes of 64 columns x 64 rows x 1
int encode_heads(CUtensorMap* map, const void* base, int B, int T, int H) {
  const uint64_t D = static_cast<uint64_t>(H) * DH;
  const uint64_t dims[3] = {D, static_cast<uint64_t>(T), static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {D * 2, D * 2 * T};
  const uint32_t box[3] = {DH, BQ, 1};
  return wg::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 3, dims, strides, box);
}

}  // namespace

extern "C" {

// kernel: 0 scores (qk), 1 p . v; packed: 0 per head, 1 head pairs

// what the kernel takes on the card: dynamic shared memory a block, blocks
// an SM (the occupancy calculator), registers a thread, local memory a
// thread (spills) and threads a block, into out[0..4]. Returns 0 or a
// cudaError_t.
int bvt_packed_heads_resources(int kernel, int packed, int* out) {
  cudaError_t err = prepare(kernel, packed);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_fn(kernel, packed),
                                                        threads(kernel), smem_bytes(kernel, packed));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel_fn(kernel, packed));
  if (err != cudaSuccess) return err;
  out[0] = smem_bytes(kernel, packed);
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = threads(kernel);
  return 0;
}

// the qk kernel's use of its staging at this T: rows a strip, strips in
// flight (staging buffers) and a buffer's bytes, into out[0..2]. Returns 0,
// or cudaErrorInvalidValue where one row does not fit.
int bvt_qk_plan(int T, int packed, int* out) {
  if (T <= 0) return cudaErrorInvalidValue;
  const QkPlan plan = packed ? qk_plan<true>(T) : qk_plan<false>(T);
  out[0] = plan.rows;
  out[1] = plan.nbuf;
  out[2] = plan.pitch;
  return plan.rows > 0 ? 0 : cudaErrorInvalidValue;
}

// q, k: [B, T, H*64] bf16, 16-byte aligned -> s: [B, H, T, T] fp32 (packed:
// [B, H/2, T, 2T]), 4-byte aligned. Returns 0 (launched), a cudaError_t or
// a tensor-map code of csrc/wgmma_gemm.cuh.
int bvt_qk_scores(const void* q, const void* k, void* s, int B, int T, int H, float scale,
                  int packed, void* stream) {
  if (!shape_ok(B, T, H, packed)) return cudaErrorInvalidValue;
  const QkPlan plan = packed ? qk_plan<true>(T) : qk_plan<false>(T);
  if (plan.rows == 0) return cudaErrorInvalidValue;
  cudaError_t err = prepare(kQk, packed);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  CUtensorMap mq, mk;
  int e = encode_heads(&mq, q, B, T, H);
  if (e == 0) e = encode_heads(&mk, k, B, T, H);
  if (e != 0) return e;
  int most = 0;
  err = resident_blocks(kQk, packed, &most);
  if (err != cudaSuccess) return err;
  const int strips = B * (packed ? H / 2 : H) * ((T + plan.rows - 1) / plan.rows);
  const int grid = strips < most ? strips : most;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(s);
  if (packed)
    qk_kernel<true><<<grid, kQkThreads, QkLayout<true>::kSmem, st>>>(
        mq, mk, out, T, H, scale, plan.rows, plan.nbuf, plan.pitch, strips);
  else
    qk_kernel<false><<<grid, kQkThreads, QkLayout<false>::kSmem, st>>>(
        mq, mk, out, T, H, scale, plan.rows, plan.nbuf, plan.pitch, strips);
  return cudaGetLastError();
}

// p: [B, H, T, T] fp32 (packed: [B, H/2, T, 2T]), 4-byte aligned, v: [B, T,
// H*64] bf16 -> o: [B, T, H*64] bf16, both 16-byte aligned. Returns as
// bvt_qk_scores.
int bvt_pv(const void* p, const void* v, void* o, int B, int T, int H, int packed,
           void* stream) {
  if (!shape_ok(B, T, H, packed)) return cudaErrorInvalidValue;
  cudaError_t err = prepare(kPv, packed);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  CUtensorMap mv, mo;
  int e = encode_heads(&mv, v, B, T, H);
  if (e == 0) e = encode_heads(&mo, o, B, T, H);
  if (e != 0) return e;
  int most = 0;
  err = resident_blocks(kPv, packed, &most);
  if (err != cudaSuccess) return err;
  const int strips = B * (packed ? H / 2 : H) * ((T + BQ - 1) / BQ);
  const int grid = strips < most ? strips : most;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  const PvPlan plan = pv_plan(T);
  if (packed)
    pv_kernel<true><<<grid, kPvThreads, PvLayout<true>::kSmem, st>>>(
        mv, mo, pp, B, T, H, strips, plan.chunk, plan.pitch);
  else
    pv_kernel<false><<<grid, kPvThreads, PvLayout<false>::kSmem, st>>>(
        mv, mo, pp, B, T, H, strips, plan.chunk, plan.pitch);
  return cudaGetLastError();
}

const char* bvt_error_string(int err) { return wg::error_string(err); }

}  // extern "C"
