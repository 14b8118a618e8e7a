// The tensor-core body of the attention kernel (bf16 one-block,
// split-key and packed-pair, and the bf16 probe kernels v2-v6 of
// csrc/attention_variants.cu), and the launcher that picks a body for
// every (dtype, schedule) of csrc/attention.cu and csrc/attention_block.cu.
//
// Replaces, for bf16 inputs, the TPU kernels `_mha_kernel`,
// `_mha_split_kernel` and `_mha_packed_kernel` of
// bayesvlm_tpu/models/attention_pallas.py, with their rounding points
// (attention_pallas.py:199-222, csrc/attention.cuh):
//
//   s = (q_h . k_h^T) accumulated in fp32, then * scale
//   p = exp(s - max) / sum in fp32, rounded to bf16
//   o = p . v accumulated in fp32, rounded to bf16
//
// In bf16 both products are bf16 x bf16 with fp32 sums, which is what
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 computes: only the order of
// the fp32 sums differs from the plain version. fp32 inputs keep the
// CUDA-core bodies of csrc/attention.cuh and csrc/attention_variants.cu
// (the tensor cores would round them to TF32).
//
// Design. One block of 4 warps per (64-row query tile, head, batch row);
// each warp owns 16 query rows.
//   - Each warp reads its Q rows once, straight from device memory into
//     its mma A fragments (4-byte pairs, Dh/16 k-steps), and keeps them in
//     registers for the block: Q takes no shared memory.
//   - K and V pass through a ring of MSTAGES stages of two 64-row tiles in
//     shared memory, filled by 16-byte cp.async copies, so that the next
//     stage's copy runs while this stage's mma do. Rows at or past T are
//     zero-filled by the copy's src-size operand (a p of 0 times a stale
//     NaN would be NaN).
//   - Shared-memory rows are padded by 16 bytes (2 Dh + 16 bytes a row),
//     so the 8 rows of 16 bytes an ldmatrix phase reads fall in 32
//     distinct banks for Dh = 16, 64 and 80 alike: no swizzle needed.
//   - The exact softmax needs each row's max and sum before any p is
//     rounded, and keeps no score tile: the keys are swept twice.
//     Sweep 1 computes S = Q.K^T tile by tile (two K tiles a stage, so
//     half as many barriers) and keeps each row's running max and its
//     sum of exp(s - max), rescaled when the max grows; a row's four quad
//     lanes combine by __shfl_xor_sync. Sweep 2 computes S again (a K and
//     a V tile a stage), forms p from the final max and sum, rounds p to
//     bf16 once and feeds it straight from the S accumulators as the A
//     operand of O += P.V (the m16n8k16 C fragments of two 8-key tiles
//     are the A fragment of one 16-key step); V's B fragments come from
//     ldmatrix.trans. The second Q.K^T costs 2 B H T^2 Dh more
//     operations; in return shared memory holds no score tile (36 KB a
//     block at Dh = 64, whatever T) and T is not bounded by shared
//     memory. Keeping a whole score row in registers (FlashAttention-2's
//     online softmax) would round p before the row's final sum is known.
//   - exp and the division are the fast forms: exp(x) = __expf(x) (ex2 of
//     x * log2 e, a few fp32 ulps) and p = e * (1 / l) with one
//     correctly rounded reciprocal a row. Against expf and a true division
//     each p moves by a few fp32 ulps, far inside one bf16 ulp, and on an
//     H100 the exact forms cost the kernel much of its time. s = acc *
//     scale and s - max stay explicit __fmul_rn / __fsub_rn, so that nvcc
//     does not contract them into one FMA that would skip the rounding of
//     s. Keys at or past T get -inf before the max.
//   - The ragged edge: 16-key groups past T skip their mma and exps, and
//     a warp whose 16 rows all lie past T only copies; a query tile of a
//     few rows (T = 257) still holds a block through every key.
//   - Registers: the one-block instantiation is built for 4 blocks an SM
//     (128 registers a thread, no spill at Dh = 16, 64, 80), 16 warps to
//     hide the mma, shuffle and barrier latencies; fewer blocks, or more
//     with spills, were slower on an H100.
//   - Split-key (`_mha_split_kernel`): t_main = 128 floor(T / 128); the
//     main tiles are whole (no key there is masked), the remainder's
//     tiles are masked and summed into a second O accumulator, and the
//     output is main + rest added in fp32 and rounded once. The caller
//     takes one-block when t_main or the remainder is 0.
//   - The output is rounded to bf16 and written from the accumulators:
//     the four lanes of a quad write 16 contiguous bytes of one row.
//   - Groups (NH heads x NR batch rows a block; #1 and #2 are NH = NR =
//     1): the block walks its groups in turn over one step loop, so the
//     ring's copies for the next group's first steps overlap this group's
//     last; each group's state starts afresh and its output is written
//     at its last step. Each warp computes for its (head, row) exactly
//     what a one-group warp does: the same bits.
//   - Heads side by side (NP; the packed pair, `_mha_packed_kernel`, is
//     NP = 2): a block of NP x 4 warps, warps 4i .. 4i+3 doing head i of
//     the NP contiguous heads exactly as a #1 block's warps do, so the
//     output equals #1's bit for bit. The TPU filled its 128 lanes with
//     two Dh = 64 heads through block-diagonal K'/V' (half of each
//     product exact zeros) and a softmax segmented per head; on Hopper
//     Dh = 64 already fills the mma's k-steps, so the pair is the block
//     owning the heads' NP Dh contiguous columns: one ring holds both
//     heads' K and V rows (rows of 2 NP Dh + 16 bytes, whose 8-row
//     ldmatrix phases still fall in 32 distinct banks at Dh = 16, 64,
//     80). Each 4-warp half copies and reads only its head's columns and
//     meets only at its own named barrier (bar.sync 1 + half, 128
//     threads): a block-wide barrier, tying every warp to the slowest of
//     8, made the pair 1.11x #1 on an H100, the halves' own barriers
//     1.06-1.08x (a block still retires with its slower half; timed by
//     probes/compare_builds.py). At Dh = 64 that is 69,632 B and 2 blocks
//     of 8 warps an SM (at most 128 registers; 8 bytes spilled at Dh =
//     80): #1's 16 warps an SM and its wave count, where walking the pair
//     in turn (NH = 2) halves the blocks and lengthens each (1.06-1.10x
//     #1, never ahead of side by side).
//   - bf16 scores (kFnBf16Scores, the probe v4, `_kernel_v4`): each score
//     is rounded to bf16 after the scale, before the -inf mask, in both
//     sweeps alike, so sweep 1's max and sum describe exactly the scores
//     sweep 2 turns into p. A key pair's two scores take one packed
//     conversion (cvt.rn.bf16x2.f32) and two unpacking ops: 1.06-1.07x #1
//     on an H100, where one conversion a score was 1.11x.
//   - Deferred normalisation (kFnDeferred, the probe v2, `_kernel_v2`;
//     kFnDeferredNoMax, v3, the same without the max): q is scaled and
//     rounded to bf16 as its fragments are read (qs = round(q * scale),
//     two products and one packed conversion a pair), so S = Qs.K^T takes
//     no scale; p = round(e) is unnormalised, each lane adds the unrounded
//     e to its rows' sums, the quad sums them after the last key, and the
//     output is round(acc / den), a true division. v2's sweep 1 keeps only
//     each lane's running max (no exp; the quad combines once, after the
//     last tile); sweep 2 takes e = exp(s - max), its sum and P.V. v3 has
//     no max and sweeps once: a step is a K and a V tile, e = exp(s), its
//     sum and P.V, nt steps where #1 takes n1 + nt. On an H100 at B=80,
//     T=257, H=16, Dh=64: v2 0.86-0.87x #1 (sweep 1 without its exps and
//     shuffles), v3 0.59-0.61x, so the max sweep costs 0.26-0.27 of #1;
//     at most 128 registers, no spill at Dh = 16, 64, 80.
//
// What bounds it on an H100 at ViT-L/14, B=64, T=257, H=16, Dh=64: the
// function moves 135 MB (0.040 ms at 3.35 TB/s) and does 17.3 G
// operations (0.018 ms at the bf16 rate). This body does 1.5 times those
// operations (the second Q.K^T) on mma.sync, not wgmma; two exps a score
// (sweep 1's sum, sweep 2's p) on the MUFU units, 16 an SM a clock
// (about 0.04 ms); and each block reads its head's K twice and V once
// from L2 (5 query tiles a head at T=257). With 16 warps an SM it is
// bound by latency (each step's chain of ldmatrix, mma, shuffles and the
// block's barrier), not by any one of those rates.
//
// Needs 16-byte aligned q, k, v, o (the wrapper checks) and a head dim
// that is a multiple of 16.

#pragma once

#include <type_traits>

#include "attention.cuh"
#include "int8_gemm.cuh"

namespace bvt_attn {

constexpr int MW = 4;                 // warps of a tensor-core block
constexpr int MT = 32 * MW;           // its threads
constexpr int MQ = 16 * MW;           // its query rows (one 16-row mma tile a warp)
constexpr int MK = 64;                // keys of a K or V tile
constexpr int MSTAGES = 2;            // ring depth: stages of two tiles
// the function an instantiation computes (its parameter F): #1's exact
// softmax; v4's scores rounded to bf16; v2's deferred normalisation; v3,
// v2 without the max
enum Function { kFnExact = 0, kFnBf16Scores = 1, kFnDeferred = 2, kFnDeferredNoMax = 3 };
__host__ __device__ constexpr bool deferred(int F) { return F >= kFnDeferred; }
static_assert(MQ == BQ, "both bodies tile the queries alike (one grid)");
// blocks an SM each instantiation is built for (__launch_bounds__: the
// registers a thread); the split-key one holds a second O accumulator,
// and NP heads side by side make a block NP times as wide
constexpr int kMinBlocksOneBlock = 4;
constexpr int kMinBlocksSplit = 3;
__host__ __device__ constexpr int mma_min_blocks(int S, int NP) {
  return S == kSplitKey ? kMinBlocksSplit : kMinBlocksOneBlock / NP;
}

// shared-memory row stride of a K or V tile row of W columns (bytes):
// 16 bytes of padding put the 8 rows an ldmatrix phase reads in 32
// distinct banks
__host__ __device__ constexpr int mma_row_bytes(int W) { return 2 * W + 16; }

// dynamic shared memory of a tensor-core block staging W columns (NP
// heads of HD): MSTAGES stages of two 64-row tiles (two K tiles in sweep
// 1, a K and a V tile in sweep 2); independent of T
__host__ __device__ constexpr long mma_smem_bytes(int W) {
  return (long)MSTAGES * 2 * MK * mma_row_bytes(W);
}

// rows r0 .. r0+63 of the HD columns at `base` (row stride D) of a bf16 k
// or v into dst (row stride RB bytes), 16 bytes a cp.async by MT threads
// (tid the thread's index among them); rows at or past seq are
// zero-filled (nothing is read)
template <int HD, int RB>
__device__ __forceinline__ void load_rows_async(int8_t* dst, const __nv_bfloat16* src,
                                                long base, long D, int r0, int seq,
                                                int tid) {
  constexpr int CH = HD / 8;          // 16-byte chunks of a row
  static_assert(64 * CH % MT == 0, "every thread copies as many chunks");
#pragma unroll
  for (int i = 0; i < 64 * CH / MT; ++i) {
    const int c = tid + i * MT;
    const int r = c / CH, ch = c % CH;
    const bool ok = r0 + r < seq;
    bvt_int8::cp_async16(dst + r * RB + ch * 16,
                         src + base + (long)(ok ? r0 + r : 0) * D + ch * 8, ok ? 16 : 0);
  }
}

// a bf16 pair times scale, each product rounded to bf16 once:
// round_bf16(fp32(q) * scale), as `_kernel_v2` scales q
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scale) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the m16n8k16 A fragments of the warp's 16 query rows row0 .. row0+15
// (HD/16 k-steps), read straight from device memory in 4-byte pairs: the
// lane's rows g and g+8, columns 16kk + 2t (+1) and 16kk + 8 + 2t (+1);
// rows at or past seq are zero; with kScaleQ each element is scaled and
// rounded as it is read (scale_pair)
template <int HD, bool kScaleQ = false>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[HD / 16][4],
                                             const __nv_bfloat16* q, long base, long D,
                                             int row0, int seq, int g, int t,
                                             float scale = 1.f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    const bool ok = row < seq;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(q + base + (long)(ok ? row : 0) * D);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qf[kk][h] = ok ? __ldg(src + 8 * kk + t) : 0u;
      qf[kk][2 + h] = ok ? __ldg(src + 8 * kk + 4 + t) : 0u;
      if constexpr (kScaleQ) {
        qf[kk][h] = scale_pair(qf[kk][h], scale);
        qf[kk][2 + h] = scale_pair(qf[kk][2 + h], scale);
      }
    }
  }
}

// s (16 query rows x 64 keys: eight 8-key mma tiles) = (Q . K^T) * scale
// from the Q A fragments and the K tile ks (row stride RB bytes; koff
// holds the lane's row and the head's column), rounded to bf16 for
// kFnBf16Scores, with no scale for the deferred functions (their Q
// fragments hold it), keys at or past nvalid set to -inf; 16-key groups
// at or past nvalid run no mma and are never read
template <int HD, int RB, int F>
__device__ __forceinline__ void qk_mma(float (&s)[8][4], const uint32_t (&qf)[HD / 16][4],
                                       const int8_t* ks, int koff, int nvalid,
                                       float scale, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (16 * jp >= nvalid) continue;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // K rows are the "col" B operand as stored: no .trans; r[0..1]
      // serve keys 16 jp .. +7, r[2..3] keys 16 jp + 8 .. +15
      uint32_t r[4];
      bvt_int8::ldmatrix_x4(r, ks + 16 * jp * RB + kk * 32 + koff);
      bvt_int8::mma_bf16(s[2 * jp], qf[kk], r);
      bvt_int8::mma_bf16(s[2 * jp + 1], qf[kk], r + 2);
    }
  }
  // the lane's accumulator e of tile j: row g + 8 (e / 2), key 8j + 2t + e % 2
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (!deferred(F)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    }
    if constexpr (F == kFnBf16Scores) {
      // a key pair's two scores in one conversion (cvt.rn.bf16x2.f32),
      // the same rounding as one at a time
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float2 r = __bfloat1622float2(__floats2bfloat162_rn(s[j][e], s[j][e + 1]));
        s[j][e] = r.x;
        s[j][e + 1] = r.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (nvalid < MK && 8 * j + 2 * t + (e & 1) >= nvalid) s[j][e] = -INFINITY;
  }
}

// sweep 1 over one key tile: the running max m and this lane's part of
// the sum l of exp(s - m) of rows g (index 0) and g+8 (1); m is shared by
// the quad (__shfl_xor_sync), l is summed over it after the last tile
__device__ __forceinline__ void running_max_sum(const float (&s)[8][4], float (&m)[2],
                                                float (&l)[2], int nvalid) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * (j & ~1) >= nvalid) continue;
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);  // finite: the tile's first key is valid
    l[r] *= __expf(__fsub_rn(m[r], mn));
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * (j & ~1) >= nvalid) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e / 2] += __expf(__fsub_rn(s[j][e], m[e / 2]));
  }
}

// v2's sweep 1 over one key tile: this lane's running max of rows g
// (index 0) and g+8 (1), with no exp; the quad combines after the last
// tile
__device__ __forceinline__ void running_max(const float (&s)[8][4], float (&m)[2],
                                            int nvalid) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * (j & ~1) >= nvalid) continue;
    m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
    m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
  }
}

// acc (16 rows x HD columns: HD/8 mma tiles) += round_bf16(p) . V, with p
// formed from the S accumulators (rows g and g+8 of the lane: index 0 and
// 1) and fed as A fragments; V tile vs of row stride RB bytes. Exact
// functions: p = exp(s - m) * rl (rl = 1 / l). Deferred ones: p = e =
// exp(s - m) (kFnDeferredNoMax: exp(s)), unnormalised, each unrounded e
// added to this lane's row sum l
template <int HD, int RB, int F>
__device__ __forceinline__ void pv_mma(float (&acc)[HD / 8][4], const float (&s)[8][4],
                                       const float (&m)[2], const float (&rl)[2],
                                       float (&l)[2], const int8_t* vs, int voff,
                                       int nvalid) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= nvalid) continue;
    // A of the 16-key step kk: {row g, keys 2t..}, {row g+8, keys 2t..},
    // {row g, keys 8+2t..}, {row g+8, keys 8+2t..} = the C fragments of
    // the 8-key tiles 2kk and 2kk+1
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* c = s[2 * kk + h] + 2 * r;
        if constexpr (deferred(F)) {
          const float e0 = __expf(F == kFnDeferred ? __fsub_rn(c[0], m[r]) : c[0]);
          const float e1 = __expf(F == kFnDeferred ? __fsub_rn(c[1], m[r]) : c[1]);
          l[r] += e0 + e1;
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(e0, e1);
          a[2 * h + r] = *reinterpret_cast<const uint32_t*>(&p2);
        } else {
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(
              __fmul_rn(__expf(__fsub_rn(c[0], m[r])), rl[r]),
              __fmul_rn(__expf(__fsub_rn(c[1], m[r])), rl[r]));
          a[2 * h + r] = *reinterpret_cast<const uint32_t*>(&p2);
        }
      }
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      // V rows are keys: .trans gives the "col" B fragments of output
      // columns 16 np .. +7 (r[0..1]) and 16 np + 8 .. +15 (r[2..3])
      uint32_t r[4];
      bvt_int8::ldmatrix_x4_trans(r, vs + 16 * kk * RB + np * 32 + voff);
      bvt_int8::mma_bf16(acc[2 * np], a, r);
      bvt_int8::mma_bf16(acc[2 * np + 1], a, r + 2);
    }
  }
}

// grid: (ceil(seq / MQ), heads / (NH * NP), B / NR), MT * NP threads.
// The block walks its NG = NH * NR (head, batch row) groups in turn,
// group gi = r * NH + h being batch row blockIdx.z * NR + r and heads
// (blockIdx.y * NH + h) * NP .. +NP-1 side by side, warps MW i .. MW i +
// MW - 1 doing head i of them; #1 and #2 are NH = NR = NP = 1, the packed
// pair NP = 2, and the attention probes' v2 (F = kFnDeferred), v3
// (kFnDeferredNoMax), v4 (kFnBf16Scores), v5 (NH = H / 2) and v6 (NR = 2)
// take the same body (csrc/attention_variants.cu).
template <int HD, int S, int NH = 1, int NR = 1, int NP = 1, int F = kFnExact>
__global__ void
__launch_bounds__(MT * NP, mma_min_blocks(S, NP))
mha_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int seq, int heads, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(S == kOneBlock || S == kSplitKey, "one block a query tile");
  constexpr int NG = NH * NR;
  static_assert(NG >= 1 && (S == kOneBlock || NG == 1), "split-key takes one group");
  static_assert(NP == 1 || (NP == 2 && NG == 1 && S == kOneBlock),
                "heads side by side: one-block, one group");
  static_assert(F >= kFnExact && F <= kFnDeferredNoMax, "no such function");
  constexpr int RB = mma_row_bytes(NP * HD);  // a K or V tile row: NP heads
  constexpr int TILE = MK * RB;       // bytes of one K or V tile
  constexpr int NO = HD / 8;          // 8-column output tiles
  constexpr bool kSplit = S == kSplitKey;
  // (named apart from the other headers' extern shared arrays)
  extern __shared__ __align__(16) int8_t attn_mma_smem[];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // the warp's head among the NP side by side, and its 16-row slice
  const int wh = NP == 1 ? 0 : warp / MW, wr = NP == 1 ? warp : warp % MW;
  const int ht = NP == 1 ? threadIdx.x : threadIdx.x % MT;  // thread in its half
  const int g = lane / 4, t = lane % 4;    // fragment row group, lane in quad
  const int lq = lane / 8, lr = lane % 8;  // ldmatrix matrix and row of this lane
  // trans-B (V): matrices (keys 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15); B (K): (keys 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15); both in the warp's head's columns
  const int voff = (lr + (lq & 1) * 8) * RB + (lq >> 1) * 16 + wh * 2 * HD;
  const int koff = (lr + (lq >> 1) * 8) * RB + (lq & 1) * 16 + wh * 2 * HD;
  const int q0 = blockIdx.x * MQ;
  const long D = (long)heads * HD;
  // the element offset of group gi's rows and first head's columns (the
  // warp's head: + wh * HD)
  auto group_base = [&](int gi) {
    return (long)(blockIdx.z * NR + gi / NH) * seq * D +
           (long)((blockIdx.y * NH + gi % NH) * NP) * HD;
  };
  const int nt = (seq + MK - 1) / MK;      // key tiles
  // sweep-1 steps, two K tiles each (v3 has no max: no sweep 1)
  const int n1 = F == kFnDeferredNoMax ? 0 : (nt + 1) / 2;
  const int per = n1 + nt;                 // steps of one group
  const int t_main = kSplit ? seq / kSplitTile * kSplitTile : 0;
  const bool active = q0 + 16 * wr < seq;  // warp-uniform
  // the ring's barrier: the block's, or the half's with heads side by side
  auto sync = [&]() {
    if constexpr (NP == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(1 + wh), "n"(MT) : "memory");
  };

  // global step s is step s % per of group s / per: step i < n1 sweeps 1
  // over K tiles 2i and 2i+1, step n1 + i sweeps 2 over K and V tile i.
  // Stage s % MSTAGES holds a step's two tiles, so the ring runs on across
  // a group boundary: the next group's first tiles are copied while this
  // group's last step computes. Each half copies its own head's columns.
  auto fetch = [&](int gs) {
    const int gi = NG == 1 ? 0 : gs / per, step = gs - gi * per;
    const long base = group_base(gi) + wh * HD;
    int8_t* st = attn_mma_smem + (gs % MSTAGES) * 2 * TILE + wh * 2 * HD;
    if (step < n1) {
      load_rows_async<HD, RB>(st, k, base, D, 2 * step * MK, seq, ht);
      if (2 * step + 1 < nt)
        load_rows_async<HD, RB>(st + TILE, k, base, D, (2 * step + 1) * MK, seq, ht);
    } else {
      load_rows_async<HD, RB>(st, k, base, D, (step - n1) * MK, seq, ht);
      load_rows_async<HD, RB>(st + TILE, v, base, D, (step - n1) * MK, seq, ht);
    }
  };
  // one commit group a step (empty past the end), so that step i's group
  // is complete once MSTAGES - 2 are pending
#pragma unroll
  for (int s = 0; s < MSTAGES - 1; ++s) {
    if (s < NG * per) fetch(s);
    bvt_int8::cp_async_commit();
  }

  uint32_t qf[HD / 16][4];
  if (active)
    load_q_frags<HD, deferred(F)>(qf, q, group_base(0) + wh * HD, D, q0 + 16 * wr, seq, g,
                                  t, scale);
  float m[2] = {-INFINITY, -INFINITY};  // rows g, g+8: running max, then final
  float l[2] = {0.f, 0.f};              // this lane's part of the sum, then all
  float rl[2] = {0.f, 0.f};             // 1 / l, after sweep 1
  float acc[NO][4], rest[kSplit ? NO : 1][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = rest[kSplit ? j : 0][e] = 0.f;

  // the group's output rows, rounded to bf16 from the accumulators: the
  // four lanes of a quad write 16 contiguous bytes of one row
  auto store = [&](int gi) {
    if constexpr (deferred(F)) {
      // the quad's row sums of the unrounded e: o = acc / den
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
    }
    const long base = group_base(gi) + wh * HD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * wr + g + 8 * h;
      if (row >= seq) continue;
      __nv_bfloat16* orow = o + base + (long)row * D;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        float x0 = acc[j][2 * h], x1 = acc[j][2 * h + 1];
        if constexpr (kSplit) {
          x0 = __fadd_rn(x0, rest[j][2 * h]);
          x1 = __fadd_rn(x1, rest[j][2 * h + 1]);
        }
        if constexpr (deferred(F)) {
          x0 = __fdiv_rn(x0, l[h]);
          x1 = __fdiv_rn(x1, l[h]);
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  };

  for (int gs = 0; gs < NG * per; ++gs) {
    bvt_int8::cp_async_wait<MSTAGES - 2>();
    sync();
    // refill the stage read in step gs - 1: every thread is past it
    if (gs + MSTAGES - 1 < NG * per) fetch(gs + MSTAGES - 1);
    bvt_int8::cp_async_commit();
    if (!active) continue;
    const int gi = NG == 1 ? 0 : gs / per, step = gs - gi * per;
    const int8_t* st = attn_mma_smem + (gs % MSTAGES) * 2 * TILE;
    float s[8][4];
    if (step < n1) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tile = 2 * step + u;
        if (tile >= nt) break;
        const int nvalid = min(MK, seq - tile * MK);
        qk_mma<HD, RB, F>(s, qf, st + u * TILE, koff, nvalid, scale, t);
        if constexpr (deferred(F))
          running_max(s, m, nvalid);
        else
          running_max_sum(s, m, l, nvalid);
      }
      if (step == n1 - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (deferred(F)) {
            m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
            m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
          } else {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            rl[r] = __frcp_rn(l[r]);
          }
        }
      }
      continue;
    }
    const int j0 = (step - n1) * MK;
    const int nvalid = min(MK, seq - j0);
    qk_mma<HD, RB, F>(s, qf, st, koff, nvalid, scale, t);
    if constexpr (kSplit) {
      if (j0 >= t_main) {
        pv_mma<HD, RB, F>(rest, s, m, rl, l, st + TILE, voff, nvalid);
        continue;
      }
    }
    pv_mma<HD, RB, F>(acc, s, m, rl, l, st + TILE, voff, nvalid);
    if constexpr (NG > 1) {
      // a group's last step: its output, then the next group's state from
      // scratch and its Q fragments (their load runs under the next
      // step's barrier)
      if (step == per - 1 && gi < NG - 1) {
        store(gi);
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = rl[0] = rl[1] = 0.f;
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        load_q_frags<HD, deferred(F)>(qf, q, group_base(gi + 1) + wh * HD, D, q0 + 16 * wr,
                                      seq, g, t, scale);
      }
    }
  }

  if (active) store(NG - 1);
}

// -- the launcher: one body for each (dtype, schedule, head dim) -----------

// bf16 runs every schedule on the tensor cores; fp32 keeps the CUDA-core
// body of attention.cuh (the tensor cores would round it to TF32)
template <typename T>
__host__ __device__ constexpr bool uses_mma() {
  return std::is_same<T, __nv_bfloat16>::value;
}

template <typename T>
using AttnFn = void (*)(const T*, const T*, const T*, T*, int, int, float);

// the kernel a launch takes, its threads, the heads a block serves (grid
// y: heads / heads) and its dynamic shared memory
template <typename T>
struct Plan {
  AttnFn<T> fn = nullptr;
  int threads = 0;
  int heads = 1;
  long bytes = 0;
};

// the packed pair on the tensor cores: the one-block body with its two
// heads side by side (NP = 2)
template <typename T, int HD, int S>
Plan<T> plan_head_dim(int seq) {
  Plan<T> p;
  p.heads = heads_per_block(S);
  if constexpr (uses_mma<T>()) {
    constexpr int NP = heads_per_block(S);
    p.fn = mha_mma_kernel<HD, S == kSplitKey ? kSplitKey : kOneBlock, 1, 1, NP>;
    p.threads = MT * NP;
    p.bytes = mma_smem_bytes(NP * HD);
  } else {
    p.fn = mha_kernel<T, HD, S>;
    p.threads = NT;
    p.bytes = smem_floats(S, seq, HD) * (long)sizeof(float);
  }
  return p;
}

// head dims: the tiny test towers (16), CLIP B/L and SigLIP (64), CLIP H (80)
template <typename T, int S>
Plan<T> plan(int head_dim, int seq) {
  switch (head_dim) {
    case 16: return plan_head_dim<T, 16, S>(seq);
    case 64: return plan_head_dim<T, 64, S>(seq);
    case 80: return plan_head_dim<T, 80, S>(seq);
    default: return Plan<T>();
  }
}

// the plan's kernel opted in to its shared memory, or an error (a plan:
// fn, threads, bytes; also the attention probes' plans)
template <typename P>
cudaError_t prepare(const P& p) {
  if (p.fn == nullptr) return cudaErrorInvalidValue;
  const int optin = smem_optin();
  if (optin < 0) return static_cast<cudaError_t>(-optin);
  if (p.bytes > optin) return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opted in
  return cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p.bytes);
}

template <typename T, int S>
cudaError_t launch_head_dim(const void* q, const void* k, const void* v, void* o,
                            int B, int seq, int heads, int head_dim, float scale,
                            cudaStream_t stream) {
  const Plan<T> p = plan<T, S>(head_dim, seq);
  const cudaError_t err = prepare(p);
  if (err != cudaSuccess) return err;
  if (heads % p.heads != 0) return cudaErrorInvalidValue;
  const dim3 grid((seq + BQ - 1) / BQ, heads / p.heads, B);
  p.fn<<<grid, p.threads, p.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, heads, scale);
  return cudaGetLastError();
}

// registers a thread and blocks an SM of a plan's kernel
template <typename P>
cudaError_t plan_occupancy(const P& p, int* regs, int* blocks) {
  cudaError_t err = prepare(p);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, p.fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, p.fn, p.threads,
                                                        (size_t)p.bytes);
  if (err == cudaSuccess) *regs = attr.numRegs;
  return err;
}

// registers a thread and blocks an SM of the kernel a launch takes
template <typename T, int S>
cudaError_t occupancy(int head_dim, int seq, int* regs, int* blocks) {
  return plan_occupancy(plan<T, S>(head_dim, seq), regs, blocks);
}

}  // namespace bvt_attn
