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
//     fp32 sum once, after the dot, as the TPU body does (q is not
//     pre-scaled).
//     Design: a block owns 64 query rows of one head (or pair) and walks
//     the keys 64 at a time through a cp.async double buffer; 4 warps of
//     16 rows, bf16 operands through ldmatrix into mma.sync m16n8k16 with
//     fp32 accumulators. The packed instantiation contracts over 128, as
//     the TPU body does: its key tile is built block-diagonal in shared
//     memory, the zero half written by cp.async's zero-fill (never read
//     from device memory), and every mma of the zero half runs. Whether
//     the card pays for that half is the probe's question, so nothing
//     skips it. The fp32 tile is staged in shared memory and written
//     row by row, 32 lanes on 128 contiguous bytes with 4-byte stores: a
//     score row is 1,028 B (per head, only 4-byte aligned) or 2,056 B
//     (packed), so no wider store is safe.
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
//     o differs from the fp32 product only by the order of the fp32 sums:
//     three mma.sync m16n8k16 a fragment (lo, mid, hi). p's fragments are
//     read from an fp32 shared tile (64-bit loads, a row stride of 40
//     floats so a half-warp hits 32 banks) and split in registers; v
//     reaches the col-major B fragment through ldmatrix.trans. Keys walk
//     32 at a time through a cp.async double buffer (4-byte copies for p,
//     whose rows are only 4-byte aligned). The packed instantiation builds
//     V' block-diagonal in shared memory (cp.async zero-fill) and runs the
//     zero half's mma too.
//
// What bounds them on an H100: the fp32 score or probability tensor.
// At the probe's B=80, T=257, H=16 it is 338,170,880 B, and each kernel
// moves it once plus 84,213,760 B of bf16 operands: 0.126 ms at 3.35
// TB/s. The operations (2 B H T^2 64 products per head; twice that
// packed, and three bf16 passes for pv) need 0.011-0.066 ms at the bf16
// tensor rate, so all four are bound by bytes.
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

constexpr int DH = 64;          // head dim
constexpr int BQ = 64;          // query rows a block
constexpr int NT = 128;         // threads: 4 warps of 16 query rows
constexpr int QK_BK = 64;       // qk: keys a tile
constexpr int QK_SO = QK_BK + 8;  // qk: staged fp32 tile row stride (floats)
constexpr int PV_BK = 32;       // pv: keys a tile
constexpr int PV_SP = PV_BK + 8;  // pv: fp32 p tile row stride (floats)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
}

// -- (a) scores ----------------------------------------------------------

template <bool kPacked> struct Qk {
  static constexpr int kDepth = kPacked ? 2 * DH : DH;  // contraction
  static constexpr int kRowB = kDepth * 2 + 16;          // q/k tile row bytes
  static constexpr int kChunks = kDepth * 2 / 16;        // 16-byte chunks a row
  static constexpr int kSmem = (BQ + 2 * QK_BK) * kRowB + BQ * QK_SO * 4;
};

// the key tile j0 .. j0+QK_BK-1 (of T keys, or of Kp's 2T rows) into dst;
// rows past the end, and Kp's zero half, are zero-filled
template <bool kPacked>
__device__ __forceinline__ void load_keys(int8_t* dst, const int8_t* kb, int j0, int T,
                                          int D, int hg) {
  using S = Qk<kPacked>;
  const int nkeys = kPacked ? 2 * T : T;
  for (int c = threadIdx.x; c < QK_BK * S::kChunks; c += NT) {
    const int r = c / S::kChunks, kc = (c % S::kChunks) * 16;
    const int j = j0 + r;
    bool ok = j < nkeys;
    int key = j, head = hg;
    if (kPacked) {
      const int half = kc / (DH * 2), side = j >= T;  // lanes 64:128 <-> rows T:2T
      ok = ok && half == side;
      key = j - side * T;
      head = 2 * hg + half;
    }
    const int8_t* src = kb + ((long)key * D + head * DH) * 2 + kc % (DH * 2);
    cp_async16(dst + r * S::kRowB + kc, ok ? src : kb, ok ? 16 : 0);
  }
}

// grid: (ceil(T / BQ), H (or H / 2 pairs), B)
template <bool kPacked>
__global__ void __launch_bounds__(NT)
qk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          float* __restrict__ s, int T, int H, float scale) {
  using S = Qk<kPacked>;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* qs = smem;                                   // [BQ][kRowB]
  int8_t* ks = qs + BQ * S::kRowB;                     // 2 x [QK_BK][kRowB]
  float* st = reinterpret_cast<float*>(ks + 2 * QK_BK * S::kRowB);  // [BQ][QK_SO]

  const int D = H * DH, nkeys = kPacked ? 2 * T : T, groups = kPacked ? H / 2 : H;
  const int hg = blockIdx.y, q0 = blockIdx.x * BQ;
  const long b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, lq = lane / 8, lr = lane % 8;
  // this lane's ldmatrix row and byte offset (see csrc/int8_gemm.cuh)
  const int a_off = (lr + (lq & 1) * 8) * S::kRowB + (lq >> 1) * 16;
  const int b_off = (lr + (lq >> 1) * 8) * S::kRowB + (lq & 1) * 16;
  const int8_t* qb = reinterpret_cast<const int8_t*>(q + b * T * D + hg * S::kDepth);
  const int8_t* kb = reinterpret_cast<const int8_t*>(k + b * T * D);

  for (int c = threadIdx.x; c < BQ * S::kChunks; c += NT) {
    const int r = c / S::kChunks, kc = (c % S::kChunks) * 16;
    const bool ok = q0 + r < T;
    cp_async16(qs + r * S::kRowB + kc, ok ? qb + (long)(q0 + r) * D * 2 + kc : qb,
               ok ? 16 : 0);
  }
  load_keys<kPacked>(ks, kb, 0, T, D, hg);
  cp_async_commit();

  const int ntiles = (nkeys + QK_BK - 1) / QK_BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    // the next tile goes to the buffer read in step kt-1: the barrier
    // after that step's products has passed
    if (kt + 1 < ntiles)
      load_keys<kPacked>(ks + ((kt + 1) & 1) * QK_BK * S::kRowB, kb, (kt + 1) * QK_BK, T,
                         D, hg);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt is in, and st is free again
    const int8_t* kt_s = ks + (kt & 1) * QK_BK * S::kRowB;
    float acc[QK_BK / 8][4];
#pragma unroll
    for (int j = 0; j < QK_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < S::kDepth * 2; kk += 32) {
      uint32_t af[4];
      ldmatrix_x4(af, qs + warp * 16 * S::kRowB + kk + a_off);
#pragma unroll
      for (int j = 0; j < QK_BK / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, kt_s + j * 8 * S::kRowB + kk + b_off);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(acc[j], af, b0);
        mma_bf16(acc[j + 1], af, b1);
      }
    }
    // accumulator e of tile j: row g (+8 for e >= 2), key 2t + e % 2
#pragma unroll
    for (int j = 0; j < QK_BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* d = st + (warp * 16 + g + h * 8) * QK_SO + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(d) =
            make_float2(__fmul_rn(acc[j][2 * h], scale), __fmul_rn(acc[j][2 * h + 1], scale));
      }
    __syncthreads();
    const int j0 = kt * QK_BK, nk = min(QK_BK, nkeys - j0);
    for (int r = warp; r < BQ && q0 + r < T; r += NT / 32) {
      float* dst = s + (((b * groups + hg) * T) + q0 + r) * (long)nkeys + j0;
      for (int c = lane; c < nk; c += 32) dst[c] = st[r * QK_SO + c];
    }
  }
}

// -- (b) p . v -----------------------------------------------------------

template <bool kPacked> struct Pv {
  static constexpr int kWidth = kPacked ? 2 * DH : DH;  // output columns (V' width)
  static constexpr int kRowB = kWidth * 2 + 16;          // v tile row bytes
  static constexpr int kChunks = kWidth * 2 / 16;
  static constexpr int kPBytes = BQ * PV_SP * 4;
  static constexpr int kSmem = 2 * (kPBytes + PV_BK * kRowB);
};

// the p tile (rows q0.., keys j0..) and the v (or V') tile of keys j0..
// into stage dst; past the edges and V''s zero half, zero-filled
template <bool kPacked>
__device__ __forceinline__ void load_pv(int8_t* dst, const float* pb, const int8_t* vb,
                                        int q0, int j0, int T, int D, int hg) {
  using S = Pv<kPacked>;
  const int nkeys = kPacked ? 2 * T : T;
  float* ps = reinterpret_cast<float*>(dst);
  for (int c = threadIdx.x; c < BQ * PV_BK; c += NT) {
    const int r = c / PV_BK, col = c % PV_BK;
    const bool ok = q0 + r < T && j0 + col < nkeys;
    cp_async4(ps + r * PV_SP + col, ok ? pb + (long)(q0 + r) * nkeys + j0 + col : pb,
              ok ? 4 : 0);
  }
  int8_t* vs = dst + S::kPBytes;
  for (int c = threadIdx.x; c < PV_BK * S::kChunks; c += NT) {
    const int r = c / S::kChunks, kc = (c % S::kChunks) * 16;
    const int j = j0 + r;
    bool ok = j < nkeys;
    int key = j, head = hg;
    if (kPacked) {
      const int half = kc / (DH * 2), side = j >= T;
      ok = ok && half == side;
      key = j - side * T;
      head = 2 * hg + half;
    }
    const int8_t* src = vb + ((long)key * D + head * DH) * 2 + kc % (DH * 2);
    cp_async16(vs + r * S::kRowB + kc, ok ? src : vb, ok ? 16 : 0);
  }
}

// fp32 (x, y) -> three bf16x2 parts (hi, mid, lo) with hi + mid + lo = (x, y)
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 r1 = make_float2(__fsub_rn(x.x, __low2float(h)), __fsub_rn(x.y, __high2float(h)));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r1.x, r1.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r1.x, __low2float(m)),
                                                 __fsub_rn(r1.y, __high2float(m)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// grid: (ceil(T / BQ), H (or H / 2 pairs), B)
template <bool kPacked>
__global__ void __launch_bounds__(NT)
pv_kernel(const float* __restrict__ p, const __nv_bfloat16* __restrict__ v,
          __nv_bfloat16* __restrict__ o, int T, int H) {
  using S = Pv<kPacked>;
  constexpr int NTILE = S::kWidth / 8;  // 8-column mma tiles a warp
  constexpr int STAGE = S::kPBytes + PV_BK * S::kRowB;
  extern __shared__ __align__(16) int8_t smem[];  // 2 x (p tile, v tile)

  const int D = H * DH, nkeys = kPacked ? 2 * T : T, groups = kPacked ? H / 2 : H;
  const int hg = blockIdx.y, q0 = blockIdx.x * BQ;
  const long b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, lq = lane / 8, lr = lane % 8;
  // ldmatrix.trans: matrices (keys 0-7, cols 0-7), (8-15, 0-7), (0-7,
  // 8-15), (8-15, 8-15) are b0, b1 of two 8-column tiles
  const int v_off = (lr + (lq & 1) * 8) * S::kRowB + (lq >> 1) * 16;
  const float* pb = p + (b * groups + hg) * (long)T * nkeys;
  const int8_t* vb = reinterpret_cast<const int8_t*>(v + b * T * D);

  float acc[NTILE][4];
#pragma unroll
  for (int j = 0; j < NTILE; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  load_pv<kPacked>(smem, pb, vb, q0, 0, T, D, hg);
  cp_async_commit();
  const int ntiles = (nkeys + PV_BK - 1) / PV_BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles)
      load_pv<kPacked>(smem + ((kt + 1) & 1) * STAGE, pb, vb, q0, (kt + 1) * PV_BK, T, D,
                       hg);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ps = reinterpret_cast<const float*>(smem + (kt & 1) * STAGE);
    const int8_t* vs = smem + (kt & 1) * STAGE + S::kPBytes;
#pragma unroll
    for (int ks = 0; ks < PV_BK; ks += 16) {
      // A fragment: rows g, g+8 of the warp's 16; keys 2t, 2t+1 and +8
      const float* pr = ps + (warp * 16 + g) * PV_SP + ks + 2 * t;
      uint32_t hi[4], mid[4], lo[4];
      split3(*reinterpret_cast<const float2*>(pr), hi[0], mid[0], lo[0]);
      split3(*reinterpret_cast<const float2*>(pr + 8 * PV_SP), hi[1], mid[1], lo[1]);
      split3(*reinterpret_cast<const float2*>(pr + 8), hi[2], mid[2], lo[2]);
      split3(*reinterpret_cast<const float2*>(pr + 8 * PV_SP + 8), hi[3], mid[3], lo[3]);
#pragma unroll
      for (int j = 0; j < NTILE; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + ks * S::kRowB + j * 16 + v_off);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(acc[j], lo, b0);
        mma_bf16(acc[j], mid, b0);
        mma_bf16(acc[j], hi, b0);
        mma_bf16(acc[j + 1], lo, b1);
        mma_bf16(acc[j + 1], mid, b1);
        mma_bf16(acc[j + 1], hi, b1);
      }
    }
    __syncthreads();  // every warp is past this stage before it is refilled
  }
  cp_async_wait<0>();

  // accumulator e of tile j: row g (+8 for e >= 2), column 8j + 2t + e % 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + h * 8;
    if (row >= T) continue;
    __nv_bfloat16* dst = o + (b * T + row) * D + hg * S::kWidth + 2 * t;
#pragma unroll
    for (int j = 0; j < NTILE; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// -- launch ----------------------------------------------------------------

enum Kernel { kQk = 0, kPv = 1 };

using QkFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, float*, int, int, float);
using PvFn = void (*)(const float*, const __nv_bfloat16*, __nv_bfloat16*, int, int);

const void* kernel_fn(int kernel, int packed) {
  if (kernel == kQk)
    return packed ? reinterpret_cast<const void*>(static_cast<QkFn>(qk_kernel<true>))
                  : reinterpret_cast<const void*>(static_cast<QkFn>(qk_kernel<false>));
  return packed ? reinterpret_cast<const void*>(static_cast<PvFn>(pv_kernel<true>))
                : reinterpret_cast<const void*>(static_cast<PvFn>(pv_kernel<false>));
}

int smem_bytes(int kernel, int packed) {
  if (kernel == kQk) return packed ? Qk<true>::kSmem : Qk<false>::kSmem;
  return packed ? Pv<true>::kSmem : Pv<false>::kSmem;
}

// the kernel opted in to its shared memory (above 48 KB a launch is
// refused unless it did)
cudaError_t prepare(int kernel, int packed) {
  return cudaFuncSetAttribute(kernel_fn(kernel, packed),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(kernel, packed));
}

bool shape_ok(int B, int T, int H, int packed) {
  return B >= 0 && T > 0 && H > 0 && (!packed || H % 2 == 0) && B <= 65535 &&
         H <= 65535;
}

}  // namespace

extern "C" {

// kernel: 0 scores (qk), 1 p . v; packed: 0 per head, 1 head pairs

// bytes of dynamic shared memory one block takes
long bvt_packed_heads_smem_bytes(int kernel, int packed) {
  return smem_bytes(kernel, packed);
}

// blocks of the kernel one SM holds at once (the occupancy calculator),
// or a negative cudaError_t
int bvt_packed_heads_blocks_per_sm(int kernel, int packed) {
  cudaError_t err = prepare(kernel, packed);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_fn(kernel, packed),
                                                        NT, smem_bytes(kernel, packed));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// q, k: [B, T, H*64] bf16 -> s: [B, H, T, T] fp32 (packed: [B, H/2, T, 2T]).
// Returns a cudaError_t (0 = launched).
int bvt_qk_scores(const void* q, const void* k, void* s, int B, int T, int H,
                  float scale, int packed, void* stream) {
  if (!shape_ok(B, T, H, packed)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = prepare(kQk, packed);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, packed ? H / 2 : H, B);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed)
    qk_kernel<true><<<grid, NT, Qk<true>::kSmem, st>>>(qq, kk, static_cast<float*>(s), T,
                                                      H, scale);
  else
    qk_kernel<false><<<grid, NT, Qk<false>::kSmem, st>>>(qq, kk, static_cast<float*>(s),
                                                        T, H, scale);
  return cudaGetLastError();
}

// p: [B, H, T, T] fp32 (packed: [B, H/2, T, 2T]), v: [B, T, H*64] bf16 ->
// o: [B, T, H*64] bf16. Returns a cudaError_t (0 = launched).
int bvt_pv(const void* p, const void* v, void* o, int B, int T, int H, int packed,
           void* stream) {
  if (!shape_ok(B, T, H, packed)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = prepare(kPv, packed);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, packed ? H / 2 : H, B);
  const auto* pp = static_cast<const float*>(p);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed)
    pv_kernel<true><<<grid, NT, Pv<true>::kSmem, st>>>(pp, vv, oo, T, H);
  else
    pv_kernel<false><<<grid, NT, Pv<false>::kSmem, st>>>(pp, vv, oo, T, H);
  return cudaGetLastError();
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
