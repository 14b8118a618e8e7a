// Fused non-causal multi-head self-attention: the kernel shared by
// csrc/attention.cu (its three schedules) and csrc/attention_block.cu
// (the attention core of the whole pre-LN sublayer).
//
// Replaces the TPU kernels `_mha_kernel`, `_mha_split_kernel` and
// `_mha_packed_kernel` of bayesvlm_tpu/models/attention_pallas.py (called
// through `fused_attention`). All three compute one function with the
// same rounding points:
//
//   per head h:  s = (q_h . k_h^T) accumulated in fp32, then * scale
//                    (scale = 1/sqrt(Dh), applied AFTER the dot)
//                p = exact fp32 softmax over the keys, rounded to the
//                    input dtype
//                o_h = p . v_h accumulated in fp32, rounded to the
//                    output dtype
//
// on packed-head q, k, v, o: [B, T, H*Dh] (head h is the column slice
// h*Dh .. h*Dh+Dh-1). The [B, H, T, T] scores never reach device memory.
//
// Design (first, simple version). One block of 256 threads per (query
// tile of BQ=64 rows, head or head pair, batch row):
//   1. the Q tile goes to shared memory as fp32;
//   2. pass 1 walks K in tiles of BK=64 keys and writes the tile's fp32
//      scores for ALL T keys to shared memory (key-major, [T][BQ+4]);
//   3. each query row's max and sum are taken over shared memory, then
//      p = exp(s - max) / sum is rounded to the input dtype in place;
//   4. pass 2 walks V in tiles of BK keys and accumulates p.v in fp32
//      registers (each thread owns 4 rows x Dh/16 columns of a head).
// The two-pass layout reproduces the TPU kernel's rounding exactly; an
// online (flash) softmax would round p at other points.
//
// The schedules (one template parameter, one instantiation each):
//   kOneBlock    (`_mha_kernel`) every key tile is bounds-checked.
//   kSplitKey    (`_mha_split_kernel`) keys split into t_main = 128 *
//                floor(T / 128) and a remainder of r = T - t_main. The
//                main loops walk t_main in whole tiles with no bounds
//                checks; the remainder's scores come from a short
//                rank-r pass (one dot per query row and key) into the
//                same score tile, so one softmax covers both; pv is the
//                main sum plus the remainder's, added in fp32 and
//                rounded once. The caller takes kOneBlock when t_main or
//                r is 0, as the JAX package does.
//   kPackedPair  (`_mha_packed_kernel`) one block serves a head pair: q,
//                k and v are read as 2*Dh contiguous columns, both
//                heads' scores land in one [2T]-wide tile (head A keys 0
//                .. T-1, head B keys T .. 2T-1), and the softmax keeps a
//                max and a normaliser per head segment. The TPU's
//                block-diagonal K'/V' contribute exact zeros off the
//                diagonal; here those products are not computed. The
//                score tile doubles: at T=257, Dh=64 the block takes 203
//                KB of shared memory, one block per SM.
//
// What bounds it on an H100: all dot products run as fp32 FMAs on the
// CUDA cores, each fed by shared-memory loads (8 loads per 16 FMAs in
// pass 1, 5 per 16 in pass 2), so shared-memory bandwidth and the
// softmax's passes over the [T, BQ] score tile bound it, far below the
// tensor-core roofline (at ViT-L, T=257, the attention is 4*B*H*T^2*Dh
// = 17.3 GFLOP per layer at B=64, and the bytes it must move are tiny).
// What the design does about it: scores stay in shared memory (no HBM
// round trip), the smem layouts are padded so every warp-wide load is
// conflict-free or a broadcast, and two blocks fit on one SM at T=257
// (one for the packed pair). The next step is mma.sync / wgmma on bf16
// operands for the two dots.
//
// The ragged edge (T = 257 or 50 is no multiple of 64) is masked here:
// query rows >= T are computed on zeros and never written, keys >= T
// are never stored as scores and never read in pass 2.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace bvt_attn {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per K/V tile
constexpr int NT = 256;           // threads per block: 16 (tx) x 16 (ty)
constexpr int SP = BQ + 4;        // row stride of the score tile (floats)
constexpr int PARTS = NT / BQ;    // threads per query row in the softmax
constexpr int kSplitTile = 128;   // split-key: t_main is a multiple of this

enum Schedule { kOneBlock = 0, kSplitKey = 1, kPackedPair = 2 };

// heads one block serves
__host__ __device__ constexpr int heads_per_block(int schedule) {
  return schedule == kPackedPair ? 2 : 1;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// shared memory of one block, in floats: Q tile and K/V tile (row stride
// NH*HD+1 keeps column reads conflict-free), softmax partials, and NH
// score tiles
__host__ __device__ constexpr long smem_floats(int schedule, int T, int HD) {
  const long nh = heads_per_block(schedule);
  return (long)(BQ + BK) * (nh * HD + 1) + nh * PARTS * BQ + nh * T * (long)SP;
}

// rows j0 .. j0+BK-1 of the W columns at `base` (row stride D) of k or v,
// as fp32, into kv (row stride W + 1); with kChecked, rows at or past
// seq read as zero, without it every row is taken to exist
template <typename T, int W, bool kChecked>
__device__ __forceinline__ void load_kv(float* kv, const T* __restrict__ src,
                                        long base, long D, int j0, int seq) {
  for (int idx = threadIdx.x; idx < BK * W; idx += NT) {
    const int j = idx / W, d = idx % W;
    kv[j * (W + 1) + d] =
        !kChecked || j0 + j < seq ? to_f(src[base + (j0 + j) * D + d]) : 0.f;
  }
}

// fp32 scores of the BQ query rows against keys j0 .. j0+BK-1 of one
// head (qs and kv point at the head's first column, row stride HP),
// scaled after the dot, into the head's key-major score tile st
template <int HD, int HP, bool kChecked>
__device__ __forceinline__ void qk_tile(const float* qs, const float* kv, float* st,
                                        int j0, int seq, float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = qs[(ty * 4 + r) * HP + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = kv[(tx + 16 * c) * HP + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + tx + 16 * c;
    if (!kChecked || j < seq) {
      *reinterpret_cast<float4*>(&st[j * SP + ty * 4]) =
          make_float4(acc[0][c] * scale, acc[1][c] * scale,
                      acc[2][c] * scale, acc[3][c] * scale);
    }
  }
}

// the split-key remainder: scores of the BQ query rows against the jn
// keys j0 .. j0+jn-1 held in kv, one dot per (row, key) pair, summed in
// qk_tile's order (so a key's score does not depend on the pass)
template <int HD, int HP>
__device__ __forceinline__ void qk_rest(const float* qs, const float* kv, float* st,
                                        int j0, int jn, float scale) {
  for (int idx = threadIdx.x; idx < BQ * jn; idx += NT) {
    const int i = idx % BQ, j = idx / BQ;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) s = fmaf(qs[i * HP + d], kv[j * HP + d], s);
    st[(j0 + j) * SP + i] = s * scale;
  }
}

// exact softmax per query row over each of the NH heads' n keys (head h's
// tile at st + h*n*SP): PARTS threads share a row and stride over its
// keys; their maxima and sums meet in red ([NH][PARTS][BQ]); p is
// rounded to T in place
template <typename T, int NH>
__device__ __forceinline__ void softmax_rows(float* st, int n, float* red) {
  const int i = threadIdx.x % BQ, part = threadIdx.x / BQ;
  float m[NH], s[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float* sh = st + (long)h * n * SP;
    m[h] = -INFINITY;
    for (int j = part; j < n; j += PARTS) m[h] = fmaxf(m[h], sh[j * SP + i]);
    red[(h * PARTS + part) * BQ + i] = m[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float* sh = st + (long)h * n * SP;
    m[h] = red[h * PARTS * BQ + i];
#pragma unroll
    for (int p = 1; p < PARTS; ++p) m[h] = fmaxf(m[h], red[(h * PARTS + p) * BQ + i]);
    s[h] = 0.f;
    for (int j = part; j < n; j += PARTS) {
      const float e = expf(sh[j * SP + i] - m[h]);
      sh[j * SP + i] = e;
      s[h] += e;
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < NH; ++h) red[(h * PARTS + part) * BQ + i] = s[h];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float* sh = st + (long)h * n * SP;
    s[h] = red[h * PARTS * BQ + i];
#pragma unroll
    for (int p = 1; p < PARTS; ++p) s[h] += red[(h * PARTS + p) * BQ + i];
    for (int j = part; j < n; j += PARTS)
      sh[j * SP + i] = to_f(from_f<T>(sh[j * SP + i] / s[h]));
  }
}

// acc (this thread's 4 query rows x HD/16 columns tx + 16c of one head)
// += p . v over the keys j0 .. j0+jn-1 held in kv (the head's first
// column, row stride HP); kFull: jn = BK, known at compile time
template <int HD, int HP, bool kFull>
__device__ __forceinline__ void pv_tile(const float* st, const float* kv,
                                        float (&acc)[4][HD / 16], int j0, int jn) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n = kFull ? BK : jn;
  for (int j = 0; j < n; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(&st[(j0 + j) * SP + ty * 4]);
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float x = kv[j * HP + tx + 16 * c];
      acc[0][c] = fmaf(p.x, x, acc[0][c]);
      acc[1][c] = fmaf(p.y, x, acc[1][c]);
      acc[2][c] = fmaf(p.z, x, acc[2][c]);
      acc[3][c] = fmaf(p.w, x, acc[3][c]);
    }
  }
}

// grid: (ceil(seq / BQ), heads / heads_per_block(S), B)
template <typename T, int HD, int S>
__global__ void __launch_bounds__(NT)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int seq, int heads,
           float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int NH = heads_per_block(S);
  constexpr int W = NH * HD;      // columns of q, k, v one block reads
  constexpr int HP = W + 1;
  constexpr int TN = HD / 16;     // output columns per thread and head
  // (named apart from the GEMM headers' byte arrays: extern shared
  // arrays of one name must share one type within a source)
  extern __shared__ float attn_smem[];
  float* qs = attn_smem;          // [BQ][HP]
  float* kv = qs + BQ * HP;       // [BK][HP]
  float* red = kv + BK * HP;      // [NH][PARTS][BQ]
  float* st = red + NH * PARTS * BQ;  // NH x [seq][SP], key-major; 16-byte aligned

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long D = (long)heads * HD;
  const long base = (long)blockIdx.z * seq * D + (long)blockIdx.y * W;

  for (int idx = tid; idx < BQ * W; idx += NT) {
    const int i = idx / W, d = idx % W;
    const int t = q0 + i;
    qs[i * HP + d] = t < seq ? to_f(q[base + t * D + d]) : 0.f;
  }

  // pass 1: fp32 scores of the BQ query rows against every key
  const int t_main = S == kSplitKey ? seq / kSplitTile * kSplitTile : 0;
  if constexpr (S == kSplitKey) {
    for (int j0 = 0; j0 < t_main; j0 += BK) {
      __syncthreads();
      load_kv<T, W, false>(kv, k, base, D, j0, seq);
      __syncthreads();
      qk_tile<HD, HP, false>(qs, kv, st, j0, seq, scale);
    }
    for (int j0 = t_main; j0 < seq; j0 += BK) {
      __syncthreads();
      load_kv<T, W, true>(kv, k, base, D, j0, seq);
      __syncthreads();
      qk_rest<HD, HP>(qs, kv, st, j0, min(BK, seq - j0), scale);
    }
  } else {
    for (int j0 = 0; j0 < seq; j0 += BK) {
      __syncthreads();
      load_kv<T, W, true>(kv, k, base, D, j0, seq);
      __syncthreads();
#pragma unroll
      for (int h = 0; h < NH; ++h)
        qk_tile<HD, HP, true>(qs + h * HD, kv + h * HD, st + (long)h * seq * SP, j0,
                              seq, scale);
    }
  }
  __syncthreads();
  softmax_rows<T, NH>(st, seq, red);

  // pass 2: o = p . v in fp32
  float acc[NH][4][TN] = {};
  if constexpr (S == kSplitKey) {
    for (int j0 = 0; j0 < t_main; j0 += BK) {
      __syncthreads();
      load_kv<T, W, false>(kv, v, base, D, j0, seq);
      __syncthreads();
      pv_tile<HD, HP, true>(st, kv, acc[0], j0, BK);
    }
    float rest[4][TN] = {};
    for (int j0 = t_main; j0 < seq; j0 += BK) {
      __syncthreads();
      load_kv<T, W, true>(kv, v, base, D, j0, seq);
      __syncthreads();
      pv_tile<HD, HP, false>(st, kv, rest, j0, min(BK, seq - j0));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[0][r][c] += rest[r][c];
  } else {
    for (int j0 = 0; j0 < seq; j0 += BK) {
      __syncthreads();
      load_kv<T, W, true>(kv, v, base, D, j0, seq);
      __syncthreads();
#pragma unroll
      for (int h = 0; h < NH; ++h)
        pv_tile<HD, HP, false>(st + (long)h * seq * SP, kv + h * HD, acc[h], j0,
                               min(BK, seq - j0));
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = q0 + ty * 4 + r;
      if (t < seq) {
#pragma unroll
        for (int c = 0; c < TN; ++c)
          o[base + t * D + h * HD + tx + 16 * c] = from_f<T>(acc[h][r][c]);
      }
    }
  }
}

// the most dynamic shared memory a block of the current device may opt
// in to, or a negative cudaError_t
inline int smem_optin() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? optin : -static_cast<int>(err);
}

template <typename T, int HD, int S>
cudaError_t launch_mha(const T* q, const T* k, const T* v, T* o, int B, int seq,
                       int heads, float scale, cudaStream_t stream) {
  constexpr int NH = heads_per_block(S);
  if (heads % NH != 0) return cudaErrorInvalidValue;
  const long bytes = smem_floats(S, seq, HD) * (long)sizeof(float);
  const int optin = smem_optin();
  if (optin < 0) return static_cast<cudaError_t>(-optin);
  if (bytes > optin) return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opted in
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<T, HD, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, heads / NH, B);
  mha_kernel<T, HD, S><<<grid, NT, bytes, stream>>>(q, k, v, o, seq, heads, scale);
  return cudaGetLastError();
}

// head dims: the tiny test towers (16), CLIP B/L and SigLIP (64), CLIP H (80)
template <typename T, int S>
cudaError_t launch_head_dim(const void* q, const void* k, const void* v, void* o,
                            int B, int seq, int heads, int head_dim, float scale,
                            cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (head_dim) {
    case 16: return launch_mha<T, 16, S>(qt, kt, vt, ot, B, seq, heads, scale, stream);
    case 64: return launch_mha<T, 64, S>(qt, kt, vt, ot, B, seq, heads, scale, stream);
    case 80: return launch_mha<T, 80, S>(qt, kt, vt, ot, B, seq, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bvt_attn
