// The attention-schedule probes of scripts/dev/, as Hopper kernels: each
// changes one thing of the one-block attention kernel (#1), so that a
// probe times that one change on the card beside #1 as it runs in bf16,
// on the tensor cores (csrc/attention_mma.cuh). v2, v3 and v4 change #1's
// function on #1's own bodies; v5 and v6 keep #1's function and body and
// change only the work one block holds. Packed-head q, k, v, o: [B, T,
// H*Dh], fp32 or bf16, Dh 16, 64, 80.
//
// (a) v2 replaces `_kernel_v2` (scripts/dev/bench_attn_variants.py:45;
//     v3 is the script's subtract_max=False). Its function, per head:
//       qs = round_in(fp32(q) * scale)       the scale moves into q
//       s  = fp32 sum qs . k                 no scale after the dot
//       e  = exp(s - max_row s)              v3: exp(s)
//       den = fp32 sum of the UNROUNDED e
//       p  = round_in(e)                     unnormalised
//       o  = round_out(fp32(sum p . v) / den)   a true division
//     bf16 takes #1's tensor-core body, mha_mma_kernel<HD, kOneBlock, 1, 1,
//     1, kFnDeferred> (v3: kFnDeferredNoMax): Q's fragments are scaled and
//     rounded as they are read, so the Q.K^T takes no scale; p = round(e)
//     feeds P.V straight from the S accumulators while each lane sums the
//     unrounded e, and the output is one division an element. v2 sweeps
//     the keys twice, the first for the row max alone (no exp); v3 has no
//     max and sweeps once, where #1 sweeps twice. 36,864 B at Dh = 64, 4
//     blocks an SM, any T; 0.86-0.87x and 0.59-0.61x #1 on an H100 (the
//     CUDA-core body they replace took 5.2-5.4x #1). fp32 keeps mha_v2_kernel<T, HD, kSubtractMax>
//     on #1's CUDA-core layout (the tensor cores would round fp32 to
//     TF32): the scale applied as the Q tile is loaded, a softmax pass
//     writing round(e) and the row sums, so #1's normalisation pass over
//     the [T, BQ] score tile becomes one division an output element;
//     104,208 B at T = 257, Dh = 64, two blocks an SM.
//
// (b) v4 replaces `_kernel_v4` (scripts/dev/bench_attn_variants2.py:46):
//       s = round_bf16(fp32(q . k) * scale)   bf16 whatever the input dtype
//       p = round_in(exp(s - max) / sum)      fp32 softmax of the bf16 s
//       o = round_out(fp32 sum p . v)
//     On the TPU the bf16 scores halved the VMEM score block. bf16 takes
//     #1's tensor-core body, mha_mma_kernel<HD, kOneBlock, 1, 1, 1,
//     kFnBf16Scores>, which keeps no score tile: each score is rounded to
//     bf16 after the scale in both sweeps over the keys (one packed
//     conversion a key pair a sweep), so the probe asks what the rounding
//     costs on the body that runs; 36,864 B at Dh = 64, 4 blocks an SM,
//     any T. fp32 takes #1's CUDA-core body with the rounding in its score
//     pass, mha_kernel<float, HD, kOneBlock, true>: #1's layout, an fp32
//     tile holding the bf16-rounded scores, 104,208 B at T = 257.
//
// (c) The group kernels replace `_kernel_v5` (bench_attn_variants2.py:68:
//     a (B, 2) grid, H/2 heads a program) with NH = H/2, NR = 1, and
//     `_kernel_v6` (bench_attn_variants3.py:37: 2 batch rows a program)
//     with NH = 1, NR = 2. Both compute exactly #1's function
//     (`_mha_kernel`, attention_pallas.py:199-222); only the work one
//     block holds differs: NG = NH * NR (head, batch row) groups, where
//     the TPU kept [NG, T, T] fp32 scores in VMEM.
//     bf16 takes #1's own tensor-core body, mha_mma_kernel<HD, kOneBlock,
//     NH, NR> of attention_mma.cuh: a block of 4 warps and one 64-row
//     query tile walks its NG groups in turn, each with #1's two sweeps
//     over the keys (Q fragments in registers, running max and sum, then
//     p rounded to bf16 once and P.V), with no score tile: 36,864 B at
//     Dh = 64 whatever T and NG, so any T runs. The step loop is indexed
//     over all NG groups, so the cp.async ring runs on across a group
//     boundary: the next group's first K tiles are in flight while this
//     group's last P.V step computes, and its Q fragments load under the
//     next barrier. Each warp does for its (head, row) exactly what a #1
//     warp does, so the result equals bf16 #1 bit for bit.
//     fp32 keeps mha_group_kernel<T, HD, NH, NR>, on #1's CUDA-core body
//     (the tensor cores would round fp32 to TF32): #1's one [T][68] fp32
//     score tile, whose 64 columns are NG groups of BQ = 4 floor(16 / NG)
//     query rows (v5: 8, v6: 32; a thread's 4 rows lie in one group, NG =
//     6 leaves 16 columns idle), K/V staged for all NG groups at once in
//     tiles of 64 / NG keys (at least 16): v6 takes 104,208 B at T = 257
//     (two blocks an SM), v5 120,848 B (one). Its dots, softmax and p . v
//     run in the order of #1's CUDA-core body, so it equals fp32 #1 bit
//     for bit.
//
// What bounds them on an H100 at the probes' B=80, T=257, H=16, Dh=64:
// the function moves 168.4 MB (0.050 ms at 3.35 TB/s) and does 21.65 G
// operations (0.022 ms at the bf16 tensor rate). The fp32 kernels run
// all dots as fp32 FMAs on the CUDA cores fed from shared memory, far
// from either bound. The bf16 kernels are bound as #1 is, by latency
// (each step's chain of cp.async wait and barrier, ldmatrix, mma,
// shuffles and exps): v4 adds conversions to that chain; v2 drops sweep
// 1's exps and shuffles, v3 sweep 1 itself (5 steps a block where #1
// takes 8 at T = 257); v5 and v6 change the grid: with 132 SMs x 4
// blocks, #1 launches 6,400 blocks (12.1 waves), v6 3,200 (6.06) and v5
// 800 (1.52), each block's pipeline running on through its groups. Each
// probe asks how much its change to #1 moves the time.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

using namespace bvt_attn;

enum Variant { kV2 = 0, kV3 = 1, kV4 = 2, kGroup = 3 };

// -- (a) v2 / v3 --------------------------------------------------------

// the deferred softmax over the [n][SP] tile: st becomes round_in(e),
// and red[0 .. BQ) the row sums of the unrounded e
template <typename T, bool kSubtractMax>
__device__ __forceinline__ void softmax_deferred(float* st, int n, float* red) {
  const int i = threadIdx.x % BQ, part = threadIdx.x / BQ;
  float m = 0.f;
  if constexpr (kSubtractMax) {
    m = -INFINITY;
    for (int j = part; j < n; j += PARTS) m = fmaxf(m, st[j * SP + i]);
    red[part * BQ + i] = m;
    __syncthreads();
    m = red[i];
#pragma unroll
    for (int p = 1; p < PARTS; ++p) m = fmaxf(m, red[p * BQ + i]);
  }
  float s = 0.f;
  for (int j = part; j < n; j += PARTS) {
    const float e = expf(st[j * SP + i] - m);
    st[j * SP + i] = to_f(from_f<T>(e));
    s += e;
  }
  if constexpr (kSubtractMax) __syncthreads();  // every thread has read the maxima
  red[part * BQ + i] = s;
  __syncthreads();
  s = red[i];
#pragma unroll
  for (int p = 1; p < PARTS; ++p) s += red[p * BQ + i];
  __syncthreads();  // every thread has read the partial sums
  if (part == 0) red[i] = s;
}

// grid: (ceil(seq / BQ), heads, B)
template <typename T, int HD, bool kSubtractMax>
__global__ void __launch_bounds__(NT)
mha_v2_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int seq, int heads,
              float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int HP = HD + 1, TN = HD / 16;
  extern __shared__ float attn_smem[];
  float* qs = attn_smem;           // [BQ][HP]
  float* kv = qs + BQ * HP;        // [BK][HP]
  float* red = kv + BK * HP;       // [PARTS][BQ]; then the row sums
  float* st = red + PARTS * BQ;    // [seq][SP], key-major

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long D = (long)heads * HD;
  const long base = (long)blockIdx.z * seq * D + (long)blockIdx.y * HD;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int i = idx / HD, d = idx % HD;
    const int t = q0 + i;
    qs[i * HP + d] = t < seq ? to_f(from_f<T>(to_f(q[base + t * D + d]) * scale)) : 0.f;
  }
  for (int j0 = 0; j0 < seq; j0 += BK) {
    __syncthreads();
    load_kv<T, HD, true>(kv, k, base, D, j0, seq);
    __syncthreads();
    qk_tile<HD, HP, true>(qs, kv, st, j0, seq, 1.f);
  }
  __syncthreads();
  softmax_deferred<T, kSubtractMax>(st, seq, red);

  float acc[4][TN] = {};
  for (int j0 = 0; j0 < seq; j0 += BK) {
    __syncthreads();  // (the first also publishes the row sums)
    load_kv<T, HD, true>(kv, v, base, D, j0, seq);
    __syncthreads();
    pv_tile<HD, HP, false>(st, kv, acc, j0, min(BK, seq - j0));
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t < seq) {
      const float den = red[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < TN; ++c)
        o[base + t * D + tx + 16 * c] = from_f<T>(__fdiv_rn(acc[r][c], den));
    }
  }
}

// -- (c) the group kernel (v5, v6) ---------------------------------------

// query rows of one group, and keys per K/V tile, for NG groups a block
__host__ __device__ constexpr int group_bq(int ng) { return 4 * (16 / ng); }
__host__ __device__ constexpr int group_bk(int ng) { return ng >= 4 ? 16 : 64 / ng; }

// qk_tile for KPT = BKG / 16 keys a thread; a thread with no group
// (live false) writes zero scores, so the idle columns stay finite
template <int HD, int HP, int KPT>
__device__ __forceinline__ void qk_group(const float* qs, const float* kv, float* st,
                                         int j0, int seq, float scale, bool live) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][KPT] = {};
  if (live) {
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[KPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[(ty * 4 + r) * HP + d];
#pragma unroll
      for (int c = 0; c < KPT; ++c) b[c] = kv[(tx + 16 * c) * HP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < KPT; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int c = 0; c < KPT; ++c) {
    const int j = j0 + tx + 16 * c;
    if (j < seq)
      *reinterpret_cast<float4*>(&st[j * SP + ty * 4]) =
          make_float4(acc[0][c] * scale, acc[1][c] * scale, acc[2][c] * scale,
                      acc[3][c] * scale);
  }
}

// shared memory of a group block, in floats
__host__ __device__ constexpr long group_smem_floats(int ng, int seq, int hd) {
  return (long)(BQ + ng * group_bk(ng)) * (hd + 1) + PARTS * BQ + (long)seq * SP;
}

// grid: (ceil(seq / BQG), heads / NH, B / NR); group g = r * NH + h is
// batch row blockIdx.z * NR + r, head blockIdx.y * NH + h
template <typename T, int HD, int NH, int NR>
__global__ void __launch_bounds__(NT)
mha_group_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq, int heads,
                 float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int NG = NH * NR;
  constexpr int BQG = group_bq(NG), BKG = group_bk(NG), KPT = BKG / 16;
  constexpr int HP = HD + 1, TN = HD / 16;
  static_assert(NG >= 1 && NG <= 16 && NG * BQG <= BQ && BKG % 16 == 0, "group shape");
  extern __shared__ float attn_smem[];
  float* qs = attn_smem;           // [BQ][HP]: column g * BQG + i is row q0 + i of group g
  float* kv = qs + BQ * HP;        // [NG][BKG][HP]
  float* red = kv + NG * BKG * HP; // [PARTS][BQ]
  float* st = red + PARTS * BQ;    // [seq][SP], key-major; 16-byte aligned

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQG;
  const long D = (long)heads * HD;
  const long row0 = (long)blockIdx.z * NR, head0 = (long)blockIdx.y * NH;
  auto group_base = [&](int g) {
    return (row0 + g / NH) * seq * D + (head0 + g % NH) * HD;
  };
  const int my_g = ty * 4 / BQG;  // the group of this thread's 4 columns
  const bool live = my_g < NG;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int col = idx / HD, d = idx % HD;
    const int g = col / BQG, t = q0 + col % BQG;
    qs[col * HP + d] = g < NG && t < seq ? to_f(q[group_base(g) + t * D + d]) : 0.f;
  }
  auto load_group_kv = [&](const T* __restrict__ src, int j0) {
    for (int idx = tid; idx < NG * BKG * HD; idx += NT) {
      const int g = idx / (BKG * HD), j = idx / HD % BKG, d = idx % HD;
      kv[(g * BKG + j) * HP + d] =
          j0 + j < seq ? to_f(src[group_base(g) + (j0 + j) * D + d]) : 0.f;
    }
  };
  const float* my_kv = kv + (live ? my_g : 0) * BKG * HP;

  for (int j0 = 0; j0 < seq; j0 += BKG) {
    __syncthreads();
    load_group_kv(k, j0);
    __syncthreads();
    qk_group<HD, HP, KPT>(qs, my_kv, st, j0, seq, scale, live);
  }
  __syncthreads();
  softmax_rows<T, 1>(st, seq, red);

  float acc[4][TN] = {};
  for (int j0 = 0; j0 < seq; j0 += BKG) {
    __syncthreads();
    load_group_kv(v, j0);
    __syncthreads();
    if (live) pv_tile<HD, HP, false>(st, my_kv, acc, j0, min(BKG, seq - j0));
  }
  if (!live) return;
  const long ob = group_base(my_g);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + (ty * 4 + r) % BQG;
    if (t < seq) {
#pragma unroll
      for (int c = 0; c < TN; ++c) o[ob + t * D + tx + 16 * c] = from_f<T>(acc[r][c]);
    }
  }
}

// -- dispatch ---------------------------------------------------------------

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, T*, int, int, float);

// the kernel of one variant and its block shape: threads, query rows a
// block (grid x), heads and batch rows a block (grid y, z), dynamic smem
// bytes, and whether it is the tensor-core body
template <typename T>
struct VariantPlan {
  KernelFn<T> fn = nullptr;
  int threads = NT;
  int bq = BQ, nh = 1, nr = 1;
  long bytes = 0;
  bool mma = false;
};

// bf16 on the tensor-core body of attention_mma.cuh computing the function
// F with NH * NR groups a block: 4 warps, a 64-row query tile and the
// ring's shared memory, whatever T
template <typename T, int HD, int NH, int NR, int F>
VariantPlan<T> mma_plan() {
  VariantPlan<T> p;
  p.fn = mha_mma_kernel<HD, kOneBlock, NH, NR, 1, F>;
  p.threads = MT;
  p.bq = MQ;
  p.nh = NH;
  p.nr = NR;
  p.bytes = mma_smem_bytes(HD);
  p.mma = true;
  return p;
}

// bf16: the tensor-core body walking NH * NR groups; fp32: the CUDA-core
// group kernel (the tensor cores would round fp32 to TF32)
template <typename T, int HD, int NH, int NR>
VariantPlan<T> group_plan(int seq) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return mma_plan<T, HD, NH, NR, kFnExact>();
  } else {
    VariantPlan<T> p;
    p.fn = mha_group_kernel<T, HD, NH, NR>;
    p.bq = group_bq(NH * NR);
    p.nh = NH;
    p.nr = NR;
    p.bytes = group_smem_floats(NH * NR, seq, HD) * (long)sizeof(float);
    return p;
  }
}

// bf16 v2, v3 and v4 take #1's tensor-core body computing their function;
// fp32 v2 and v3 mha_v2_kernel, fp32 v4 #1's CUDA-core body with bf16
// scores. Heads a block of the group kernel for v5 (NR = 1): H / 2 for H
// in {2, 4, 8, 12, 16}; v6 takes NH = 1, NR = 2
template <typename T, int HD>
VariantPlan<T> variant_plan_head_dim(int variant, int seq, int nh, int nr) {
  if (variant == kGroup) {
    if (nr == 2 && nh == 1) return group_plan<T, HD, 1, 2>(seq);
    if (nr != 1) return VariantPlan<T>();
    switch (nh) {
      case 1: return group_plan<T, HD, 1, 1>(seq);
      case 2: return group_plan<T, HD, 2, 1>(seq);
      case 4: return group_plan<T, HD, 4, 1>(seq);
      case 6: return group_plan<T, HD, 6, 1>(seq);
      case 8: return group_plan<T, HD, 8, 1>(seq);
      default: return VariantPlan<T>();
    }
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (variant) {
      case kV2: return mma_plan<T, HD, 1, 1, kFnDeferred>();
      case kV3: return mma_plan<T, HD, 1, 1, kFnDeferredNoMax>();
      case kV4: return mma_plan<T, HD, 1, 1, kFnBf16Scores>();
      default: return VariantPlan<T>();
    }
  } else {
    VariantPlan<T> p;
    switch (variant) {
      case kV2: p.fn = mha_v2_kernel<T, HD, true>; break;
      case kV3: p.fn = mha_v2_kernel<T, HD, false>; break;
      case kV4: p.fn = mha_kernel<T, HD, kOneBlock, true>; break;
      default: return p;
    }
    // #1's CUDA-core layout: the Q and K/V tiles, the reductions, and the
    // block's [T][SP] fp32 score tile
    p.bytes = (long)(BQ + BK) * (HD + 1) * sizeof(float) + PARTS * BQ * sizeof(float) +
              (long)seq * SP * sizeof(float);
    return p;
  }
}

template <typename T>
VariantPlan<T> variant_plan(int variant, int seq, int head_dim, int nh, int nr) {
  switch (head_dim) {
    case 16: return variant_plan_head_dim<T, 16>(variant, seq, nh, nr);
    case 64: return variant_plan_head_dim<T, 64>(variant, seq, nh, nr);
    case 80: return variant_plan_head_dim<T, 80>(variant, seq, nh, nr);
    default: return VariantPlan<T>();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int seq,
           int heads, int head_dim, float scale, int variant, int nh, int nr,
           cudaStream_t stream) {
  const VariantPlan<T> p = variant_plan<T>(variant, seq, head_dim, nh, nr);
  cudaError_t err = prepare(p);
  if (err != cudaSuccess) return err;
  if (heads % p.nh != 0 || B % p.nr != 0) return cudaErrorInvalidValue;
  const dim3 grid((seq + p.bq - 1) / p.bq, heads / p.nh, B / p.nr);
  const KernelFn<T> fn = p.fn;
  fn<<<grid, p.threads, p.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, heads, scale);
  return cudaGetLastError();
}

template <typename T>
int variant_occupancy(int variant, int seq, int head_dim, int nh, int nr, int* regs,
                      int* blocks) {
  return plan_occupancy(variant_plan<T>(variant, seq, head_dim, nh, nr), regs, blocks);
}

}  // namespace

extern "C" {

// variant: 0 v2, 1 v3, 2 v4, 3 the group kernel with nh heads and nr
// batch rows a block (nh = H/2, nr = 1: v5; nh = 1, nr = 2: v6; ignored
// by the others); dtype: 0 = float32, 1 = bfloat16

// bytes of dynamic shared memory one block needs for seq keys (0: no such
// kernel)
long bvt_attn_variant_smem_bytes(int variant, int seq, int head_dim, int dtype, int nh,
                                 int nr) {
  return dtype == 1 ? variant_plan<__nv_bfloat16>(variant, seq, head_dim, nh, nr).bytes
                    : variant_plan<float>(variant, seq, head_dim, nh, nr).bytes;
}

// 1 when the launch takes the tensor-core body (every bf16 variant), 0 the
// CUDA-core one (fp32), -1 for no such kernel
int bvt_attn_variant_uses_mma(int variant, int head_dim, int dtype, int nh, int nr) {
  if (dtype == 1) {
    const VariantPlan<__nv_bfloat16> p =
        variant_plan<__nv_bfloat16>(variant, 0, head_dim, nh, nr);
    return p.fn == nullptr ? -1 : (int)p.mma;
  }
  return variant_plan<float>(variant, 0, head_dim, nh, nr).fn == nullptr ? -1 : 0;
}

// registers a thread and blocks an SM (the occupancy calculator) of the
// kernel a launch takes. Returns a cudaError_t (0 = both written).
int bvt_attn_variant_occupancy(int variant, int seq, int head_dim, int dtype, int nh,
                               int nr, int* regs, int* blocks_per_sm) {
  return dtype == 1 ? variant_occupancy<__nv_bfloat16>(variant, seq, head_dim, nh, nr,
                                                       regs, blocks_per_sm)
                    : variant_occupancy<float>(variant, seq, head_dim, nh, nr, regs,
                                               blocks_per_sm);
}

// the most dynamic shared memory a block of the current device may opt
// in to, or -1 when the device cannot be queried
int bvt_attn_variant_smem_limit(void) {
  const int optin = smem_optin();
  return optin < 0 ? -1 : optin;
}

// scale: 1/sqrt(head_dim); q, k, v, o 16-byte aligned for the
// tensor-core body. Returns a cudaError_t (0 = launched).
int bvt_attn_variant(const void* q, const void* k, const void* v, void* o, int B,
                     int seq, int heads, int head_dim, int dtype, float scale,
                     int variant, int nh, int nr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, seq, heads, head_dim, scale, variant, nh, nr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, seq, heads, head_dim, scale, variant,
                                 nh, nr, s);
  return cudaErrorInvalidValue;
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
