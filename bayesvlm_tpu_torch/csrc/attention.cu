// Fused non-causal multi-head self-attention for the vision towers.
//
// Replaces the TPU kernel `_mha_kernel` of
// bayesvlm_tpu/models/attention_pallas.py (called through
// `fused_attention`). Same math, same rounding points:
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
// tile of BQ=64 rows, head, batch row):
//   1. the Q tile goes to shared memory as fp32;
//   2. pass 1 walks K in tiles of BK=64 keys and writes the tile's fp32
//      scores for ALL T keys to shared memory (key-major, [T][BQ+4]);
//   3. each query row's max and sum are taken over shared memory, then
//      p = exp(s - max) / sum is rounded to the input dtype in place;
//   4. pass 2 walks V in tiles of BK keys and accumulates p.v in fp32
//      registers (each thread owns 4 rows x Dh/16 columns).
// The two-pass layout reproduces the TPU kernel's rounding exactly; an
// online (flash) softmax would round p at other points.
//
// What bounds it on an H100: all dot products run as fp32 FMAs on the
// CUDA cores, each fed by shared-memory loads (8 loads per 16 FMAs in
// pass 1, 5 per 16 in pass 2), so shared-memory bandwidth and the
// softmax's passes over the [T, BQ] score tile bound it, far below the
// tensor-core roofline (at ViT-L, T=257, the attention is 4*B*H*T^2*Dh
// = 17.3 GFLOP per layer at B=64, and the bytes it must move are tiny).
// What the design does about it: scores stay in shared memory (no HBM
// round trip), the smem layouts are padded so every warp-wide load is
// conflict-free or a broadcast, and two blocks fit on one SM at T=257.
// The next step is mma.sync / wgmma on bf16 operands for the two dots.
//
// The ragged edge (T = 257 or 50 is no multiple of 64) is masked here:
// query rows >= T are computed on zeros and never written, keys >= T
// are never stored as scores and never read in pass 2.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per K/V tile
constexpr int NT = 256;           // threads per block: 16 (tx) x 16 (ty)
constexpr int SP = BQ + 4;        // row stride of the score tile (floats)
constexpr int PARTS = NT / BQ;    // threads per query row in the softmax

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

// shared memory of one block, in floats: Q tile, K/V tile (row stride
// HD+1 keeps column reads conflict-free), softmax partials, score tile
__host__ __device__ constexpr long smem_floats(int T, int HD) {
  return (long)BQ * (HD + 1) + (long)BK * (HD + 1) + (long)PARTS * BQ
         + (long)T * SP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int seq, int heads,
           float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int HP = HD + 1;
  constexpr int TN = HD / 16;     // output columns per thread in pass 2
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][HP]
  float* kv = qs + BQ * HP;       // [BK][HP]
  float* red = kv + BK * HP;      // [PARTS][BQ]
  float* st = red + PARTS * BQ;   // [seq][SP], key-major; 16-byte aligned

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long D = (long)heads * HD;
  const long base = (long)blockIdx.z * seq * D + (long)blockIdx.y * HD;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int i = idx / HD, d = idx % HD;
    const int t = q0 + i;
    qs[i * HP + d] = t < seq ? to_f(q[base + t * D + d]) : 0.f;
  }

  // pass 1: fp32 scores of the BQ query rows against every key
  for (int j0 = 0; j0 < seq; j0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      kv[j * HP + d] = j0 + j < seq ? to_f(k[base + (j0 + j) * D + d]) : 0.f;
    }
    __syncthreads();
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
      if (j < seq) {
        *reinterpret_cast<float4*>(&st[j * SP + ty * 4]) =
            make_float4(acc[0][c] * scale, acc[1][c] * scale,
                        acc[2][c] * scale, acc[3][c] * scale);
      }
    }
  }
  __syncthreads();

  // exact softmax per query row: PARTS threads share a row, each strides
  // over the keys; partial maxima and sums meet in `red`
  {
    const int i = tid % BQ, part = tid / BQ;
    float m = -INFINITY;
    for (int j = part; j < seq; j += PARTS) m = fmaxf(m, st[j * SP + i]);
    red[part * BQ + i] = m;
    __syncthreads();
    m = red[i];
#pragma unroll
    for (int p = 1; p < PARTS; ++p) m = fmaxf(m, red[p * BQ + i]);
    float s = 0.f;
    for (int j = part; j < seq; j += PARTS) {
      const float e = expf(st[j * SP + i] - m);
      st[j * SP + i] = e;
      s += e;
    }
    __syncthreads();
    red[part * BQ + i] = s;
    __syncthreads();
    s = red[i];
#pragma unroll
    for (int p = 1; p < PARTS; ++p) s += red[p * BQ + i];
    for (int j = part; j < seq; j += PARTS)
      st[j * SP + i] = to_f(from_f<T>(st[j * SP + i] / s));
  }

  // pass 2: o = p . v in fp32
  float acc[4][TN] = {};
  for (int j0 = 0; j0 < seq; j0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      kv[j * HP + d] = j0 + j < seq ? to_f(v[base + (j0 + j) * D + d]) : 0.f;
    }
    __syncthreads();
    const int jn = min(BK, seq - j0);
    for (int j = 0; j < jn; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&st[(j0 + j) * SP + ty * 4]);
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const float x = kv[j * HP + tx + 16 * c];
        acc[0][c] = fmaf(p.x, x, acc[0][c]);
        acc[1][c] = fmaf(p.y, x, acc[1][c]);
        acc[2][c] = fmaf(p.z, x, acc[2][c]);
        acc[3][c] = fmaf(p.w, x, acc[3][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t < seq) {
#pragma unroll
      for (int c = 0; c < TN; ++c)
        o[base + t * D + tx + 16 * c] = from_f<T>(acc[r][c]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int seq, int heads, float scale, cudaStream_t stream) {
  const long bytes = smem_floats(seq, HD) * (long)sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opted in
  err = cudaFuncSetAttribute(mha_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, heads, B);
  mha_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, heads, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o, int B,
                 int seq, int heads, int head_dim, float scale,
                 cudaStream_t stream) {
  switch (head_dim) {
    // tiny test towers (16), CLIP B/L and SigLIP (64), CLIP H (80)
    case 16: return launch<T, 16>(q, k, v, o, B, seq, heads, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, seq, heads, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, seq, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one block needs for seq keys
long bvt_attention_smem_bytes(int seq, int head_dim) {
  return smem_floats(seq, head_dim) * (long)sizeof(float);
}

// the most dynamic shared memory a block of the current device may opt
// in to, or -1 when the device cannot be queried
int bvt_attention_smem_limit(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

// dtype: 0 = float32, 1 = bfloat16; scale multiplies the fp32 dot
// products (1/sqrt(head_dim)). Returns a cudaError_t (0 = launched).
int bvt_attention(const void* q, const void* k, const void* v, void* o,
                  int B, int seq, int heads, int head_dim, int dtype,
                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, o, B, seq, heads, head_dim, scale, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, B, seq, heads, head_dim, scale,
                                        s);
  return cudaErrorInvalidValue;
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
