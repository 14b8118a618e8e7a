// link: -lnvjpeg
//
// JPEG bitstreams to model-ready crops on the card: nvJPEG decodes each
// image to its planes (the IDCT's samples, chroma at its stored
// resolution), and three kernels written here take them on:
// planes_crop_kernel (the crop path: planes straight to the crops),
// ycc_rgb_kernel (interleaved RGB, for decode_rgb) and resize_crop_kernel
// (crops of RGB images).
//
// No TPU kernel stands behind them: in the JAX package this work is host
// C++ (libjpeg's decode, then process_one and bilinear,
// native/bvt_io.cc:131-258). It moves onto the card because the card's
// machine has no host JPEG decoder, and with no decoder source in the
// repository nvJPEG (shipped with the CUDA toolkit) is the one that is
// there.
//
// Decode (bvt_jpeg_info, bvt_jpeg_decode): nvjpegGetImageInfo gives each
// image's size and chroma subsampling; an image nvJPEG refuses, one that is
// neither 1 nor 3 components (CMYK: libjpeg's JCS_RGB refuses it too), or
// one of a subsampling nvJPEG does not name, is status -1 and is cropped to
// zeros. nvjpegDecode writes NVJPEG_OUTPUT_UNCHANGED (Y, then Cb and Cr,
// each plane packed at its own width) into the caller's buffer on the
// caller's stream, and the call writes each image's row of metadata (its
// planes' addresses, sizes and factors) into the caller's pinned block; no
// EXIF orientation is applied, as libjpeg applies none. Each concurrent
// caller takes its own handle and state from a pool (a state must not be
// shared between threads), and the stream is synchronised after each
// image, before the state's buffers are reused by the next. A stream cut
// off mid-scan is walked on the host first (csrc/jpeg_scan.cc) and its
// planes patched to libjpeg's (data/native_io.py).
//
// The colour stage, in planes_crop_kernel and ycc_rgb_kernel alike:
// libjpeg-turbo 2.1's, integer for integer, so that what is left between
// the two decoders is their IDCTs (nvJPEG's own RGBI output upsamples
// chroma by replication and converts in another rounding: 4:2:0 RGB up to
// 15 apart). Chroma upsampling as jdsample.c with fancy upsampling on
// (libjpeg's default): h2v1 and h2v2 triangular where the chroma plane is
// wider than 2 samples, h1v2 triangular, and replication otherwise (4:4:4,
// 4:1:1, ...); the image's edges repeat the edge sample, as libjpeg's
// context rows and first / last columns do. Then jdcolor.c's
// ycc_rgb_convert: R = Y + Cr_r[Cr], G = Y + ((Cb_g[Cb] + Cr_g[Cr]) >> 16),
// B = Y + Cb_b[Cb], its 16-bit fixed-point tables and rounding, clamped to
// [0, 255]; a grey image gives R = G = B = Y.
//
// The resampling, in planes_crop_kernel and resize_crop_kernel alike:
// bilinear sampling of each [S, S, 3] crop, either the shorter side
// resized to S and the centre cropped (CLIP) or a square resize (SigLIP),
// written as uint8 (+0.5, clamp to [0, 255], truncate) or as fp32
// ((px / 255 - mean) / std). It reproduces bilinear() and process_one
// operation for operation: the `w - 1.001f` clamp, truncation to x0, the
// +1 neighbours clamped to the edge, and every float32 operation in the
// same order, each rounded on its own (__fadd_rn / __fmul_rn / __fdiv_rn:
// nvcc would otherwise contract a + (b - a) * f into an FMA), so each
// kernel is bit-equal to its plain version (native_io.planes_crop_reference,
// ycc_to_rgb_reference, resize_crop_reference).
//
// What bounds them on an H100, at the Stage-1 lane's batch (B = 64 of the
// test fixtures, 54 decoded, 224 crops): on paper bytes. planes_crop reads
// the plane bytes under the crops' grids and writes 9.6 MB of uint8 (38.5
// MB fp32), a few microseconds at 3.35 TB/s, and keeps the 16.5 MB of
// interleaved RGB that ycc_rgb_kernel writes and resize_crop_kernel reads
// out of device memory. In practice its instructions: the conversion of
// each distinct source pixel under the grids (4.6 million at that batch)
// and some 20 an output value, and each band's serial phases; source
// variants timed on an H100 (probes/planes_crop_variants.py) split its
// time (PERF.md). Design: planes_crop_kernel's note below;
// ycc_rgb_kernel four pixels a thread, stored as three 32-bit words;
// resize_crop_kernel one thread an output pixel. Their times against their
// bounds are in PERF.md (chip_smoke.py phase 7e).

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kStatusBase = 10000;  // nvjpegStatus_t s is returned as kStatusBase + s

struct Codec {
  nvjpegHandle_t handle;
  nvjpegJpegState_t state;
};

std::mutex g_mu;
std::vector<Codec> g_free[64];  // per device: codecs no thread holds

int acquire(int device, Codec* c) {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!g_free[device].empty()) {
      *c = g_free[device].back();
      g_free[device].pop_back();
      return 0;
    }
  }
  nvjpegStatus_t s = nvjpegCreateSimple(&c->handle);
  if (s != NVJPEG_STATUS_SUCCESS) return kStatusBase + s;
  s = nvjpegJpegStateCreate(c->handle, &c->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(c->handle);
    return kStatusBase + s;
  }
  return 0;
}

void release(int device, const Codec& c) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_free[device].push_back(c);
}

// RAII: the calling thread's codec for the current device
struct Held {
  int device = -1, err = 0;
  Codec codec{};
  Held() {
    err = (int)cudaGetDevice(&device);
    if (err == 0 && (device < 0 || device >= 64)) err = (int)cudaErrorInvalidDevice;
    if (err == 0) err = acquire(device, &codec);
  }
  ~Held() {
    if (err == 0) release(device, codec);
  }
};

struct Norm {
  float mean[3];
  float stdv[3];
};

__device__ __forceinline__ float fmin_std(float x, float lim) {  // std::min(x, lim)
  return (lim < x) ? lim : x;
}

__device__ __forceinline__ float fmax0_std(float x) {  // std::max(0.0f, x)
  return (0.0f < x) ? x : 0.0f;
}

// libjpeg's FIX(x): x in 16-bit fixed point, rounded; jdcolor.c's four
// conversion factors
constexpr int fix16(double x) { return (int)(x * 65536.0 + 0.5); }
constexpr int kCrR = fix16(1.40200), kCbG = fix16(0.34414), kCrG = fix16(0.71414),
              kCbB = fix16(1.77200);

__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One image's planes as a meta row gives them: [10] int64, the Y, Cb and
// Cr planes' addresses, an output address (ycc_rgb_kernel's RGB), width,
// height, chroma width and height, factors hf, vf (0: grey; width 0: a
// failed decode)
struct Img {
  const uint8_t* y;
  const uint8_t* cb;
  const uint8_t* cr;
  int w, h, cw, ch, hf, vf;
};

__device__ __forceinline__ Img load_img(const int64_t* __restrict__ m) {
  Img im;
  im.y = reinterpret_cast<const uint8_t*>(m[0]);
  im.cb = reinterpret_cast<const uint8_t*>(m[1]);
  im.cr = reinterpret_cast<const uint8_t*>(m[2]);
  im.w = (int)m[4];
  im.h = (int)m[5];
  im.cw = (int)m[6];
  im.ch = (int)m[7];
  im.hf = (int)m[8];
  im.vf = (int)m[9];
  return im;
}

// jdsample.c's chroma upsampling with fancy upsampling on, by the image's
// factors: h2v2 and h2v1 triangular where the chroma plane is wider than 2
// samples, h1v2 triangular, replication otherwise (4:4:4, 4:1:1, ...); a
// grey image has no chroma. Kernels choose the mode once an image and run
// a body compiled for it (by_mode).
enum ChromaMode { kReplicate = 0, kH2V2, kH2V1, kH1V2, kGrey };

__device__ __forceinline__ int chroma_mode(const Img& im) {
  if (im.hf == 0) return kGrey;
  if (im.hf == 2 && im.vf == 2 && im.cw > 2) return kH2V2;
  if (im.hf == 2 && im.vf == 1 && im.cw > 2) return kH2V1;
  if (im.hf == 1 && im.vf == 2) return kH1V2;
  return kReplicate;
}

template <int M>
struct Mode {
  static constexpr int value = M;
};

// f(Mode<M>()) for the image's mode M
template <class F>
__device__ __forceinline__ void by_mode(int mode, F f) {
  switch (mode) {
    case kH2V2: f(Mode<kH2V2>()); break;
    case kH2V1: f(Mode<kH2V1>()); break;
    case kH1V2: f(Mode<kH1V2>()); break;
    case kGrey: f(Mode<kGrey>()); break;
    default: f(Mode<kReplicate>()); break;
  }
}

// The chroma rows luma row y reads: j (sel 0) and its vertical neighbour
// nb (sel 1; j itself where the mode has no vertical context)
template <int M>
__device__ __forceinline__ void chroma_rows(const Img& im, int y, int* j, int* nb) {
  if constexpr (M == kH2V2 || M == kH1V2) {
    *j = y >> 1;
    *nb = (y & 1) ? min(*j + 1, im.ch - 1) : max(*j - 1, 0);
  } else if constexpr (M == kH2V1) {
    *j = *nb = y;
  } else {
    *j = *nb = min(y / im.vf, im.ch - 1);
  }
}

// The chroma columns luma column x reads: i and its horizontal neighbour k
// (i itself where the mode has no horizontal context)
template <int M>
__device__ __forceinline__ void chroma_cols(const Img& im, int x, int* i, int* k) {
  if constexpr (M == kH2V2 || M == kH2V1) {
    *i = x >> 1;
    *k = (x & 1) ? min(*i + 1, im.cw - 1) : max(*i - 1, 0);
  } else if constexpr (M == kH1V2) {
    *i = *k = x;
  } else {
    *i = *k = min(x / im.hf, im.cw - 1);
  }
}

// One upsampled chroma sample at luma (x, y) from the samples at(sel,
// column) of rows j (sel 0) and nb (sel 1) and columns i and k
template <int M, class At>
__device__ __forceinline__ int chroma_mix(int x, int y, int i, int k, At at) {
  if constexpr (M == kH2V2)  // h2v2_fancy_upsample
    return (3 * (3 * at(0, i) + at(1, i)) + 3 * at(0, k) + at(1, k) + ((x & 1) ? 7 : 8)) >> 4;
  else if constexpr (M == kH2V1)  // h2v1_fancy_upsample
    return (3 * at(0, i) + at(0, k) + ((x & 1) ? 2 : 1)) >> 2;
  else if constexpr (M == kH1V2)  // h1v2_fancy_upsample
    return (3 * at(0, i) + at(1, i) + ((y & 1) ? 2 : 1)) >> 2;
  else
    return at(0, i);
}

// jdcolor.c's ycc_rgb_convert of one pixel, with its tables (Cr_r, Cb_b
// rounded; Cb_g carries the ONE_HALF)
__device__ __forceinline__ void ycc_rgb(int luma, int cb, int cr, uint8_t* rgb) {
  cb -= 128;
  cr -= 128;
  rgb[0] = clamp255(luma + ((kCrR * cr + 32768) >> 16));
  rgb[1] = clamp255(luma + ((-kCbG * cb + 32768 - kCrG * cr) >> 16));
  rgb[2] = clamp255(luma + ((kCbB * cb + 32768) >> 16));
}

// libjpeg's RGB of source pixel (x, y) of an image of mode M, the planes
// read from device memory through the read-only path: the chroma
// upsampled (chroma_mix), then ycc_rgb; a grey image gives R = G = B = Y
template <int M>
__device__ __forceinline__ void rgb_at(const Img& im, int x, int y, uint8_t* rgb) {
  const int luma = __ldg(im.y + (size_t)y * im.w + x);
  if constexpr (M == kGrey) {  // JCS_GRAYSCALE -> JCS_RGB
    rgb[0] = rgb[1] = rgb[2] = (uint8_t)luma;
  } else {
    int j, nb, i, k;
    chroma_rows<M>(im, y, &j, &nb);
    chroma_cols<M>(im, x, &i, &k);
    const uint8_t* __restrict__ b0 = im.cb + (size_t)j * im.cw;
    const uint8_t* __restrict__ b1 = im.cb + (size_t)nb * im.cw;
    const uint8_t* __restrict__ r0 = im.cr + (size_t)j * im.cw;
    const uint8_t* __restrict__ r1 = im.cr + (size_t)nb * im.cw;
    const int cb = chroma_mix<M>(x, y, i, k, [&](int sel, int c) { return (int)__ldg((sel ? b1 : b0) + c); });
    const int cr = chroma_mix<M>(x, y, i, k, [&](int sel, int c) { return (int)__ldg((sel ? r1 : r0) + c); });
    ycc_rgb(luma, cb, cr, rgb);
  }
}

// meta [n, 10] int64 (Img's rows). Four pixels a thread, written as three
// 32-bit words (each image's RGB starts on a 16-byte boundary); the last
// one to three pixels of an image byte by byte.
__global__ void ycc_rgb_kernel(const int64_t* __restrict__ meta, int n) {
  const int i = blockIdx.y;
  const int64_t* m = meta + 10 * (size_t)i;
  const Img im = load_img(m);
  const int64_t pixels = (int64_t)im.w * im.h;
  const int64_t p0 = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (p0 >= pixels) return;
  uint8_t* out = reinterpret_cast<uint8_t*>(m[3]) + 3 * p0;
  const int count = pixels - p0 < 4 ? (int)(pixels - p0) : 4;
  const int y0 = (int)(p0 / im.w), x0 = (int)(p0 - (int64_t)y0 * im.w);
  uint8_t v[12];
  by_mode(chroma_mode(im), [&](auto mode) {
    int x = x0, y = y0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < count) {
        rgb_at<decltype(mode)::value>(im, x, y, v + 3 * k);
        if (++x == im.w) {
          x = 0;
          ++y;
        }
      }
    }
  });
  if (count == 4) {
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      o[k] = (uint32_t)v[4 * k] | ((uint32_t)v[4 * k + 1] << 8) |
             ((uint32_t)v[4 * k + 2] << 16) | ((uint32_t)v[4 * k + 3] << 24);
  } else {
    for (int k = 0; k < 3 * count; ++k) out[k] = v[k];
  }
}

// process_one's placement of the crop: the shorter side to S (scale) and
// the centre (ox, oy); unused for a square resize
__device__ __forceinline__ void crop_placement(int w, int h, int S, float* scale, float* ox,
                                               float* oy) {
  const float fS = (float)S, fw = (float)w, fh = (float)h;
  *scale = (w <= h) ? __fdiv_rn(fw, fS) : __fdiv_rn(fh, fS);
  *ox = __fmul_rn(__fsub_rn(__fdiv_rn(fw, *scale), fS), 0.5f);
  *oy = __fmul_rn(__fsub_rn(__fdiv_rn(fh, *scale), fS), 0.5f);
}

// Where output index `idx` on an axis of `len` source samples samples it,
// as process_one and bilinear() place, clamp and truncate it: the two
// neighbours and the fraction
__device__ __forceinline__ void sample_axis(int idx, int len, int S, int square, float scale,
                                            float off, int* i0, int* i1, float* f) {
  float s;
  if (square) {  // (xx + 0.5f) * w / S - 0.5f
    s = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn((float)idx, 0.5f), (float)len), (float)S),
                  0.5f);
  } else {  // (xx + ox + 0.5f) * scale - 0.5f
    s = __fsub_rn(__fmul_rn(__fadd_rn(__fadd_rn((float)idx, off), 0.5f), scale), 0.5f);
  }
  const float c = fmax0_std(fmin_std(s, __fsub_rn((float)len, 1.001f)));
  *i0 = (int)c;
  *i1 = min(*i0 + 1, len - 1);
  *f = __fsub_rn(c, (float)*i0);
}

// bilinear()'s blend of one channel, each float32 operation rounded on its
// own, then the uint8 quantisation (+0.5, clamp, truncate) or the
// normalisation ((px / 255 - mean) / std)
__device__ __forceinline__ float blend(int p00, int p01, int p10, int p11, float fx, float fy) {
  const float a = __fadd_rn((float)p00, __fmul_rn((float)(p01 - p00), fx));
  const float b = __fadd_rn((float)p10, __fmul_rn((float)(p11 - p10), fx));
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), fy));
}

__device__ __forceinline__ uint8_t quantise(float px) {
  const float v = __fadd_rn(px, 0.5f);
  return (uint8_t)__float2int_rz(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
}

__device__ __forceinline__ float normalise(float px, const Norm& norm, int c) {
  const float mean = c == 0 ? norm.mean[0] : (c == 1 ? norm.mean[1] : norm.mean[2]);
  const float stdv = c == 0 ? norm.stdv[0] : (c == 1 ? norm.stdv[1] : norm.stdv[2]);
  return __fdiv_rn(__fsub_rn(__fdiv_rn(px, 255.0f), mean), stdv);
}

// meta [3, n] int64: each source's device address, width and height
__global__ void resize_crop_kernel(const int64_t* __restrict__ meta, int n, int S,
                                   int square, Norm norm, float* __restrict__ out,
                                   uint8_t* __restrict__ out_u8) {
  const int i = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= S * S) return;
  const int yy = p / S, xx = p - yy * S;
  const size_t off = ((size_t)i * S * S + p) * 3;
  const int w = (int)meta[n + i], h = (int)meta[2 * n + i];
  if (w <= 0 || h <= 0) {  // a failed decode: zeros
    for (int c = 0; c < 3; ++c) {
      if (out_u8) out_u8[off + c] = 0;
      else out[off + c] = 0.0f;
    }
    return;
  }
  float scale = 0.f, ox = 0.f, oy = 0.f;
  if (!square) crop_placement(w, h, S, &scale, &ox, &oy);
  int x0, x1, y0, y1;
  float fx, fy;
  sample_axis(xx, w, S, square, scale, ox, &x0, &x1, &fx);
  sample_axis(yy, h, S, square, scale, oy, &y0, &y1, &fy);
  const uint8_t* src = reinterpret_cast<const uint8_t*>(meta[i]);
  const uint8_t* p00 = src + ((size_t)y0 * w + x0) * 3;
  const uint8_t* p01 = src + ((size_t)y0 * w + x1) * 3;
  const uint8_t* p10 = src + ((size_t)y1 * w + x0) * 3;
  const uint8_t* p11 = src + ((size_t)y1 * w + x1) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float px = blend(p00[c], p01[c], p10[c], p11[c], fx, fy);
    if (out_u8) out_u8[off + c] = quantise(px);
    else out[off + c] = normalise(px, norm, c);
  }
}

// Distinct source indices of an axis: the k-th output index samples a0[k]
// and a1[k] (both non-decreasing in k, a1 = min(a0 + 1, len - 1)); src
// gets the sorted distinct values, slot0 / slot1 each output index's two
// places in it. The first occurrences come sorted: a new a0[k] exceeds all
// before it, a repeated one equals a1[k - 1] (the largest so far) or
// a0[k - 1] (the next below it). new0 / new1: whether a0[k] / a1[k] is a
// first occurrence.
struct Axis {
  const int* a0;
  const int* a1;
  __device__ bool new0(int k) const {
    return k == 0 || (a0[k] != a0[k - 1] && a0[k] != a1[k - 1]);
  }
  __device__ bool new1(int k) const {
    return a1[k] != a0[k] && (k == 0 || a1[k] != a1[k - 1]);
  }
  // slots of output indices k0..k1 - 1, r distinct values coming before k0
  __device__ void assign(int k0, int k1, int r, uint16_t* slot0, uint16_t* slot1,
                         int* src) const {
    for (int k = k0; k < k1; ++k) {
      if (new0(k)) {
        src[r] = a0[k];
        slot0[k] = (uint16_t)r++;
      } else {
        slot0[k] = (uint16_t)(a0[k] == a1[k - 1] ? r - 1 : r - 2);
      }
      if (new1(k)) {
        src[r] = a1[k];
        slot1[k] = (uint16_t)r++;
      } else {
        slot1[k] = a1[k] == a0[k] ? slot0[k] : (uint16_t)(r - 1);
      }
    }
  }
};

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// The axis's distinct indices in one warp (a few output indices: a band's
// rows); returns how many there are, in every lane
__device__ int distinct_warp(const Axis& ax, int count, uint16_t* slot0, uint16_t* slot1,
                             int* src) {
  const int lane = threadIdx.x & 31;
  const int chunk = (count + 31) / 32;
  const int k0 = min(lane * chunk, count), k1 = min(k0 + chunk, count);
  int mine = 0;
  for (int k = k0; k < k1; ++k) mine += (int)ax.new0(k) + (int)ax.new1(k);
  const int incl = warp_inclusive_sum(mine);
  ax.assign(k0, k1, incl - mine, slot0, slot1, src);
  return __shfl_sync(0xffffffffu, incl, 31);
}

// The same over the whole block (all S columns), a scan across its warps
// through s_warp [32]; every thread calls it, and it returns the count in
// every thread
__device__ int distinct_block(const Axis& ax, int count, uint16_t* slot0, uint16_t* slot1,
                              int* src, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int chunk = (count + blockDim.x - 1) / blockDim.x;
  const int k0 = min((int)threadIdx.x * chunk, count), k1 = min(k0 + chunk, count);
  int mine = 0;
  for (int k = k0; k < k1; ++k) mine += (int)ax.new0(k) + (int)ax.new1(k);
  const int incl = warp_inclusive_sum(mine);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_inclusive_sum(lane < warps ? s_warp[lane] : 0);
    if (lane < warps) s_warp[lane] = t;
  }
  __syncthreads();
  ax.assign(k0, k1, (warp ? s_warp[warp - 1] : 0) + incl - mine, slot0, slot1, src);
  return s_warp[warps - 1];
}

// Bytes of planes_crop_kernel's shared memory that hold a tile of the
// planes: the band's luma rows and chroma rows, each row a span of columns
constexpr int kStageBytes = 16 * 1024;

// The band's distinct chroma rows (in one warp; at most 16 luma rows): luma
// row r reads rows slot[2 r] and slot[2 r + 1] of crow (chroma_rows' j and
// nb; the same slot where they are one row). Returns how many there are,
// in every lane.
template <int M>
__device__ int chroma_slots(const Img& im, const int* rowsrc, int nr, uint8_t* slot, int* crow) {
  const int lane = threadIdx.x & 31, r = lane >> 1;
  int row = -1;
  if (r < nr) {
    int j, nb;
    chroma_rows<M>(im, rowsrc[r], &j, &nb);
    row = (lane & 1) ? nb : j;
  }
  const int first = __ffs(__match_any_sync(0xffffffffu, row)) - 1;  // the first lane with row
  const unsigned firsts = __ballot_sync(0xffffffffu, row >= 0 && first == lane);
  const int mine = __popc(firsts & ((1u << lane) - 1));
  const int at = __shfl_sync(0xffffffffu, mine, first);
  if (row >= 0) slot[lane] = (uint8_t)at;
  if (row >= 0 && first == lane) crow[mine] = row;
  return __popc(firsts);
}

// Columns lo..hi of a plane row (`row`, in device memory) staged at byte
// `dst` of the staging area: the 16-byte words that hold them, loaded
// whole from their aligned start (stage_row: this thread's word q); column
// x is then read at stage[staged_at(row, lo, dst) + x].
__device__ __forceinline__ int staged_at(const uint8_t* row, int lo, int dst) {
  return dst + (int)(reinterpret_cast<uintptr_t>(row + lo) & 15) - lo;
}

__device__ __forceinline__ void stage_row(const uint8_t* row, int lo, int hi, uint8_t* stage,
                                          int dst, int q) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + lo), a16 = a & ~(uintptr_t)15;
  if (16 * q < (int)(a - a16) + hi - lo + 1)
    *reinterpret_cast<uint4*>(stage + dst + 16 * q) =
        __ldg(reinterpret_cast<const uint4*>(a16) + q);
}

// The fused lane: nvJPEG's planes -> [n, S, S, 3] crops (uint8 or
// normalised fp32), bit-equal to resize_crop_reference(ycc_to_rgb_reference
// (planes)). A block owns a band of R output rows of one image:
//   1. it places the band's rows and all S columns on the source
//      (sample_axis, as resize_crop_kernel) and lists the distinct source
//      rows and columns they sample (at most 2R and 2S: distinct_block,
//      the columns over the whole block, distinct_warp the rows), the
//      chroma columns each of those columns reads and the distinct chroma
//      rows the rows read (chroma_slots: fancy upsampling's context rows
//      included);
//   2. a tile of source columns at a time (as wide as kStageBytes allows
//      for the band's rows: most images in one), it stages the span of
//      those luma rows and chroma rows that the tile's sampled columns read
//      into shared memory with 16-byte loads (stage_row, a warp on
//      consecutive words of a row), then converts each distinct (row,
//      column) cell of the tile to RGB once (chroma_mix and ycc_rgb,
//      compiled for the image's chroma mode, read from the staged rows)
//      into the band's RGB table in shared memory, so the interleaved RGB
//      never goes to device memory;
//   3. it writes the band's rows, a thread 16 uint8 or 4 fp32 pixels
//      (48 bytes) as three 16-byte stores, each value blended from the
//      RGB table in resize_crop_kernel's operation order; where S does
//      not let the rows start on 16-byte boundaries, value by value (the
//      band's R * S * 3 values are contiguous: 16-byte stores inside it,
//      its unaligned head and tail alone).
template <typename T>
__global__ void planes_crop_kernel(const int64_t* __restrict__ meta, int S, int R,
                                   int square, Norm norm, T* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_stage = smem;
  float* s_fx = reinterpret_cast<float*>(smem + kStageBytes);
  float* s_fy = s_fx + S;
  int* s_x0 = reinterpret_cast<int*>(s_fy + R);
  int* s_x1 = s_x0 + S;
  int* s_y0 = s_x1 + S;
  int* s_y1 = s_y0 + R;
  int* s_colsrc = s_y1 + R;
  int* s_rowsrc = s_colsrc + 2 * S;
  uint32_t* s_ck = reinterpret_cast<uint32_t*>(s_rowsrc + 2 * R);  // chroma columns i | k << 16
  uint16_t* s_cs0 = reinterpret_cast<uint16_t*>(s_ck + 2 * S);
  uint16_t* s_cs1 = s_cs0 + S;
  uint16_t* s_rs0 = s_cs1 + S;
  uint16_t* s_rs1 = s_rs0 + R;
  uint8_t* s_rgb = reinterpret_cast<uint8_t*>(s_rs1 + R);
  __shared__ int s_nc, s_nr, s_ncs, s_warp[32];
  __shared__ int4 s_rq[16];  // a luma row's staged chroma rows: Cb j, nb, Cr j, nb
  __shared__ int s_yoff[16], s_crow[32];
  __shared__ uint8_t s_slot[32];

  const int i = blockIdx.y;
  const Img im = load_img(meta + 10 * (size_t)i);
  const int yy0 = blockIdx.x * R;
  const int rows = min(R, S - yy0);
  const int row_len = 3 * S;
  const int64_t e0 = ((int64_t)i * S + yy0) * row_len, e1 = e0 + (int64_t)rows * row_len;
  const bool ok = im.w > 0 && im.h > 0;

  if (ok) {
    const int mode = chroma_mode(im);
    const bool colour = mode != kGrey;
    float scale = 0.f, ox = 0.f, oy = 0.f;
    if (!square) crop_placement(im.w, im.h, S, &scale, &ox, &oy);
    for (int k = threadIdx.x; k < S; k += blockDim.x)
      sample_axis(k, im.w, S, square, scale, ox, s_x0 + k, s_x1 + k, s_fx + k);
    for (int k = threadIdx.x; k < rows; k += blockDim.x)
      sample_axis(yy0 + k, im.h, S, square, scale, oy, s_y0 + k, s_y1 + k, s_fy + k);
    __syncthreads();
    const int cols = distinct_block(Axis{s_x0, s_x1}, S, s_cs0, s_cs1, s_colsrc, s_warp);
    if (threadIdx.x < 32) {
      const int nr = distinct_warp(Axis{s_y0, s_y1}, rows, s_rs0, s_rs1, s_rowsrc);
      __syncwarp();
      int ncs = 0;
      by_mode(mode, [&](auto md) {
        constexpr int M = decltype(md)::value;
        if constexpr (M != kGrey) ncs = chroma_slots<M>(im, s_rowsrc, nr, s_slot, s_crow);
      });
      if (threadIdx.x == 0) {
        s_nc = cols;
        s_nr = nr;
        s_ncs = ncs;
      }
    }
    __syncthreads();
    const int nc = s_nc, nr = s_nr, ncs = s_ncs;
    by_mode(mode, [&](auto md) {
      constexpr int M = decltype(md)::value;
      if constexpr (M != kGrey) {
        for (int c = threadIdx.x; c < nc; c += blockDim.x) {
          int ci, ck;
          chroma_cols<M>(im, s_colsrc[c], &ci, &ck);
          s_ck[c] = (uint32_t)ci | ((uint32_t)ck << 16);
        }
      }
    });
    // the tile width: nr luma rows of tw + 16 bytes and 2 ncs chroma rows
    // of at most tw / hf + 3 samples (+ 30 for the words' alignment) fit
    // kStageBytes; no wider than the band's columns
    const int hf = max(im.hf, 1), x_first = s_colsrc[0], x_last = s_colsrc[nc - 1];
    const int base = x_first & ~15;
    int tw = ((kStageBytes - 16 * nr - 66 * ncs) * hf / (nr * hf + 2 * ncs)) & ~15;
    tw = min(tw, ((x_last - base) / 16 + 1) * 16);
    const int y_pitch = tw + 16, c_pitch = (tw / hf + 33) & ~15;
    const int y_words = y_pitch / 16, c_words = c_pitch / 16, c_base = nr * y_pitch;
    const int fancy_h = mode == kH2V2 || mode == kH2V1;
    int c_begin = 0;
    for (int tx0 = base; tx0 <= x_last; tx0 += tw) {
      const int lo = max(tx0, x_first), hi = min(tx0 + tw - 1, x_last);
      const int clo = max(min(lo / hf, im.cw - 1) - fancy_h, 0);
      const int chi = min(hi / hf + fancy_h, im.cw - 1);
      for (int t = threadIdx.x; t < nr * y_words; t += blockDim.x) {
        const int r = t / y_words;
        stage_row(im.y + (size_t)s_rowsrc[r] * im.w, lo, hi, s_stage, r * y_pitch,
                  t - r * y_words);
      }
      for (int t = threadIdx.x; t < 2 * ncs * c_words; t += blockDim.x) {
        const int s = t / c_words, red = s >= ncs;
        stage_row((red ? im.cr : im.cb) + (size_t)s_crow[s - red * ncs] * im.cw, clo, chi,
                  s_stage, c_base + s * c_pitch, t - s * c_words);
      }
      for (int r = threadIdx.x; r < nr; r += blockDim.x) {
        s_yoff[r] = staged_at(im.y + (size_t)s_rowsrc[r] * im.w, lo, r * y_pitch);
        if (colour) {
          const int a = s_slot[2 * r], b = s_slot[2 * r + 1];
          const size_t ra = (size_t)s_crow[a] * im.cw, rb = (size_t)s_crow[b] * im.cw;
          s_rq[r] = make_int4(staged_at(im.cb + ra, clo, c_base + a * c_pitch),
                              staged_at(im.cb + rb, clo, c_base + b * c_pitch),
                              staged_at(im.cr + ra, clo, c_base + (ncs + a) * c_pitch),
                              staged_at(im.cr + rb, clo, c_base + (ncs + b) * c_pitch));
        }
      }
      __syncthreads();
      int c_end = c_begin, top = nc;  // the tile's columns: c_begin..c_end - 1
      while (c_end < top) {
        const int mid = (c_end + top) >> 1;
        if (s_colsrc[mid] <= hi) c_end = mid + 1;
        else top = mid;
      }
      const int width = c_end - c_begin;
      by_mode(mode, [&](auto md) {
        constexpr int M = decltype(md)::value;
        for (int e = threadIdx.x; e < nr * width; e += blockDim.x) {
          const int r = e / width, c = c_begin + e - r * width;
          const int x = s_colsrc[c];
          uint8_t* rgb = s_rgb + 3 * (r * nc + c);
          const int luma = s_stage[s_yoff[r] + x];
          if constexpr (M == kGrey) {
            rgb[0] = rgb[1] = rgb[2] = (uint8_t)luma;
          } else {
            const int y = s_rowsrc[r];
            const uint32_t ck = s_ck[c];
            const int4 q = s_rq[r];
            const int cb = chroma_mix<M>(x, y, ck & 0xffff, ck >> 16, [&](int sel, int col) {
              return (int)s_stage[(sel ? q.y : q.x) + col];
            });
            const int cr = chroma_mix<M>(x, y, ck & 0xffff, ck >> 16, [&](int sel, int col) {
              return (int)s_stage[(sel ? q.w : q.z) + col];
            });
            ycc_rgb(luma, cb, cr, rgb);
          }
        }
      });
      __syncthreads();
      c_begin = c_end;
    }
  }

  const int nc = ok ? s_nc : 0;
  auto value = [&](int64_t e) -> T {
    if (!ok) return T(0);
    const int q = (int)(e - e0);
    const int r = q / row_len, rem = q - r * row_len;
    const int xx = rem / 3, c = rem - 3 * xx;
    const uint8_t* t0 = s_rgb + 3 * s_rs0[r] * nc + c;
    const uint8_t* t1 = s_rgb + 3 * s_rs1[r] * nc + c;
    const int c0 = 3 * s_cs0[xx], c1 = 3 * s_cs1[xx];
    const float px = blend(t0[c0], t0[c1], t1[c0], t1[c1], s_fx[xx], s_fy[r]);
    if constexpr (sizeof(T) == 1) return quantise(px);
    else return normalise(px, norm, c);
  };
  // G pixels a thread, 48 bytes: three 16-byte stores where every output
  // row starts on a 16-byte boundary (S a multiple of 16 in uint8, of 4 in
  // fp32)
  constexpr int G = 16 / sizeof(T);
  if (ok && S % G == 0 && (3 * S * sizeof(T)) % 16 == 0) {
    const int groups = S / G;
    for (int t = threadIdx.x; t < rows * groups; t += blockDim.x) {
      const int r = t / groups, x0 = (t - r * groups) * G;
      const uint8_t* t0 = s_rgb + 3 * s_rs0[r] * nc;
      const uint8_t* t1 = s_rgb + 3 * s_rs1[r] * nc;
      const float fy = s_fy[r];
      union {
        uint4 word[3];
        T vals[3 * G];
      } pack;
#pragma unroll
      for (int p = 0; p < G; ++p) {
        const int xx = x0 + p, c0 = 3 * s_cs0[xx], c1 = 3 * s_cs1[xx];
        const float fx = s_fx[xx];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float px = blend(t0[c0 + c], t0[c1 + c], t1[c0 + c], t1[c1 + c], fx, fy);
          if constexpr (sizeof(T) == 1) pack.vals[3 * p + c] = quantise(px);
          else pack.vals[3 * p + c] = normalise(px, norm, c);
        }
      }
      uint4* o = reinterpret_cast<uint4*>(out + e0 + (int64_t)r * row_len + 3 * x0);
      o[0] = pack.word[0];
      o[1] = pack.word[1];
      o[2] = pack.word[2];
    }
    return;
  }
  // otherwise (and for a failed image's zeros) value by value, 16 bytes a
  // store inside the band, the unaligned head and tail alone
  constexpr int V = 16 / sizeof(T);
  int64_t a = (e0 + V - 1) / V * V, b = e1 / V * V;
  if (a > e1) a = e1;
  if (b < a) b = a;
  for (int64_t e = e0 + threadIdx.x; e < a; e += blockDim.x) out[e] = value(e);
  for (int64_t e = b + threadIdx.x; e < e1; e += blockDim.x) out[e] = value(e);
  for (int64_t v = a / V + threadIdx.x; v < b / V; v += blockDim.x) {
    union {
      uint4 word;
      T vals[V];
    } pack;
#pragma unroll
    for (int k = 0; k < V; ++k) pack.vals[k] = value(v * V + k);
    reinterpret_cast<uint4*>(out)[v] = pack.word;
  }
}

// Dynamic shared memory of one planes_crop_kernel block: the staged
// planes, the column and row tables and the band's RGB (at most 2R x 2S
// cells)
size_t planes_crop_smem(int S, int R) {
  return (size_t)kStageBytes + (size_t)32 * S + (size_t)24 * R + (size_t)12 * R * S;
}

// The band height: 8 rows (at most 16 distinct source rows, chroma_slots'
// warp), fewer where the tables and the RGB would pass 48 KB
int planes_crop_rows(int S) {
  int R = 8;
  while (R > 1 && planes_crop_smem(S, R) - kStageBytes > 48 * 1024) --R;
  return R;
}

}  // namespace

extern "C" {

// Each image's dims[6 * i ..]: width, height, chroma width, chroma height
// and the chroma's subsampling factors hf, vf (0 for a grey image; all 0
// where status is -1). Returns 0, or a cudaError_t / kStatusBase +
// nvjpegStatus_t when no codec could be made.
int bvt_jpeg_info(const uint8_t* const* datas, const uint64_t* lens, int n, int* dims,
                  int* status) {
  Held held;
  if (held.err) return held.err;
  for (int i = 0; i < n; ++i) {
    int components = 0;
    nvjpegChromaSubsampling_t css;
    int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegStatus_t s = nvjpegGetImageInfo(held.codec.handle, datas[i], (size_t)lens[i],
                                          &components, &css, ws, hs);
    int hf = 0, vf = 0;
    switch (css) {
      case NVJPEG_CSS_444: hf = 1; vf = 1; break;
      case NVJPEG_CSS_422: hf = 2; vf = 1; break;
      case NVJPEG_CSS_420: hf = 2; vf = 2; break;
      case NVJPEG_CSS_440: hf = 1; vf = 2; break;
      case NVJPEG_CSS_411: hf = 4; vf = 1; break;
      case NVJPEG_CSS_410: hf = 4; vf = 2; break;
      default: break;
    }
    bool ok = s == NVJPEG_STATUS_SUCCESS && ws[0] > 0 && hs[0] > 0 &&
              (components == 1 ||
               (components == 3 && hf > 0 && ws[1] > 0 && hs[1] > 0 && ws[1] == ws[2] &&
                hs[1] == hs[2]));
    int* d = dims + 6 * i;
    d[0] = ok ? ws[0] : 0;
    d[1] = ok ? hs[0] : 0;
    d[2] = ok && components == 3 ? ws[1] : 0;
    d[3] = ok && components == 3 ? hs[1] : 0;
    d[4] = ok && components == 3 ? hf : 0;
    d[5] = ok && components == 3 ? vf : 0;
    status[i] = ok ? 0 : -1;
  }
  return 0;
}

// Decode every image whose status is 0 into base + offsets[i] (device,
// its planes packed: Y [h, w], then Cb and Cr [ch, cw] where dims has
// them) on `stream`, and write its row of `meta` ([n, 10] int64, host,
// pinned by the caller: Img's layout, the output address 0); an image
// nvJPEG refuses gets status -1 and a row of zeros (its crop is zeros).
// Returns 0, or an error as bvt_jpeg_info.
int bvt_jpeg_decode(const uint8_t* const* datas, const uint64_t* lens, int n, uint8_t* base,
                    const int64_t* offsets, const int* dims, int* status, int64_t* meta,
                    void* stream) {
  Held held;
  if (held.err) return held.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    int64_t* m = meta + 10 * (size_t)i;
    for (int k = 0; k < 10; ++k) m[k] = 0;
    if (status[i] != 0) continue;
    const int* d = dims + 6 * i;
    nvjpegImage_t img{};
    img.channel[0] = base + offsets[i];
    img.pitch[0] = (size_t)d[0];
    if (d[4] > 0) {
      img.channel[1] = img.channel[0] + (size_t)d[0] * d[1];
      img.channel[2] = img.channel[1] + (size_t)d[2] * d[3];
      img.pitch[1] = img.pitch[2] = (size_t)d[2];
    }
    nvjpegStatus_t st = nvjpegDecode(held.codec.handle, held.codec.state, datas[i],
                                     (size_t)lens[i], NVJPEG_OUTPUT_UNCHANGED, &img, s);
    cudaError_t sync = cudaStreamSynchronize(s);
    if (sync != cudaSuccess) return (int)sync;
    if (st != NVJPEG_STATUS_SUCCESS) {
      status[i] = -1;
      continue;
    }
    m[0] = (int64_t)(uintptr_t)img.channel[0];
    m[1] = (int64_t)(uintptr_t)img.channel[1];
    m[2] = (int64_t)(uintptr_t)img.channel[2];
    for (int k = 0; k < 6; ++k) m[4 + k] = d[k];
  }
  return (int)cudaGetLastError();
}

// Interleaved RGB from n images' planes (meta: device, [n, 10] int64, as
// ycc_rgb_kernel reads it; each output 16-byte aligned) on `stream`;
// max_pixels is the largest w * h.
int bvt_ycc_to_rgb(const int64_t* meta, int n, int64_t max_pixels, void* stream) {
  if (n == 0 || max_pixels == 0) return 0;
  const int threads = 256;
  const int64_t groups = (max_pixels + 3) / 4;
  dim3 grid((unsigned)((groups + threads - 1) / threads), n);
  ycc_rgb_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(meta, n);
  return (int)cudaGetLastError();
}

// The crops [n, S, S, 3] from n device RGB images: meta (device, [3, n]
// int64) holds their addresses, widths and heights (width 0 = a failed
// decode: zeros); uint8 into out_u8 or fp32 into out (the other null); mean
// and stdv [3] are read here, on the host.
int bvt_resize_crop(const int64_t* meta, int n, int S, int square, const float* mean,
                    const float* stdv, float* out, uint8_t* out_u8, void* stream) {
  if (n == 0) return 0;
  Norm norm;
  for (int c = 0; c < 3; ++c) {
    norm.mean[c] = mean ? mean[c] : 0.0f;
    norm.stdv[c] = stdv ? stdv[c] : 1.0f;
  }
  const int threads = 256;
  dim3 grid((S * S + threads - 1) / threads, n);
  resize_crop_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      meta, n, S, square, norm, out, out_u8);
  return (int)cudaGetLastError();
}

// The crops [n, S, S, 3] straight from n images' planes (meta: device,
// [n, 10] int64, bvt_jpeg_decode's rows; a row of zeros: a failed decode,
// zeros), uint8 into out_u8 or fp32 into out (the other null, the one
// given 16-byte aligned); mean and stdv [3] are read here, on the host.
int bvt_planes_crop(const int64_t* meta, int n, int S, int square, const float* mean,
                    const float* stdv, float* out, uint8_t* out_u8, void* stream) {
  if (n == 0) return 0;
  if (S <= 0 || 2 * S > 65535) return (int)cudaErrorInvalidValue;
  Norm norm;
  for (int c = 0; c < 3; ++c) {
    norm.mean[c] = mean ? mean[c] : 0.0f;
    norm.stdv[c] = stdv ? stdv[c] : 1.0f;
  }
  const int R = planes_crop_rows(S);
  const size_t smem = planes_crop_smem(S, R);
  dim3 grid((S + R - 1) / R, n);
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (out_u8) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(planes_crop_kernel<uint8_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    planes_crop_kernel<uint8_t><<<grid, threads, smem, st>>>(meta, S, R, square, norm,
                                                             out_u8);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(planes_crop_kernel<float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    planes_crop_kernel<float><<<grid, threads, smem, st>>>(meta, S, R, square, norm, out);
  }
  return (int)cudaGetLastError();
}

// planes_crop_kernel's resources at size S (uint8 out if u8, else fp32):
// out[0..3] = registers a thread, local memory bytes a thread, dynamic
// shared memory bytes a block, resident blocks an SM
int bvt_planes_crop_resources(int S, int u8, int* out) {
  cudaFuncAttributes attr;
  const void* fn = u8 ? (const void*)planes_crop_kernel<uint8_t>
                      : (const void*)planes_crop_kernel<float>;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = planes_crop_smem(S, planes_crop_rows(S));
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 256, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return (int)err;
}

const char* bvt_error_string(int err) {
  if (err >= kStatusBase) {
    switch (err - kStatusBase) {
      case NVJPEG_STATUS_NOT_INITIALIZED: return "nvJPEG: not initialized";
      case NVJPEG_STATUS_INVALID_PARAMETER: return "nvJPEG: invalid parameter";
      case NVJPEG_STATUS_BAD_JPEG: return "nvJPEG: bad JPEG";
      case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "nvJPEG: JPEG not supported";
      case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "nvJPEG: allocator failure";
      case NVJPEG_STATUS_EXECUTION_FAILED: return "nvJPEG: execution failed";
      case NVJPEG_STATUS_ARCH_MISMATCH: return "nvJPEG: architecture mismatch";
      case NVJPEG_STATUS_INTERNAL_ERROR: return "nvJPEG: internal error";
      default: return "nvJPEG: unknown status";
    }
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
