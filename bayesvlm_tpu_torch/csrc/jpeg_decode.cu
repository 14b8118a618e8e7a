// link: -lnvjpeg
//
// JPEG bitstreams to model-ready crops on the card: nvJPEG decodes each
// image to its planes (the IDCT's samples, chroma at its stored
// resolution), ycc_rgb_kernel, written here, upsamples the chroma and
// converts to interleaved RGB as libjpeg does, and resize_crop_kernel,
// written here too, samples the crops from it.
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
// caller's stream; no EXIF orientation is applied, as libjpeg applies
// none. Each concurrent caller takes its own handle and state from a pool
// (a state must not be shared between threads), and the stream is
// synchronised after each image, before the state's buffers are reused by
// the next.
//
// ycc_rgb_kernel: libjpeg-turbo 2.1's colour stage, integer for integer,
// so that what is left between the two decoders is their IDCTs (nvJPEG's
// own RGBI output upsamples chroma by replication and converts in another
// rounding: 4:2:0 RGB up to 15 apart). Chroma upsampling as jdsample.c
// with fancy upsampling on (libjpeg's default): h2v1 and h2v2 triangular
// where the chroma plane is wider than 2 samples, h1v2 triangular, and
// replication otherwise (4:4:4, 4:1:1, ...); the image's edges repeat the
// edge sample, as libjpeg's context rows and first / last columns do. Then
// jdcolor.c's ycc_rgb_convert: R = Y + Cr_r[Cr], G = Y + ((Cb_g[Cb] +
// Cr_g[Cr]) >> 16), B = Y + Cb_b[Cb], its 16-bit fixed-point tables and
// rounding, clamped to [0, 255]; a grey image gives R = G = B = Y. Plain
// version: native_io.ycc_to_rgb_reference. One thread an output pixel;
// the planes' addresses and sizes come in one [10, n] int64 array. Bound:
// bytes (the planes read once, the RGB written once).
//
// resize_crop_kernel: bilinear sampling of each [S, S, 3] crop, either the
// shorter side resized to S and the centre cropped (CLIP) or a square
// resize (SigLIP), written as uint8 (+0.5, clamp to [0, 255], truncate) or
// as fp32 ((px / 255 - mean) / std). It reproduces bilinear() and
// process_one operation for operation: the `w - 1.001f` clamp, truncation
// to x0, the +1 neighbours clamped to the edge, and every float32 operation
// in the same order, each rounded on its own (__fadd_rn / __fmul_rn /
// __fdiv_rn: nvcc would otherwise contract a + (b - a) * f into an FMA), so
// it is bit-equal to its plain version (native_io.resize_crop_reference).
//
// What bounds it on an H100: bytes. The Stage-1 lane's batch (B = 64 of the
// test fixtures, 54 decoded, 16.5 MB of RGB, 13.1 MB of it in the rows and
// columns the crops sample) -> 224 crops writes 9.6 MB of uint8 (38.5 MB
// fp32): 6.8 us (15.4 us) at 3.35 TB/s; its ~20 fp32 operations an output
// value are far below the fp32 rate. Design: one
// thread an output pixel, its three channels; the sources' addresses and
// sizes come in one [3, n] int64 array; the four neighbours are read where
// the sample falls. Its time against that bound is in PERF.md
// (chip_smoke.py); speed is later work.

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

// One chroma sample of the upsampled plane at output (x, y): c is [ch, cw],
// (hf, vf) the image's subsampling factors (jdsample.c, fancy on)
__device__ __forceinline__ int chroma_at(const uint8_t* __restrict__ c, int cw, int ch,
                                         int hf, int vf, int x, int y) {
  if (hf == 2 && vf == 2 && cw > 2) {  // h2v2_fancy_upsample
    const int j = y >> 1, nb = (y & 1) ? min(j + 1, ch - 1) : max(j - 1, 0);
    const int i = x >> 1, k = (x & 1) ? min(i + 1, cw - 1) : max(i - 1, 0);
    const int self = 3 * c[j * cw + i] + c[nb * cw + i];
    const int side = 3 * c[j * cw + k] + c[nb * cw + k];
    return (3 * self + side + ((x & 1) ? 7 : 8)) >> 4;
  }
  if (hf == 2 && vf == 1 && cw > 2) {  // h2v1_fancy_upsample
    const int i = x >> 1, k = (x & 1) ? min(i + 1, cw - 1) : max(i - 1, 0);
    return (3 * c[y * cw + i] + c[y * cw + k] + ((x & 1) ? 2 : 1)) >> 2;
  }
  if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
    const int j = y >> 1, nb = (y & 1) ? min(j + 1, ch - 1) : max(j - 1, 0);
    return (3 * c[j * cw + x] + c[nb * cw + x] + ((y & 1) ? 2 : 1)) >> 2;
  }
  return c[min(y / vf, ch - 1) * cw + min(x / hf, cw - 1)];  // replication
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// meta [10, n] int64: each image's Y, Cb and Cr planes, its RGB output,
// width, height, chroma width and height, and factors hf, vf (0: grey;
// width 0: a failed decode, skipped)
__global__ void ycc_rgb_kernel(const int64_t* __restrict__ meta, int n) {
  const int i = blockIdx.y;
  const int w = (int)meta[4 * n + i], h = (int)meta[5 * n + i];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= w * h) return;
  const int y = p / w, x = p - y * w;
  const uint8_t* Y = reinterpret_cast<const uint8_t*>(meta[i]);
  uint8_t* out = reinterpret_cast<uint8_t*>(meta[3 * n + i]) + (size_t)p * 3;
  const int luma = Y[p];
  const int hf = (int)meta[8 * n + i], vf = (int)meta[9 * n + i];
  if (hf == 0) {  // grey: JCS_GRAYSCALE -> JCS_RGB
    out[0] = out[1] = out[2] = (uint8_t)luma;
    return;
  }
  const int cw = (int)meta[6 * n + i], ch = (int)meta[7 * n + i];
  const int cb = chroma_at(reinterpret_cast<const uint8_t*>(meta[n + i]), cw, ch, hf, vf,
                           x, y) - 128;
  const int cr = chroma_at(reinterpret_cast<const uint8_t*>(meta[2 * n + i]), cw, ch, hf,
                           vf, x, y) - 128;
  // jdcolor.c's tables: Cr_r, Cb_b rounded; Cb_g carries the ONE_HALF
  out[0] = clamp255(luma + ((kCrR * cr + 32768) >> 16));
  out[1] = clamp255(luma + ((-kCbG * cb + 32768 - kCrG * cr) >> 16));
  out[2] = clamp255(luma + ((kCbB * cb + 32768) >> 16));
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
  const float fS = (float)S, fw = (float)w, fh = (float)h;
  float sx, sy;
  if (square) {  // (xx + 0.5f) * w / S - 0.5f
    sx = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn((float)xx, 0.5f), fw), fS), 0.5f);
    sy = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn((float)yy, 0.5f), fh), fS), 0.5f);
  } else {  // shorter side to S, centre crop: (xx + ox + 0.5f) * scale - 0.5f
    const float scale = (w <= h) ? __fdiv_rn(fw, fS) : __fdiv_rn(fh, fS);
    const float ox = __fmul_rn(__fsub_rn(__fdiv_rn(fw, scale), fS), 0.5f);
    const float oy = __fmul_rn(__fsub_rn(__fdiv_rn(fh, scale), fS), 0.5f);
    sx = __fsub_rn(__fmul_rn(__fadd_rn(__fadd_rn((float)xx, ox), 0.5f), scale), 0.5f);
    sy = __fsub_rn(__fmul_rn(__fadd_rn(__fadd_rn((float)yy, oy), 0.5f), scale), 0.5f);
  }
  // bilinear(): clamp, truncate, neighbours clamped to the edge
  const float x = fmax0_std(fmin_std(sx, __fsub_rn(fw, 1.001f)));
  const float y = fmax0_std(fmin_std(sy, __fsub_rn(fh, 1.001f)));
  const int x0 = (int)x, y0 = (int)y;
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const float fx = __fsub_rn(x, (float)x0), fy = __fsub_rn(y, (float)y0);
  const uint8_t* src = reinterpret_cast<const uint8_t*>(meta[i]);
  const uint8_t* p00 = src + ((size_t)y0 * w + x0) * 3;
  const uint8_t* p01 = src + ((size_t)y0 * w + x1) * 3;
  const uint8_t* p10 = src + ((size_t)y1 * w + x0) * 3;
  const uint8_t* p11 = src + ((size_t)y1 * w + x1) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = __fadd_rn((float)p00[c], __fmul_rn((float)(p01[c] - p00[c]), fx));
    const float b = __fadd_rn((float)p10[c], __fmul_rn((float)(p11[c] - p10[c]), fx));
    const float px = __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), fy));
    if (out_u8) {
      const float v = __fadd_rn(px, 0.5f);
      out_u8[off + c] = (uint8_t)__float2int_rz(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
    } else {
      out[off + c] = __fdiv_rn(__fsub_rn(__fdiv_rn(px, 255.0f), norm.mean[c]), norm.stdv[c]);
    }
  }
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

// Decode every image whose status is 0 into outs[i] (device, its planes
// packed: Y [h, w], then Cb and Cr [ch, cw] where dims has them) on
// `stream`; an image nvJPEG refuses gets status -1 (its buffer is left as
// it is: the crop of a failed image is zeros). Returns 0, or an error as
// bvt_jpeg_info.
int bvt_jpeg_decode(const uint8_t* const* datas, const uint64_t* lens, int n,
                    uint8_t* const* outs, const int* dims, int* status, void* stream) {
  Held held;
  if (held.err) return held.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    if (status[i] != 0) continue;
    const int* d = dims + 6 * i;
    nvjpegImage_t img{};
    img.channel[0] = outs[i];
    img.pitch[0] = (size_t)d[0];
    if (d[4] > 0) {
      img.channel[1] = outs[i] + (size_t)d[0] * d[1];
      img.channel[2] = img.channel[1] + (size_t)d[2] * d[3];
      img.pitch[1] = img.pitch[2] = (size_t)d[2];
    }
    nvjpegStatus_t st = nvjpegDecode(held.codec.handle, held.codec.state, datas[i],
                                     (size_t)lens[i], NVJPEG_OUTPUT_UNCHANGED, &img, s);
    cudaError_t sync = cudaStreamSynchronize(s);
    if (sync != cudaSuccess) return (int)sync;
    if (st != NVJPEG_STATUS_SUCCESS) status[i] = -1;
  }
  return (int)cudaGetLastError();
}

// Interleaved RGB from n images' planes (meta: device, [10, n] int64, as
// ycc_rgb_kernel reads it) on `stream`; max_pixels is the largest w * h.
int bvt_ycc_to_rgb(const int64_t* meta, int n, int64_t max_pixels, void* stream) {
  if (n == 0 || max_pixels == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((max_pixels + threads - 1) / threads), n);
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
