// link: -ljpeg -lpthread
//
// Batched JPEG decode to RGB on the host with libjpeg, the port's copy of
// decode_rgb in native/bvt_io.cc (JCS_RGB, the library's default DCT and
// fancy upsampling, the same error handling): the CPU lane of
// data/native_io.py. A truncated stream decodes with libjpeg's warning and
// a grey remainder (status 0); any error (not a JPEG, a CMYK image, which
// JCS_RGB cannot take) is status -1.
//
// Built only when a caller asks for the CPU lane (the card's lane decodes
// with nvJPEG, csrc/jpeg_decode.cu); the resize and crop that follow are
// native_io.resize_crop_reference, in plain PyTorch.
//
// bvt_jpeg_planes_cpu gives libjpeg's planes before its colour stage
// (raw_data_out: Y, Cb and Cr at their stored resolutions), as the card's
// lane takes them from nvJPEG: the tests hold the plain colour stage
// (native_io.ycc_to_rgb_reference) on them to libjpeg's own RGB. A grey
// or YCbCr image only (others status -1); the chroma planes must share
// their sampling factors, and luma must have the largest.

#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>  // after stddef.h and stdio.h, which it needs
#include <pthread.h>
#include <setjmp.h>

#include <algorithm>
#include <vector>

extern "C" {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = (JpegErr*)cinfo->err;
  longjmp(err->jb, 1);
}

// Decode one JPEG into a malloc'ed RGB buffer (*rgb, w * h * 3 bytes, row
// after row). Returns 0, or nonzero with nothing allocated.
static int decode_rgb(const uint8_t* data, size_t len, uint8_t** rgb, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  uint8_t* volatile buf = nullptr;  // freed on a longjmp
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  buf = (uint8_t*)malloc((size_t)(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *rgb = buf;
  return 0;
}

// Decode one JPEG into a malloc'ed buffer of its planes (*out: Y [h, w],
// then Cb and Cr [ch, cw] for a colour image) and dims[6]: w, h, cw, ch and
// the chroma's subsampling factors hf, vf (0 for grey). Returns 0, or
// nonzero with nothing allocated.
static int decode_planes(const uint8_t* data, size_t len, uint8_t** out, int* dims) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  uint8_t* volatile buf = nullptr;  // freed on a longjmp
  std::vector<uint8_t> rows;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  const int nc = cinfo.num_components;
  jpeg_component_info* comp = cinfo.comp_info;
  bool colour = nc == 3 && cinfo.jpeg_color_space == JCS_YCbCr &&
                comp[0].h_samp_factor == cinfo.max_h_samp_factor &&
                comp[0].v_samp_factor == cinfo.max_v_samp_factor &&
                comp[1].h_samp_factor == comp[2].h_samp_factor &&
                comp[1].v_samp_factor == comp[2].v_samp_factor &&
                cinfo.max_h_samp_factor % comp[1].h_samp_factor == 0 &&
                cinfo.max_v_samp_factor % comp[1].v_samp_factor == 0;
  if (!colour && !(nc == 1 && cinfo.jpeg_color_space == JCS_GRAYSCALE)) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  const int w = comp[0].downsampled_width, h = comp[0].downsampled_height;
  const int cw = colour ? (int)comp[1].downsampled_width : 0;
  const int ch = colour ? (int)comp[1].downsampled_height : 0;
  dims[0] = w;
  dims[1] = h;
  dims[2] = cw;
  dims[3] = ch;
  dims[4] = colour ? cinfo.max_h_samp_factor / comp[1].h_samp_factor : 0;
  dims[5] = colour ? cinfo.max_v_samp_factor / comp[1].v_samp_factor : 0;
  buf = (uint8_t*)malloc((size_t)w * h + 2 * (size_t)cw * ch);
  // one iMCU row of each component: v_samp * 8 rows of width_in_blocks * 8
  const int dct = DCTSIZE;
  JSAMPROW ptrs[3][4 * DCTSIZE];
  JSAMPARRAY arrays[3];
  size_t total = 0, at[3];
  for (int c = 0; c < nc; ++c) {
    at[c] = total;
    total += (size_t)comp[c].v_samp_factor * dct * comp[c].width_in_blocks * dct;
  }
  rows.resize(total);
  for (int c = 0; c < nc; ++c) {
    for (int r = 0; r < comp[c].v_samp_factor * dct; ++r)
      ptrs[c][r] = rows.data() + at[c] + (size_t)r * comp[c].width_in_blocks * dct;
    arrays[c] = ptrs[c];
  }
  const size_t plane_at[3] = {0, (size_t)w * h, (size_t)w * h + (size_t)cw * ch};
  for (int imcu = 0; cinfo.output_scanline < cinfo.output_height; ++imcu) {
    jpeg_read_raw_data(&cinfo, arrays, (JDIMENSION)(cinfo.max_v_samp_factor * dct));
    for (int c = 0; c < nc; ++c) {
      const int pw = c == 0 ? w : cw, ph = c == 0 ? h : ch;
      const int n_rows = comp[c].v_samp_factor * dct;
      for (int r = 0; r < n_rows; ++r) {
        const int y = imcu * n_rows + r;
        if (y >= ph) break;
        memcpy(buf + plane_at[c] + (size_t)y * pw, ptrs[c][r], (size_t)pw);
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  return 0;
}

struct DecodeTask {
  const uint8_t* const* datas;
  const uint64_t* lens;
  uint8_t** outs;  // [n] out: malloc'ed RGB or planes (null where status != 0)
  int* widths;     // [n] out (RGB)
  int* heights;    // [n] out (RGB)
  int* dims;       // [n, 6] out (planes; null for RGB)
  int* status;     // [n] out: 0 or -1
  int n;
  int next;  // shared work index
  pthread_mutex_t mu;
};

static void* worker(void* arg) {
  DecodeTask* t = (DecodeTask*)arg;
  for (;;) {
    pthread_mutex_lock(&t->mu);
    int i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->n) return nullptr;
    t->outs[i] = nullptr;
    if (t->dims) {
      int* d = t->dims + 6 * i;
      for (int k = 0; k < 6; ++k) d[k] = 0;
      t->status[i] = decode_planes(t->datas[i], t->lens[i], &t->outs[i], d) ? -1 : 0;
      continue;
    }
    t->widths[i] = t->heights[i] = 0;
    int w = 0, h = 0;
    if (decode_rgb(t->datas[i], t->lens[i], &t->outs[i], &w, &h) != 0) {
      t->status[i] = -1;
      continue;
    }
    t->widths[i] = w;
    t->heights[i] = h;
    t->status[i] = 0;
  }
}

static int run(DecodeTask* t, int num_threads) {
  t->next = 0;
  pthread_mutex_init(&t->mu, nullptr);
  int nt = std::max(1, std::min(num_threads, t->n));
  std::vector<pthread_t> threads((size_t)nt);
  for (int i = 0; i < nt; ++i) pthread_create(&threads[i], nullptr, worker, t);
  for (int i = 0; i < nt; ++i) pthread_join(threads[i], nullptr);
  pthread_mutex_destroy(&t->mu);
  int ok = 0;
  for (int i = 0; i < t->n; ++i) ok += (t->status[i] == 0);
  return ok;
}

// Decode n JPEGs over min(num_threads, n) threads. Returns the number
// decoded; each rgbs[i] with status 0 is freed by bvt_jpeg_free.
int bvt_jpeg_decode_cpu(const uint8_t* const* datas, const uint64_t* lens, int n,
                        uint8_t** rgbs, int* widths, int* heights, int* status,
                        int num_threads) {
  DecodeTask t{};
  t.datas = datas;
  t.lens = lens;
  t.outs = rgbs;
  t.widths = widths;
  t.heights = heights;
  t.status = status;
  t.n = n;
  return run(&t, num_threads);
}

// The planes of n JPEGs (decode_planes) over min(num_threads, n) threads:
// planes[i] (freed by bvt_jpeg_free) and dims[6 * i ..]. Returns the number
// decoded.
int bvt_jpeg_planes_cpu(const uint8_t* const* datas, const uint64_t* lens, int n,
                        uint8_t** planes, int* dims, int* status, int num_threads) {
  DecodeTask t{};
  t.datas = datas;
  t.lens = lens;
  t.outs = planes;
  t.dims = dims;
  t.status = status;
  t.n = n;
  return run(&t, num_threads);
}

void bvt_jpeg_free(uint8_t* rgb) { free(rgb); }

}  // extern "C"
