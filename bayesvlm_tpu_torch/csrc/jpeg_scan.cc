// The entropy-coded scan of a JPEG cut off mid-stream, walked as
// libjpeg-turbo 2.1 walks it, so that the card's lane (nvJPEG, which fills
// the rest of a cut image otherwise) can be patched to libjpeg's pixels:
// the JAX lane decodes with libjpeg (native/bvt_io.cc), and a web crawl's
// tars carry cut files.
//
// What libjpeg does past the cut (jdhuff.c, jdmarker.c, jdatasrc.c):
//   - the memory source answers a read past the buffer with a fake EOI
//     (FF D9, again at every further read);
//   - jpeg_fill_bit_buffer stops at a marker; once a request needs more
//     bits than are left it sets `insufficient_data` and pads zero bits,
//     so the MCU in which the data ran out is decoded to its end on zeros;
//   - decode_mcu leaves every later MCU's coefficients at zero: those
//     blocks come out of the IDCT as uniform grey (128);
//   - process_restart throws the buffer's bits away, resets the DC
//     predictors and clears the flag only when the next marker was the
//     expected RSTn (jpeg_resync_to_restart leaves the fake EOI unread).
// This file reproduces that for a sequential Huffman file with one scan
// that holds every component (SOF0 / SOF1, 8-bit: what libjpeg, PIL and
// cameras write), through the slow decoder's path (the fast path gives the
// same bits and hands the MCU to the slow path at a marker). The MCU in
// which the data ran out is returned with its blocks' dequantised
// coefficients and the samples from there back to the start of its
// restart interval (the MCU alone without restart markers):
// jidctint.c's jpeg_idct_islow, integer for integer (libjpeg's default DCT
// method, the JAX lane's), clamped as its range_limit table clamps. nvJPEG
// decodes a cut stream up to the cut but refuses one with restart markers
// (status -1, where libjpeg gives 0; NVIDIA H100, CUDA 12.9): for those the
// walk also writes a complete stream, the intervals before the cut's kept
// and all-zero MCUs after, which nvJPEG decodes and the patch overwrites.
//
// bvt_jpeg_cut: which files to walk, by a backwards scan from the end: a
// file whose last marker (trailing bytes after it ignored, RSTn skipped)
// is an EOI is complete and costs a few bytes' look. bvt_jpeg_walk: the
// walk of one file, into a BvtCut record (data/native_io.py reads it with
// ctypes and patches the planes). A progressive or arithmetic-coded file,
// one whose first scan lacks a component, or anything this parser does
// not take, is kind 2, "not covered", and decodes as nvJPEG decodes it.
//
// Host code with no dependency but the C++ standard library: the card's
// machine has no libjpeg.

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <vector>

namespace {

constexpr int kComplete = 0, kRanOut = 1, kNotCovered = 2;
constexpr int kMinGetBits = 57;  // BIT_BUF_SIZE - 7 with a 64-bit bit buffer

// jutils.c's jpeg_natural_order, with the 16 extra entries that catch a
// run past the block's end in corrupt data
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffTable {  // jdhuff.c's d_derived_tbl, without the lookahead
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  int zero_code = 0, zero_len = 0;  // symbol 0 (DC: no difference; AC: EOB), 0: none
};

struct Component {
  int id, h, v, tq;
  int td, ta;  // Huffman tables of the scan
};

// A byte stream as the memory source gives it: the buffer, then FF D9
// repeated (fill_mem_input_buffer's fake EOI)
struct Source {
  const uint8_t* data;
  size_t len, pos;
  int byte() {
    size_t p = pos++;
    if (p < len) return data[p];
    return ((p - len) & 1) ? 0xD9 : 0xFF;
  }
};

// jpeg_make_d_derived_tbl; false where libjpeg would refuse the table
bool derive(const uint8_t* bits, const uint8_t* vals, int count, bool dc, HuffTable* t) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
  }
  if (p != count) return false;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      t->valoffset[l] = p - huffcode[p];
      p += bits[l - 1];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  t->zero_len = 0;
  for (int i = count - 1; i >= 0; --i) {
    if (vals[i] == 0) {
      t->zero_code = huffcode[i];
      t->zero_len = huffsize[i];
    }
  }
  memset(t->huffval, 0, sizeof t->huffval);
  memcpy(t->huffval, vals, (size_t)count);
  if (dc) {
    for (int i = 0; i < count; ++i)
      if (vals[i] > 15) return false;
  }
  t->defined = true;
  return true;
}

// jidctint.c's range_limit: sample_range_limit + CENTERJSAMPLE, indexed
// by (x & RANGE_MASK)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; ++v) {
      if (v < 128) t[v] = (uint8_t)(v + 128);
      else if (v < 512) t[v] = 255;
      else if (v < 896) t[v] = 0;
      else t[v] = (uint8_t)(v - 896);
    }
  }
};

const RangeLimit kRange;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// jidctint.c jpeg_idct_islow: dequantised coefficients (natural order) ->
// an 8 x 8 block of samples, row stride `stride`
void idct_islow(const int32_t* dq, uint8_t* out, int stride) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                    F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                    F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    const int32_t* in = dq + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      const int dcval = (int)((int64_t)in[0] * (1 << P1));
      for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
      continue;
    }
    int64_t z2 = in[16], z3 = in[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = in[0];
    z3 = in[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = (int)descale(tmp10 + tmp3, CB - P1);
    w[56] = (int)descale(tmp10 - tmp3, CB - P1);
    w[8] = (int)descale(tmp11 + tmp2, CB - P1);
    w[48] = (int)descale(tmp11 - tmp2, CB - P1);
    w[16] = (int)descale(tmp12 + tmp1, CB - P1);
    w[40] = (int)descale(tmp12 - tmp1, CB - P1);
    w[24] = (int)descale(tmp13 + tmp0, CB - P1);
    w[32] = (int)descale(tmp13 - tmp0, CB - P1);
  }
  const uint8_t* rl = kRange.t;
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      const uint8_t dcval = rl[(int)descale(w[0], P1 + 3) & 1023];
      for (int k = 0; k < 8; ++k) o[k] = dcval;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CB);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CB);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB + P1 + 3;
    o[0] = rl[(int)descale(tmp10 + tmp3, S) & 1023];
    o[7] = rl[(int)descale(tmp10 - tmp3, S) & 1023];
    o[1] = rl[(int)descale(tmp11 + tmp2, S) & 1023];
    o[6] = rl[(int)descale(tmp11 - tmp2, S) & 1023];
    o[2] = rl[(int)descale(tmp12 + tmp1, S) & 1023];
    o[5] = rl[(int)descale(tmp12 - tmp1, S) & 1023];
    o[3] = rl[(int)descale(tmp13 + tmp0, S) & 1023];
    o[4] = rl[(int)descale(tmp13 - tmp0, S) & 1023];
  }
}

// jdhuff.c's bit reader, slow path: get_buffer / bits_left, the marker
// that stopped it, and the out-of-data flag
struct BitReader {
  Source* src;
  uint64_t buf = 0;
  int bits = 0;
  int unread_marker = 0;
  size_t marker_at = 0;  // where the unread marker's FF lies
  bool insufficient = false;

  // jpeg_fill_bit_buffer
  void fill(int nbits) {
    if (unread_marker == 0) {
      while (bits < kMinGetBits) {
        int c = src->byte();
        if (c == 0xFF) {
          do {
            c = src->byte();
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            marker_at = src->pos - 2;
            goto no_more_bytes;
          }
        }
        buf = (buf << 8) | (uint64_t)c;
        bits += 8;
      }
      return;
    }
  no_more_bytes:
    if (nbits > bits) {
      insufficient = true;
      buf <<= kMinGetBits - bits;
      bits = kMinGetBits;
    }
  }
  int get(int n) {  // CHECK_BIT_BUFFER + GET_BITS
    if (n == 0) return 0;
    if (bits < n) fill(n);
    bits -= n;
    return (int)((buf >> bits) & ((((uint64_t)1) << n) - 1));
  }
  // jpeg_huff_decode from one bit (HUFF_DECODE gives the same symbol with
  // the same bits taken, and needs a bit past the data only where this does)
  int decode(const HuffTable& t) {
    int l = 1;
    int32_t code = get(1);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;
    return t.huffval[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) {  // HUFF_EXTEND
  return r < (1 << (s - 1)) ? r + (int)((uint32_t)-1 << s) + 1 : r;
}

// Entropy-coded bytes, most significant bit first, 0xFF stuffed with 0x00
struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;
  int n = 0;
  void put(int code, int len) {
    for (int k = len - 1; k >= 0; --k) {
      acc = (acc << 1) | ((code >> k) & 1);
      if (++n == 8) emit();
    }
  }
  void emit() {
    out->push_back((uint8_t)acc);
    if (acc == 0xFF) out->push_back(0);
    acc = 0;
    n = 0;
  }
  void pad() {  // to a byte with 1 bits, as encoders do before a marker
    while (n) put(1, 1);
  }
};

// jdmarker.c next_marker on the stream
int next_marker(Source* s) {
  for (;;) {
    int c = s->byte();
    while (c != 0xFF) c = s->byte();
    do {
      c = s->byte();
    } while (c == 0xFF);
    if (c != 0) return c;
  }
}

}  // namespace

extern "C" {

// One walked file. kind: 0 complete (nothing to patch), 1 the data ran out
// in MCU `mcu` (patch), 2 not covered. For kind 1: the MCU grid
// (mcus_per_row x mcu_rows; one block an MCU in a one-component scan),
// each frame component's blocks in an MCU (h x v, in frame order: Y, Cb,
// Cr), the MCU's blocks in scan order (frame component, column and row in
// the MCU) with their dequantised coefficients (natural order), and the
// samples of MCUs first..mcu (libjpeg's islow IDCT): per frame component,
// the band of MCU rows they lie in, (8 v) rows an MCU row of (8 h) x
// mcus_per_row samples, the components one after the other (malloc'ed;
// samples_len bytes). first is mcu, but in a file with restart markers,
// where it is the first MCU of mcu's restart interval: nvJPEG refuses such
// a cut stream, so `repaired` (malloc'ed, repaired_len bytes; 0 where none
// is needed) is a complete stream for it: the bytes up to that interval,
// then every MCU from it on coded as all-zero blocks, restart markers in
// their places, and an EOI. Its MCUs before `first` are the cut file's.
// bvt_jpeg_cut_free releases both buffers.
struct BvtCut {
  int32_t kind, mcu, first, mcus_per_row, mcu_rows, ncomp, blocks;
  int32_t h[4], v[4];
  int32_t block_comp[10], block_x[10], block_y[10];
  int32_t coef[10][64];
  uint8_t* samples;
  int64_t samples_len;
  uint8_t* repaired;
  int64_t repaired_len;
};

// Each file's cut flag: 0 where an EOI follows its last SOS, 1 where none
// does. Read backwards from the end: an EOI met before any SOS is one that
// follows the last SOS (neither occurs inside entropy-coded data, where an
// 0xFF is followed by 0x00 or an RSTn), so a complete file costs the bytes
// after its EOI, whatever they hold (a camera's or phone's trailer), and a
// cut one its last scan. A trailer that holds an SOS after its last EOI
// flags the file, and the walk then finds it complete. Returns the number
// cut.
int bvt_jpeg_cut(const uint8_t* const* datas, const uint64_t* lens, int n, int32_t* cut) {
  int count = 0;
  for (int i = 0; i < n; ++i) {
    const uint8_t* d = datas[i];
    int flag = 1;
    for (int64_t k = (int64_t)lens[i] - 2; k >= 0; --k) {
      if (d[k] != 0xFF || (d[k + 1] != 0xD9 && d[k + 1] != 0xDA)) continue;
      flag = d[k + 1] == 0xDA;
      break;
    }
    cut[i] = flag;
    count += flag;
  }
  return count;
}

int bvt_jpeg_walk(const uint8_t* data, uint64_t len, BvtCut* out) {
  memset(out, 0, sizeof *out);
  out->kind = kNotCovered;
  Source src{data, (size_t)len, 0};
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return out->kind;
  src.pos = 2;
  HuffTable dc[4], ac[4];
  int32_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Component comp[4];
  int ncomp = 0, width = 0, height = 0, restart = 0;
  bool frame = false;
  auto u16 = [&](size_t p) -> int { return p + 1 < len ? (data[p] << 8) | data[p + 1] : -1; };
  // the markers up to the first SOS
  int scan_comp[4], ns = 0;
  for (;;) {
    if (src.pos >= len) return out->kind;
    const int m = next_marker(&src);
    if (m == 0xD8 || m == 0xD9 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return out->kind;
    const size_t at = src.pos;
    const int seg = u16(at);
    if (seg < 2 || at + (size_t)seg > len) return out->kind;
    const size_t end = at + (size_t)seg;
    size_t p = at + 2;
    if (m == 0xC0 || m == 0xC1) {  // baseline / extended sequential, Huffman
      if (frame || seg < 8 || data[p] != 8) return out->kind;
      height = u16(p + 1);
      width = u16(p + 3);
      ncomp = data[p + 5];
      if (height <= 0 || width <= 0 || (ncomp != 1 && ncomp != 3) ||
          seg != 8 + 3 * ncomp)
        return out->kind;
      for (int c = 0; c < ncomp; ++c) {
        const uint8_t* q = data + p + 6 + 3 * c;
        comp[c] = Component{q[0], q[1] >> 4, q[1] & 15, q[2], 0, 0};
        if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 ||
            comp[c].tq > 3)
          return out->kind;
      }
      frame = true;
    } else if (m >= 0xC2 && m <= 0xCF && m != 0xC4) {
      return out->kind;  // progressive, lossless, hierarchical, arithmetic (SOFn, DAC)
    } else if (m == 0xC4) {  // DHT
      while (p < end) {
        if (p + 17 > end) return out->kind;
        const int tc = data[p] >> 4, th = data[p] & 15;
        if (tc > 1 || th > 3) return out->kind;
        const uint8_t* bits = data + p + 1;
        int count = 0;
        for (int l = 0; l < 16; ++l) count += bits[l];
        if (count > 256 || p + 17 + (size_t)count > end) return out->kind;
        if (!derive(bits, data + p + 17, count, tc == 0, tc == 0 ? &dc[th] : &ac[th]))
          return out->kind;
        p += 17 + (size_t)count;
      }
    } else if (m == 0xDB) {  // DQT: zigzag order in the file
      while (p < end) {
        const int pq = data[p] >> 4, tq = data[p] & 15;
        if (tq > 3 || pq > 1 || p + 1 + 64 * (pq + 1) > end) return out->kind;
        for (int i = 0; i < 64; ++i) {
          const int val = pq ? (data[p + 1 + 2 * i] << 8) | data[p + 2 + 2 * i]
                             : data[p + 1 + i];
          quant[tq][kNaturalOrder[i]] = val;
        }
        quant_defined[tq] = true;
        p += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xDD) {  // DRI
      if (seg != 4) return out->kind;
      restart = u16(p);
    } else if (m == 0xDA) {  // SOS
      if (!frame) return out->kind;
      ns = data[p];
      if (ns != ncomp || seg != 6 + 2 * ns) return out->kind;  // one scan, all of them
      for (int s = 0; s < ns; ++s) {
        const int id = data[p + 1 + 2 * s], t = data[p + 2 + 2 * s];
        int c = 0;
        while (c < ncomp && comp[c].id != id) ++c;
        if (c == ncomp) return out->kind;
        for (int e = 0; e < s; ++e)
          if (scan_comp[e] == c) return out->kind;
        comp[c].td = t >> 4;
        comp[c].ta = t & 15;
        if (comp[c].td > 3 || comp[c].ta > 3 || !dc[comp[c].td].defined ||
            !ac[comp[c].ta].defined || !quant_defined[comp[c].tq])
          return out->kind;
        scan_comp[s] = c;
      }
      const size_t q = p + 1 + 2 * ns;
      if (data[q] != 0 || data[q + 1] != 63 || data[q + 2] != 0) return out->kind;
      src.pos = end;
      break;
    }
    src.pos = end;  // APPn, COM and the rest: skipped by their length
  }

  // the MCU grid (jdinput.c per_scan_setup)
  int max_h = 1, max_v = 1;
  for (int c = 0; c < ncomp; ++c) {
    max_h = comp[c].h > max_h ? comp[c].h : max_h;
    max_v = comp[c].v > max_v ? comp[c].v : max_v;
  }
  int mcus_per_row, mcu_rows, blocks = 0;
  int bcomp[10], bx[10], by[10];
  int h[4] = {1, 1, 1, 1}, v[4] = {1, 1, 1, 1};
  if (ns == 1) {
    const int c = scan_comp[0];
    mcus_per_row = (int)(((int64_t)width * comp[c].h + 8 * max_h - 1) / (8 * max_h));
    mcu_rows = (int)(((int64_t)height * comp[c].v + 8 * max_v - 1) / (8 * max_v));
    bcomp[0] = c;
    bx[0] = by[0] = 0;
    blocks = 1;
  } else {
    mcus_per_row = (width + 8 * max_h - 1) / (8 * max_h);
    mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
    for (int s = 0; s < ns; ++s) {
      const int c = scan_comp[s];
      h[c] = comp[c].h;
      v[c] = comp[c].v;
      for (int y = 0; y < comp[c].v; ++y) {
        for (int x = 0; x < comp[c].h; ++x) {
          if (blocks == 10) return out->kind;  // libjpeg: JERR_BAD_MCU_SIZE
          bcomp[blocks] = c;
          bx[blocks] = x;
          by[blocks] = y;
          ++blocks;
        }
      }
    }
  }

  // decode_mcu over the scan; the coefficients of the current restart
  // interval (of the current MCU where there are no restart markers) kept
  BitReader br{&src};
  int last_dc[4] = {0, 0, 0, 0};
  int restarts_to_go = restart, next_restart = 0;
  const int64_t total = (int64_t)mcus_per_row * mcu_rows;
  int64_t ran_out = -1, first = 0;
  size_t prefix = src.pos;  // the bytes before the current interval's marker
  std::vector<int16_t> kept;    // [MCU since `first`][block][64]
  const size_t mcu_coefs = (size_t)blocks * 64;
  for (int64_t mcu = 0; mcu < total; ++mcu) {
    if (restart) {
      if (restarts_to_go == 0) {  // process_restart
        br.bits = 0;
        if (br.unread_marker == 0) {
          br.unread_marker = next_marker(&src);
          br.marker_at = src.pos - 2;
        }
        if (ran_out < 0) {  // up to the marker, or to the data's end, any FF dropped
          prefix = br.marker_at < len ? br.marker_at : len;
          while (prefix > 0 && data[prefix - 1] == 0xFF) --prefix;
        }
        if (br.unread_marker == 0xD0 + next_restart) {
          br.unread_marker = 0;
        } else {  // jpeg_resync_to_restart
          for (;;) {
            const int mk = br.unread_marker, d = next_restart;
            int action;
            if (mk < 0xC0) action = 2;
            else if (mk < 0xD0 || mk > 0xD7) action = 3;
            else if (mk == 0xD0 + ((d + 1) & 7) || mk == 0xD0 + ((d + 2) & 7)) action = 3;
            else if (mk == 0xD0 + ((d - 1) & 7) || mk == 0xD0 + ((d - 2) & 7)) action = 2;
            else action = 1;
            if (action == 1) {
              br.unread_marker = 0;
              break;
            }
            if (action == 3) break;
            br.unread_marker = next_marker(&src);
            br.marker_at = src.pos - 2;
          }
        }
        next_restart = (next_restart + 1) & 7;
        for (int s = 0; s < 4; ++s) last_dc[s] = 0;
        restarts_to_go = restart;
        if (br.unread_marker == 0) {
          if (ran_out >= 0) return out->kind;  // a second segment of data: not covered
          br.insufficient = false;
        }
        if (ran_out < 0) {
          first = mcu;
          kept.clear();
        }
      }
    }
    if (!br.insufficient) {
      if (!restart) {
        first = mcu;
        kept.clear();
      }
      kept.resize(kept.size() + mcu_coefs, 0);
      int16_t* coef = kept.data() + kept.size() - mcu_coefs;
      for (int b = 0; b < blocks; ++b) {
        int s_idx = 0;
        while (scan_comp[s_idx] != bcomp[b]) ++s_idx;
        const Component& cp = comp[bcomp[b]];
        int16_t* blk = coef + 64 * b;
        int s = br.decode(dc[cp.td]);
        if (s) s = extend(br.get(s), s);
        s += last_dc[s_idx];
        last_dc[s_idx] = s;
        blk[0] = (int16_t)s;
        for (int k = 1; k < 64; ++k) {
          s = br.decode(ac[cp.ta]);
          const int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            s = extend(br.get(s), s);
            blk[kNaturalOrder[k]] = (int16_t)s;
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      }
      if (br.insufficient && ran_out < 0) ran_out = mcu;
    }
    if (restart) --restarts_to_go;
  }
  if (ran_out < 0) {
    out->kind = kComplete;
    return out->kind;
  }

  // the stream nvJPEG is given for a file with restart markers
  std::vector<uint8_t> repaired;
  if (restart) {
    repaired.assign(data, data + prefix);
    if (first > 0) {
      repaired.push_back(0xFF);
      repaired.push_back((uint8_t)(0xD0 + ((first / restart - 1) & 7)));
    }
    BitWriter bw{&repaired};
    for (int64_t mcu = first; mcu < total; ++mcu) {
      if (mcu > first && mcu % restart == 0) {
        bw.pad();
        repaired.push_back(0xFF);
        repaired.push_back((uint8_t)(0xD0 + ((mcu / restart - 1) & 7)));
      }
      for (int b = 0; b < blocks; ++b) {
        const Component& cp = comp[bcomp[b]];
        if (!dc[cp.td].zero_len || !ac[cp.ta].zero_len) return out->kind;
        bw.put(dc[cp.td].zero_code, dc[cp.td].zero_len);
        bw.put(ac[cp.ta].zero_code, ac[cp.ta].zero_len);
      }
    }
    bw.pad();
    repaired.push_back(0xFF);
    repaired.push_back(0xD9);
  }

  out->kind = kRanOut;
  out->mcu = (int32_t)ran_out;
  out->first = (int32_t)first;
  out->mcus_per_row = mcus_per_row;
  out->mcu_rows = mcu_rows;
  out->ncomp = ncomp;
  out->blocks = blocks;
  for (int c = 0; c < 4; ++c) {
    out->h[c] = c < ncomp ? h[c] : 0;
    out->v[c] = c < ncomp ? v[c] : 0;
  }
  const int16_t* last = kept.data() + (size_t)(ran_out - first) * mcu_coefs;
  for (int b = 0; b < blocks; ++b) {
    const int c = bcomp[b];
    out->block_comp[b] = c;
    out->block_x[b] = bx[b];
    out->block_y[b] = by[b];
    for (int k = 0; k < 64; ++k)
      out->coef[b][k] = (int32_t)((int16_t)quant[comp[c].tq][k]) * last[64 * b + k];
  }
  // the samples of MCUs first..ran_out, in the band of MCU rows they span
  const int64_t row0 = first / mcus_per_row, rows = ran_out / mcus_per_row - row0 + 1;
  size_t at[4], size = 0;
  for (int c = 0; c < ncomp; ++c) {
    at[c] = size;
    size += (size_t)rows * 8 * v[c] * mcus_per_row * 8 * h[c];
  }
  out->samples = (uint8_t*)calloc(size, 1);
  out->samples_len = (int64_t)size;
  int32_t dq[64];
  for (int64_t mcu = first; mcu <= ran_out; ++mcu) {
    const int64_t r = mcu / mcus_per_row - row0, col = mcu % mcus_per_row;
    const int16_t* coef = kept.data() + (size_t)(mcu - first) * mcu_coefs;
    for (int b = 0; b < blocks; ++b) {
      const int c = bcomp[b];
      for (int k = 0; k < 64; ++k)
        dq[k] = (int32_t)((int16_t)quant[comp[c].tq][k]) * coef[64 * b + k];
      const size_t stride = (size_t)mcus_per_row * 8 * h[c];
      const size_t y = (size_t)r * 8 * v[c] + 8 * by[b], x = (size_t)col * 8 * h[c] + 8 * bx[b];
      idct_islow(dq, out->samples + at[c] + y * stride + x, (int)stride);
    }
  }
  if (!repaired.empty()) {
    out->repaired = (uint8_t*)malloc(repaired.size());
    memcpy(out->repaired, repaired.data(), repaired.size());
    out->repaired_len = (int64_t)repaired.size();
  }
  return out->kind;
}

void bvt_jpeg_cut_free(BvtCut* cut) {
  free(cut->samples);
  free(cut->repaired);
  cut->samples = cut->repaired = nullptr;
  cut->samples_len = cut->repaired_len = 0;
}

}  // extern "C"
