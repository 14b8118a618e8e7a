// Webdataset tar indexing and member reads on the host, the port's copy of
// the tar half of native/bvt_io.cc (bvt_tar_index, bvt_free_index,
// bvt_pread). Plain C++ with no dependency, built with g++ (kernels.py)
// and bound with ctypes by data/native_io.py:
//
//   * one pass over a tar's headers returns (name, offset, size) for each
//     regular file, so that a sample is read with one pread and no Python
//     walks the headers;
//   * names join the POSIX ustar prefix (only under the exact "ustar\0"
//     magic: GNU tars keep the atime there) into a 257-byte field, the
//     longest legal ustar path (155 + '/' + 100) and its NUL;
//   * a GNU long name ('L' member) or a pax header's "path" ('x' member)
//     names the member after it, as Python's tarfile reads them (a name
//     past 256 bytes is cut there); native/bvt_io.cc skips both and keeps
//     the 100-byte field, so its keys differ from tarfile's there;
//   * sizes >= 8 GB in GNU/star base-256 are read as such.
//
// No TPU kernel stands behind it: in the JAX package this is host C++ too.

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <string>
#include <vector>

extern "C" {

struct BvtTarEntry {
  char name[257];   // mirrored by ctypes in data/native_io.py
  uint64_t offset;  // offset of the member's data (after its 512-byte header)
  uint64_t size;
};

static uint64_t parse_octal(const char* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = v * 8 + (uint64_t)(p[i] - '0');
  }
  return v;
}

// base-256: high bit of byte 0 set, the remaining bits and bytes a
// big-endian integer
static uint64_t parse_size(const unsigned char* p, size_t n) {
  if (p[0] & 0x80) {
    uint64_t v = p[0] & 0x7F;
    for (size_t i = 1; i < n; ++i) v = (v << 8) | p[i];
    return v;
  }
  return parse_octal((const char*)p, n);
}

// A pax extended header's records ("<len> <key>=<value>\n"): its path,
// where it has one.
static void parse_pax(const std::string& data, std::string* path) {
  size_t p = 0;
  while (p < data.size()) {
    char* end = nullptr;
    unsigned long len = strtoul(data.c_str() + p, &end, 10);
    if (len == 0 || *end != ' ' || p + len > data.size()) return;  // malformed
    size_t key = (size_t)(end - data.c_str()) + 1;
    size_t eq = data.find('=', key);
    size_t stop = p + len - 1;  // the record's '\n'
    if (eq != std::string::npos && eq < stop && data.compare(key, eq - key, "path") == 0)
      *path = data.substr(eq + 1, stop - eq - 1);
    p += len;
  }
}

// Index a tar file: the number of regular files, with *out a malloc'ed
// array the caller frees with bvt_free_index; -1 if the file cannot be
// opened.
long bvt_tar_index(const char* path, BvtTarEntry** out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<BvtTarEntry> entries;
  unsigned char hdr[512];
  uint64_t pos = 0;
  std::string long_name;  // from an 'L' or 'x' member, for the next member
  bool have_long = false;
  while (fread(hdr, 1, 512, f) == 512) {
    pos += 512;
    if (hdr[0] == 0) break;  // end-of-archive blocks
    uint64_t size = parse_size(hdr + 124, 12);
    char typeflag = hdr[156];
    uint64_t padded = (size + 511) & ~511ULL;
    if ((typeflag == 'L' || typeflag == 'x') && size < (1u << 20)) {
      std::string data(size, '\0');
      if (fread(&data[0], 1, size, f) != size) break;
      if (fseek(f, (long)(padded - size), SEEK_CUR) != 0) break;
      pos += padded;
      if (typeflag == 'L') {
        long_name.assign(data.c_str());  // up to its NUL
        have_long = true;
      } else {
        std::string path;
        parse_pax(data, &path);
        if (!path.empty()) {
          long_name = path;
          have_long = true;
        }
      }
      continue;
    }
    if (typeflag == '0' || typeflag == 0) {  // regular file
      BvtTarEntry e;
      memset(&e, 0, sizeof(e));
      char name[257] = {0};
      bool posix_ustar = memcmp(hdr + 257, "ustar", 5) == 0 && hdr[262] == 0;
      if (have_long) {
        snprintf(name, sizeof(name), "%s", long_name.c_str());
      } else if (posix_ustar && hdr[345]) {  // prefix (345, 155 bytes) + '/' + name
        size_t pl = strnlen((const char*)hdr + 345, 155);
        memcpy(name, hdr + 345, pl);
        name[pl] = '/';
        strncat(name, (const char*)hdr, 100);
      } else {
        memcpy(name, hdr, 100);
      }
      memcpy(e.name, name, sizeof(name));
      e.offset = pos;
      e.size = size;
      entries.push_back(e);
    }
    have_long = false;  // it names one member
    if (fseek(f, (long)padded, SEEK_CUR) != 0) break;
    pos += padded;
  }
  fclose(f);
  BvtTarEntry* arr = (BvtTarEntry*)malloc(entries.size() * sizeof(BvtTarEntry));
  memcpy(arr, entries.data(), entries.size() * sizeof(BvtTarEntry));
  *out = arr;
  return (long)entries.size();
}

void bvt_free_index(BvtTarEntry* arr) { free(arr); }

// Read `size` bytes at `offset` of `path` into buf: 0, or -1 (open), -2
// (seek), -3 (short read).
int bvt_pread(const char* path, uint64_t offset, uint64_t size, uint8_t* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, (long)offset, SEEK_SET) != 0) {
    fclose(f);
    return -2;
  }
  size_t got = fread(buf, 1, size, f);
  fclose(f);
  return got == size ? 0 : -3;
}

}  // extern "C"
