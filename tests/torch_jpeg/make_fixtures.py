"""Write the JPEG fixtures of the native decode lane and their goldens.

    python tests/torch_jpeg/make_fixtures.py

Needs PIL and g++ with libjpeg's headers (the JAX package's
`native/bvt_io.cc` is compiled into a temporary directory, and
`bayesvlm_tpu.data.native_io` is pointed at it). Every image is drawn from
`numpy.random.default_rng(SEED)`, so a rerun writes the same JPEGs where
PIL's encoder is the same.

Fixtures (`FIXTURES`, in this order): smooth blurred-noise images in 4:2:0,
4:4:4 and 4:2:2 (square, so that a same-size square decode is the decoded
RGB itself), a progressive and a greyscale photo-sized image, one of iid
noise at odd sizes, 500x1 and 1x300 strips, one cut in half (libjpeg warns
and fills the rest with grey: status 0), a CMYK one and bytes that are not
a JPEG (status -1, all zeros).

`goldens.npz` holds the JAX lane's output on them: `status` (the same in
every mode), the uint8 crops at 224 in crop mode (`u8_crop224`), the
same-size square decodes of the square fixtures (`rgb_<stem>`), and the
sha256 of the uint8 crops at 256 square (`sha_u8_square256`) and of the
fp32 crops (CLIP mean/std at 224 in crop mode, SigLIP mean/std at 256
square: `sha_fp32_crop224`, `sha_fp32_square256`), which would not fit
the repository as arrays.

Cut streams (`CUT_CASES`): fixtures, and the sources of `CUT_SOURCES`
(restart intervals, which PIL writes; a sequential file with one scan a
component and an arithmetic-coded one, which the libjpeg encoder of
`VARIANT_ENCODER` writes, built here by g++), each cut at a place in its
first scan: a fraction of it, a few bytes into the first MCU, or just
after a restart marker. `cut_goldens.npz` holds each case's `source`,
`offset` (the bytes kept), the JAX lane's `status` and its uint8 crops at
224 in crop mode (`u8_crop224`): libjpeg's pixels past the cut, which the
card's machine cannot compute.
"""

from __future__ import annotations

import hashlib
import io
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
SEED = 20261018
GOLDENS = HERE / "goldens.npz"
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = SIGLIP_STD = (0.5, 0.5, 0.5)
CROP, SQUARE = 224, 256
# name -> (width, height, content, PIL save options); the order is the goldens'
FIXTURES = {
    "smooth_420.jpg": (320, 320, "smooth", dict(quality=90, subsampling=2)),
    "smooth_444.jpg": (320, 320, "smooth", dict(quality=90, subsampling=0)),
    "smooth_422.jpg": (320, 320, "smooth", dict(quality=90, subsampling=1)),
    "progressive.jpg": (640, 427, "smooth", dict(quality=85, progressive=True)),
    "grey.jpg": (300, 400, "grey", dict(quality=90)),
    "noise.jpg": (257, 193, "noise", dict(quality=95)),
    "strip_500x1.jpg": (500, 1, "smooth", dict(quality=90)),
    "strip_1x300.jpg": (1, 300, "smooth", dict(quality=90)),
    "truncated.jpg": (500, 333, "smooth", dict(quality=90)),
    "cmyk.jpg": (64, 48, "cmyk", dict(quality=90)),
    "not_jpeg.jpg": (0, 0, "bytes", {}),
}
SQUARE_FIXTURES = [n for n, (w, h, *_) in FIXTURES.items() if w == h and w > 0]
CUT_GOLDENS = HERE / "cut_goldens.npz"
# name -> (width, height, PIL save options, or the variant encoder's mode);
# drawn from SEED + 1, after FIXTURES, so those stay as they were
CUT_SOURCES = {
    "restart_420.jpg": (320, 240, dict(quality=90, subsampling=2, restart_marker_rows=1)),
    "restart_444.jpg": (200, 136, dict(quality=90, subsampling=0, restart_marker_blocks=7)),
    "multiscan.jpg": (320, 240, "multiscan"),
    "arith.jpg": (320, 240, "arith"),
}
# case -> (source, where the cut falls in its first scan: a fraction of the
# scan's bytes, "first_mcu" (4 bytes into it), "after_rst" (just after the
# restart marker nearest the middle) or "whole" (not cut)); the order is
# cut_goldens.npz's
CUT_CASES = {
    "smooth_420_first_mcu": ("smooth_420.jpg", "first_mcu"),
    "smooth_420_third": ("smooth_420.jpg", 1 / 3),
    "smooth_422_half": ("smooth_422.jpg", 0.5),
    "smooth_444_two_thirds": ("smooth_444.jpg", 2 / 3),
    "grey_half": ("grey.jpg", 0.5),
    "restart_420_mid": ("restart_420.jpg", 0.55),
    "restart_420_after_rst": ("restart_420.jpg", "after_rst"),
    "restart_444_mid": ("restart_444.jpg", 0.6),
    "progressive_half": ("progressive.jpg", 0.5),
    "multiscan_half": ("multiscan.jpg", 0.5),
    "multiscan_whole": ("multiscan.jpg", "whole"),
    "arith_half": ("arith.jpg", 0.5),
    "arith_whole": ("arith.jpg", "whole"),
}
# A libjpeg encoder for what PIL cannot write: `multiscan` (sequential,
# one scan a component) and `arith` (arithmetic coding), 4:2:0 at quality
# 90; argv: mode width height in.rgb out.jpg
VARIANT_ENCODER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>
int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const int w = atoi(argv[2]), h = atoi(argv[3]);
  unsigned char* rgb = (unsigned char*)malloc((size_t)w * h * 3);
  FILE* in = fopen(argv[4], "rb");
  if (!in || fread(rgb, 1, (size_t)w * h * 3, in) != (size_t)w * h * 3) return 3;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* out = fopen(argv[5], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, 90, TRUE);
  static jpeg_scan_info scans[3];
  if (strcmp(argv[1], "arith") == 0) {
    c.arith_code = TRUE;
  } else {
    for (int i = 0; i < 3; ++i) {
      scans[i].comps_in_scan = 1;
      scans[i].component_index[0] = i;
      scans[i].Ss = 0;
      scans[i].Se = 63;
      scans[i].Ah = scans[i].Al = 0;
    }
    c.scan_info = scans;
    c.num_scans = 3;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = rgb + (size_t)c.next_scanline * w * 3;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(out);
  return 0;
}
"""
CHROMA = {"smooth_420.jpg": "4:2:0", "smooth_444.jpg": "4:4:4", "smooth_422.jpg": "4:2:2"}


def _smooth(rng, w, h, channels=3):
    """Blurred noise: coarse random colours upsampled bicubically, with a
    little fine grain."""
    from PIL import Image

    coarse = rng.integers(0, 256, size=(max(2, h // 24), max(2, w // 24), channels),
                          dtype=np.uint8)
    mode = "RGB" if channels == 3 else "L"
    img = Image.fromarray(coarse.squeeze(-1) if channels == 1 else coarse, mode)
    arr = np.asarray(img.resize((w, h), Image.BICUBIC), np.float32)
    arr = arr + rng.normal(0.0, 1.5, size=arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


def make_jpegs(rng) -> dict:
    from PIL import Image

    out = {}
    for name, (w, h, content, opts) in FIXTURES.items():
        if content == "bytes":
            out[name] = rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes()
            continue
        if content == "smooth":
            img = Image.fromarray(_smooth(rng, w, h), "RGB")
        elif content == "grey":
            img = Image.fromarray(_smooth(rng, w, h, 1), "L")
        elif content == "noise":
            img = Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8), "RGB")
        else:  # cmyk
            img = Image.fromarray(rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8), "CMYK")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        if name == "truncated.jpg":
            data = data[: len(data) // 2]
        out[name] = data
    return out


def make_cut_sources(rng, out_dir) -> dict:
    """The sources of CUT_SOURCES, name -> bytes (the variant encoder built
    into `out_dir`)."""
    from PIL import Image

    out = {}
    encoder = None
    for name, (w, h, how) in CUT_SOURCES.items():
        pixels = _smooth(rng, w, h)
        if isinstance(how, dict):
            buf = io.BytesIO()
            Image.fromarray(pixels, "RGB").save(buf, format="JPEG", **how)
            out[name] = buf.getvalue()
            continue
        if encoder is None:
            src = Path(out_dir) / "variant_encoder.c"
            src.write_text(VARIANT_ENCODER)
            encoder = Path(out_dir) / "variant_encoder"
            subprocess.run(["g++", "-O2", "-x", "c++", str(src), "-o", str(encoder), "-ljpeg"],
                           check=True, capture_output=True)
        raw, jpg = Path(out_dir) / "in.rgb", Path(out_dir) / name
        raw.write_bytes(np.ascontiguousarray(pixels).tobytes())
        subprocess.run([str(encoder), how, str(w), str(h), str(raw), str(jpg)], check=True)
        out[name] = jpg.read_bytes()
    return out


def scan_start(data: bytes) -> int:
    """The offset of the first byte after the first SOS segment."""
    at = data.index(b"\xff\xda")
    return at + 2 + ((data[at + 2] << 8) | data[at + 3])


def cut_offset(data: bytes, where) -> int:
    """Where CUT_CASES' `where` cuts `data`: the number of bytes kept."""
    start = scan_start(data)
    if where == "whole":
        return len(data)
    if where == "first_mcu":
        return start + 4
    if where == "after_rst":
        marks = [k for k in range(start, len(data) - 1)
                 if data[k] == 0xFF and 0xD0 <= data[k + 1] <= 0xD7]
        return min(marks, key=lambda k: abs(k - (start + len(data)) // 2)) + 2
    return start + int(where * (len(data) - start))


def cut_jpegs(sources: dict) -> dict:
    """CUT_CASES' cut streams, name -> (source, offset, bytes)."""
    out = {}
    for name, (source, where) in CUT_CASES.items():
        offset = cut_offset(sources[source], where)
        out[name] = (source, offset, sources[source][:offset])
    return out


def cut_goldens(nio, cuts: dict) -> dict:
    """The JAX lane's output on the cut streams (CUT_CASES' order)."""
    u8, st = nio.decode_batch_u8([c[2] for c in cuts.values()], CROP, square_resize=False,
                                 num_threads=2)
    return dict(names=np.array(list(cuts)), source=np.array([c[0] for c in cuts.values()]),
                offset=np.array([c[1] for c in cuts.values()], np.int64), status=st,
                u8_crop224=u8)


def build_jax_reference(out_dir) -> Path:
    """Compile the JAX package's native/bvt_io.cc with its Makefile's flags
    into `out_dir`; returns the library's path."""
    lib = Path(out_dir) / "libbvt_io.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall",
                    str(REPO / "native" / "bvt_io.cc"), "-o", str(lib), "-shared",
                    "-ljpeg", "-lpthread"], check=True, capture_output=True)
    return lib


def jax_native_io(lib_path):
    """`bayesvlm_tpu.data.native_io` loading the library at `lib_path`."""
    sys.path.insert(0, str(REPO))
    from bayesvlm_tpu.data import native_io

    native_io._LIB_PATH = Path(lib_path)
    native_io._lib = None
    return native_io


def sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def goldens(nio, jpegs: list) -> dict:
    """The JAX lane's outputs on `jpegs` (the FIXTURES order)."""
    u8c, st = nio.decode_batch_u8(jpegs, CROP, square_resize=False, num_threads=2)
    u8s, st2 = nio.decode_batch_u8(jpegs, SQUARE, square_resize=True, num_threads=2)
    f32c, st3 = nio.decode_batch(jpegs, CROP, CLIP_MEAN, CLIP_STD, num_threads=2)
    f32s, st4 = nio.decode_batch(jpegs, SQUARE, SIGLIP_MEAN, SIGLIP_STD,
                                 square_resize=True, num_threads=2)
    for other in (st2, st3, st4):
        assert np.array_equal(st, other)
    out = dict(names=np.array(list(FIXTURES)), status=st, u8_crop224=u8c,
               sha_u8_square256=np.array(sha(u8s)), sha_fp32_crop224=np.array(sha(f32c)),
               sha_fp32_square256=np.array(sha(f32s)))
    for name in SQUARE_FIXTURES:
        i = list(FIXTURES).index(name)
        w = FIXTURES[name][0]
        rgb, s = nio.decode_batch_u8([jpegs[i]], w, square_resize=True, num_threads=1)
        assert int(s[0]) == 0
        out[f"rgb_{Path(name).stem}"] = rgb[0]
    return out


def main() -> int:
    jpegs = make_jpegs(np.random.default_rng(SEED))
    for name, data in jpegs.items():
        (HERE / name).write_bytes(data)
    with tempfile.TemporaryDirectory() as tmp:
        sources = {**jpegs, **make_cut_sources(np.random.default_rng(SEED + 1), tmp)}
        for name in CUT_SOURCES:
            (HERE / name).write_bytes(sources[name])
        nio = jax_native_io(build_jax_reference(tmp))
        gold = goldens(nio, [jpegs[n] for n in FIXTURES])
        cut_gold = cut_goldens(nio, cut_jpegs(sources))
    np.savez_compressed(GOLDENS, **gold)
    np.savez_compressed(CUT_GOLDENS, **cut_gold)
    files = [*FIXTURES, *CUT_SOURCES, GOLDENS.name, CUT_GOLDENS.name]
    total = sum((HERE / n).stat().st_size for n in files)
    print(f"statuses {dict(zip(FIXTURES, gold['status'].tolist()))}")
    print(f"cut cases {dict(zip(CUT_CASES, cut_gold['offset'].tolist()))}, statuses "
          f"{cut_gold['status'].tolist()}")
    print(f"{len(FIXTURES) + len(CUT_SOURCES)} fixtures and goldens: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
