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
        nio = jax_native_io(build_jax_reference(tmp))
        gold = goldens(nio, [jpegs[n] for n in FIXTURES])
    np.savez_compressed(GOLDENS, **gold)
    total = sum((HERE / n).stat().st_size for n in FIXTURES) + GOLDENS.stat().st_size
    print(f"statuses {dict(zip(FIXTURES, gold['status'].tolist()))}")
    print(f"{len(FIXTURES)} fixtures and goldens: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
