"""Where planes_crop_kernel's time goes, on the card, by source variants.

Each variant is `csrc/jpeg_decode.cu` with a few lines replaced
(`VARIANTS`): the planes read from device memory a pixel at a time, not
staged (`gather`, the kernel's design before staging), the staging
area's size, the band height, the block size, `__launch_bounds__`, and
six that leave work out (the colour conversion, the staging too, the
blend, the conversion and the blend, the stores too, or all of the
block's work) and so give wrong crops: they are timed only, and a
variant's time beside the base's says what the left-out work costs.
Each is built with the package's nvcc flags into a temporary directory
under `build/`, loaded with ctypes and called through `bvt_planes_crop`
on the same nvJPEG planes: chip_smoke.py phase 7e's batch (64 JPEGs
cycling through tests/torch_jpeg/'s fixtures, 54 decoded) to 224 crops,
uint8 and fp32.
A variant's output is compared with the plain version's bit for bit, and
its time is `REPEATS` replays of a CUDA graph of `LAUNCHES` launches
(the best and the median a launch), printed with its registers, local
memory, shared memory and blocks an SM, and the card's name and power
limit.

    python -m bayesvlm_tpu_torch.probes.planes_crop_variants [--only NAME ...]
        [--baseline OTHER/jpeg_decode.cu]

With --baseline, another version of the source (another commit's) is
timed as `baseline` in turns with the variants: the variants, the
baseline twice, the variants again in reverse order.

There is no CPU mode: without a card and nvcc it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.data import native_io

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "torch_jpeg"
BATCH, SIZE, LAUNCHES, REPEATS = 64, 224, 20, 5
MEAN, STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)

_STAGE_Y = ("t < nr * y_words; t += blockDim.x)", "t < 0; t += blockDim.x)")
_STAGE_C = ("t < 2 * ncs * c_words; t += blockDim.x)", "t < 0; t += blockDim.x)")
_CELL = "          const int luma = s_stage[s_yoff[r] + x];"
_GATHER = [_STAGE_Y, _STAGE_C,
           ("tw = min(tw, ((x_last - base) / 16 + 1) * 16);",
            "tw = ((x_last - base) / 16 + 1) * 16;"),
           (_CELL, "          rgb_at<M>(im, x, s_rowsrc[r], rgb);\n          continue;\n" + _CELL)]
_CONVERT = (_CELL, "          rgb[0] = (uint8_t)c; rgb[1] = (uint8_t)r; rgb[2] = 0;\n"
                   "          continue;\n" + _CELL)
_BLEND = ("const float px = blend(t0[c0 + c], t0[c1 + c], t1[c0 + c], t1[c1 + c], fx, fy);",
          "const float px = (float)t0[c0 + c] + fx;")
_STORES = ("      o[0] = pack.word[0];\n      o[1] = pack.word[1];\n      o[2] = pack.word[2];",
           "      if (pack.word[0].x == 12345u) o[0] = pack.word[0];")
_KERNEL = "__global__ void planes_crop_kernel("
_THREADS = ("dim3 grid((S + R - 1) / R, n);\n  const int threads = 256;",
            "dim3 grid((S + R - 1) / R, n);\n  const int threads = {};")
_STAGE_BYTES = "constexpr int kStageBytes = 16 * 1024;"
# name -> (replacements, whether its crops must be right)
VARIANTS = {
    "base": ([], True),
    "gather": (_GATHER, True),
    "stage8k": ([(_STAGE_BYTES, _STAGE_BYTES.replace("16 *", "8 *"))], True),
    "stage32k": ([(_STAGE_BYTES, _STAGE_BYTES.replace("16 *", "32 *"))], True),
    "rows4": ([("int R = 8;", "int R = 4;")], True),
    "threads128": ([(_THREADS[0], _THREADS[1].format(128))], True),
    "threads512": ([(_THREADS[0], _THREADS[1].format(512))], True),
    "bounds5": ([(_KERNEL, "__global__ void __launch_bounds__(256, 5) planes_crop_kernel(")],
                True),
    "bounds6": ([(_KERNEL, "__global__ void __launch_bounds__(256, 6) planes_crop_kernel(")],
                True),
    "no_convert": ([_CONVERT], False),
    "no_stage_convert": ([_STAGE_Y, _STAGE_C, _CONVERT], False),
    "no_blend": ([_BLEND], False),
    "no_convert_blend": ([_CONVERT, _BLEND], False),
    "no_convert_blend_stores": ([_CONVERT, _BLEND, _STORES], False),
    "empty": ([("  const bool ok = im.w > 0 && im.h > 0;\n",
                "  const bool ok = im.w > 0 && im.h > 0;\n  if (ok) return;\n")], False),
}


def variant_source(name: str, source: str) -> str:
    for old, new in VARIANTS[name][0]:
        if old not in source:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        source = source.replace(old, new)
    return source


def graph_ms(launch) -> list:
    """REPEATS timings, ms a launch, of a CUDA graph of LAUNCHES launches."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES):
            launch()
    graph.replay()
    out = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / LAUNCHES)
    return sorted(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="*", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--baseline", type=Path, help="another version of jpeg_decode.cu, timed "
                    "as `baseline` in turns with the variants (its crops must be right)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}")
    source = (kernels.CSRC / "jpeg_decode.cu").read_text()
    names = list(dict.fromkeys(args.only))
    sources = {name: variant_source(name, source) for name in names}
    right = {name: VARIANTS[name][1] for name in names}
    order = names
    if args.baseline:
        sources["baseline"], right["baseline"] = args.baseline.read_text(), True
        order = [*names, "baseline", "baseline", *reversed(names)]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        def build(name):
            src = Path(tmp) / f"{name}.cu"
            src.write_text(sources[name])
            lib = Path(tmp) / f"lib{name}.so"
            kernels._compile(src, lib)
            return name, lib

        with ThreadPoolExecutor(len(sources)) as pool:
            libs = dict(pool.map(build, sources))
        jpegs = [(FIXTURES / n).read_bytes()
                 for n in np.load(FIXTURES / "goldens.npz")["names"]]
        planes, _ = native_io.decode_planes([jpegs[i % len(jpegs)] for i in range(BATCH)],
                                            "cuda")
        meta = planes.meta.cuda()
        norm = np.asarray([*MEAN, *STD], np.float32)
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in order:
            lib = ctypes.CDLL(str(libs[name]))
            lib.bvt_planes_crop.argtypes = [p, i, i, i, p, p, p, p, p]
            lib.bvt_planes_crop_resources.argtypes = [i, i, p]
            for u8 in (True, False):
                out = torch.empty(BATCH, SIZE, SIZE, 3, device="cuda",
                                  dtype=torch.uint8 if u8 else torch.float32)

                def launch():
                    err = lib.bvt_planes_crop(
                        meta.data_ptr(), BATCH, SIZE, 0, norm.ctypes.data,
                        norm.ctypes.data + 12, None if u8 else out.data_ptr(),
                        out.data_ptr() if u8 else None, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name}: launch failed ({err})")

                launch()
                ref = native_io.planes_crop_reference(planes, SIZE, False, MEAN, STD, u8)
                torch.cuda.synchronize()
                same = torch.equal(out, ref)
                if right[name] and not same:
                    raise RuntimeError(f"variant {name} differs from the plain version")
                res = np.zeros(4, np.int32)
                lib.bvt_planes_crop_resources(SIZE, int(u8), res.ctypes.data)
                ms = graph_ms(launch)
                kind = "bit-equal to plain" if same else "timing only"
                print(f"{name} {'u8' if u8 else 'fp32'}: best {ms[0]:.4f} ms, median "
                      f"{ms[len(ms) // 2]:.4f} ms ({kind}; {res[0]} registers, {res[1]} B "
                      f"local, {res[2]} B shared, {res[3]} blocks/SM)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
