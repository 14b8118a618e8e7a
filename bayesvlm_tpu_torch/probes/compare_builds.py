"""The kernels of two source trees, side by side on the card: the bf16
attention kernels, or (--gemm) the GEMM probes' kernels.

    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR [--changed v2 v3]
    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR --gemm

Each DIR is a `csrc/` directory (this package's, or one unpacked from
another commit with `git archive`). Its `attention.cu` and
`attention_variants.cu` are built with the package's nvcc flags into a
temporary directory under `build/`, loaded with ctypes and called through
their C interfaces, which both trees must share. At each shape every
kernel below runs once from each tree on the same seeded bf16 q, k, v:
its output from b is compared with a's bit for bit, and with #1's of the
same tree. Then each is timed with CUDA events in turns (a, b, b, a, b,
a, a, b; ITERS launches a turn), and the best and the median of each
tree's turns are printed, with the card's name and power limit.

Kernels: #1 one-block, #2 split-key, #3 the packed pair, v2 (deferred
normalisation), v3 (v2 without the max), v4 (bf16 scores), v5 (H/2
heads a block), v6 (2 batch rows a block), and the pair walked in turn
(the group kernel at 2 heads a block). `--changed` names the kernels
whose bits the change means to move: the printout marks them, and the
exit code is 1 when any other kernel of b differs from a's.

--gemm: each tree's `tile_gemm.cu` is built and called through its C
interface, `bvt_tile_gemm(kind, tile, a, b, c, M, N, K, stream)` with B
[K, N] for every kind (a tree whose s8 kernel reads B^T lays it out
inside that call, so it is timed with it). At the probes' M, K, N = 16384, 1024, 4096 on seeded operands:
s4 x s4 and s8 x s4 from b must equal a's bit for bit (and plain), s8
must equal plain in both trees and bf16 lie within `tile_gemm.BF16_TOL`
of max |plain|; then bf16 and s8 at each tree's tile 0 (or each index
of --tiles, which both trees must build) are timed in the same turns.
The exit code is 1 when s4 or s8 x s4 differ between the trees, or a
kind is wrong in either tree.

There is no CPU mode: without a card and nvcc it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.probes import tile_gemm as tg

# B, T, H, Dh: ViT-L/14 at the main path's batch, and the probes' batch
SHAPES = {"vit-l/14 B=64": (64, 257, 16, 64), "probes B=80": (80, 257, 16, 64)}
ITERS = 100
TURNS = ("a", "b", "b", "a", "b", "a", "a", "b")
# (library, schedule or variant, nh, nr) of each kernel; nh = 0: H / 2
ONE_BLOCK, SPLIT_KEY, PACKED_PAIR = 0, 1, 2
V2, V3, V4, GROUP = 0, 1, 2, 3
KINDS = {"#1": ("attention", ONE_BLOCK, 1, 1), "#2": ("attention", SPLIT_KEY, 1, 1),
         "#3": ("attention", PACKED_PAIR, 1, 1), "v2": ("variants", V2, 1, 1),
         "v3": ("variants", V3, 1, 1), "v4": ("variants", V4, 1, 1),
         "v5": ("variants", GROUP, 0, 1), "v6": ("variants", GROUP, 1, 2),
         "pair in turn": ("variants", GROUP, 2, 1)}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--a", required=True, type=Path, help="the first csrc/ directory")
    p.add_argument("--b", required=True, type=Path, help="the second csrc/ directory")
    p.add_argument("--changed", nargs="*", default=[], choices=sorted(KINDS),
                   help="kernels whose bits b means to change")
    p.add_argument("--gemm", action="store_true",
                   help="compare the GEMM probes' tile_gemm.cu instead")
    p.add_argument("--tiles", nargs="+", type=int, default=[0],
                   help="--gemm: the tile indices whose bf16 and s8 are timed")
    return p.parse_args(argv)


def _nvcc_all(jobs: dict, csrc: Path, out: Path) -> dict:
    """Each {name: source} of csrc built into out/<name>.so (one nvcc each,
    all at once) and loaded."""
    procs = {name: subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                                     str(out / f"{name}.so"), str(csrc / src)])
             for name, src in jobs.items()}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {csrc / jobs[name]}")
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in jobs}


def build(csrc: Path, out: Path) -> dict:
    """attention.cu and attention_variants.cu of csrc built into out (two
    nvcc at once) and loaded: {"attention": lib, "variants": lib}."""
    libs = _nvcc_all({"attention": "attention.cu", "variants": "attention_variants.cu"},
                     csrc, out)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    libs["attention"].bvt_attention.argtypes = [ptr] * 4 + [i] * 5 + [
        ctypes.c_float, i, ptr]
    libs["variants"].bvt_attn_variant.argtypes = [ptr] * 4 + [i] * 5 + [
        ctypes.c_float, i, i, i, ptr]
    for lib in libs.values():
        lib.bvt_error_string.argtypes = [i]
        lib.bvt_error_string.restype = ctypes.c_char_p
    return libs


def launcher(libs: dict, kind: str, q, k, v, o, num_heads: int):
    """A call that launches the kernel `kind` of one tree on q, k, v into o."""
    lib_name, code, nh, nr = KINDS[kind]
    lib = libs[lib_name]
    B, T, D = q.shape
    Dh = D // num_heads
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, T, num_heads,
            Dh, 1, 1.0 / math.sqrt(Dh), code]
    if lib_name == "variants":
        args += [nh or num_heads // 2, nr]

    def call():
        err = (lib.bvt_attention if lib_name == "attention" else lib.bvt_attn_variant)(
            *args, torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, err, f"{kind} kernel")

    return call


def build_gemm(csrc: Path, out: Path) -> ctypes.CDLL:
    """tile_gemm.cu of csrc built into out and loaded, its C interface typed."""
    lib = _nvcc_all({"tile_gemm": "tile_gemm.cu"}, csrc, out)["tile_gemm"]
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_tile_gemm.argtypes = [i, i, ptr, ptr, ptr, i, i, i, ptr]
    lib.bvt_error_string.argtypes = [i]
    lib.bvt_error_string.restype = ctypes.c_char_p
    return lib


def gemm_launcher(lib, kind: int, a, b, c, K: int, tile: int = 0):
    """A call that runs one tree's GEMM kind at this tile index on a, b into
    c."""
    M, N = c.shape

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        kernels.check(lib, lib.bvt_tile_gemm(kind, tile, a.data_ptr(), b.data_ptr(),
                                             c.data_ptr(), M, N, K, stream),
                      f"{tg.KIND_NAMES[kind]} GEMM")

    return call


def run_gemm(args) -> dict:
    """Both trees' GEMM kinds at the probes' shape: s4 and s8 x s4 bits
    compared between the trees, s8 and bf16 held to plain (tile 0), bf16
    and s8 timed in turns at each of args.tiles."""
    Mr, Kr, Nr = tg.M, tg.K, tg.N
    gen = torch.Generator(device="cuda").manual_seed(0)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int8)

    a8, b8 = ints(-127, 127, Mr, Kr), ints(-127, 127, Kr, Nr)
    a4, b4 = ints(-8, 8, Mr, Kr), ints(-8, 8, Kr, Nr)
    a16 = torch.randn(Mr, Kr, generator=gen, device="cuda").bfloat16()
    b16 = torch.randn(Kr, Nr, generator=gen, device="cuda").bfloat16()
    b4p = tg.pack_s4(b4, 0)
    operands = {tg.BF16: (a16, b16, torch.float32), tg.S8: (a8, b8, torch.int32),
                tg.S4: (tg.pack_s4(a4, 1), b4p, torch.int32), tg.S8S4: (a8, b4p, torch.int32)}
    refs = {tg.BF16: tg.matmul_reference(a16, b16), tg.S8: tg.matmul_reference(a8, b8),
            tg.S4: tg.matmul_reference(a4, b4), tg.S8S4: tg.matmul_reference(a8, b4)}
    out = {"shape": dict(zip("MKN", (Mr, Kr, Nr))), "kinds": {}}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        libs = {}
        for tag in ("a", "b"):
            (Path(tmp) / tag).mkdir()
            libs[tag] = build_gemm(getattr(args, tag), Path(tmp) / tag)
        for kind, (a, b, dtype) in operands.items():
            outs = {tag: torch.empty(Mr, Nr, dtype=dtype, device="cuda") for tag in libs}
            calls = {tag: gemm_launcher(libs[tag], kind, a, b, outs[tag], Kr)
                     for tag in libs}
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            ref = refs[kind]
            r = {"b_equals_a": bool(torch.equal(outs["a"], outs["b"]))}
            for tag in libs:
                if kind == tg.BF16:
                    r[f"{tag}_max_abs_err"] = float((outs[tag] - ref).abs().max())
                    r[f"{tag}_ok"] = r[f"{tag}_max_abs_err"] <= tg.BF16_TOL * float(
                        ref.abs().max())
                else:
                    r[f"{tag}_ok"] = bool(torch.equal(outs[tag], ref))
            if kind in (tg.BF16, tg.S8):
                r["times"] = {}
                for tile in args.tiles:
                    timed = {tag: gemm_launcher(libs[tag], kind, a, b, outs[tag], Kr, tile)
                             for tag in libs}
                    times = {"a": [], "b": []}
                    for tag in TURNS:
                        times[tag].append(cuda_ms(timed[tag]))
                    r["times"][tile] = {
                        **{f"{tag}_ms": min(times[tag]) for tag in libs},
                        **{f"{tag}_median_ms": statistics.median(times[tag]) for tag in libs}}
            out["kinds"][tg.KIND_NAMES[kind]] = r
    return out


def report_gemm(results: dict) -> int:
    print(f"card: {card_line()}")
    s = results["shape"]
    print(f"GEMM probes at M={s['M']} K={s['K']} N={s['N']}, bits at tile 0 of each tree, "
          f"times best / median of {len(TURNS) // 2} turns of {ITERS}:")
    for kind, r in results["kinds"].items():
        print(f"  {kind:5s} b equals a: {r['b_equals_a']}; a right: {r['a_ok']}, "
              f"b right: {r['b_ok']}")
        for tile, t in r.get("times", {}).items():
            print(f"  {kind:5s} tile {tile}: a {t['a_ms']:.4f} / {t['a_median_ms']:.4f} ms, "
                  f"b {t['b_ms']:.4f} / {t['b_median_ms']:.4f} ms (b/a "
                  f"{t['b_ms'] / t['a_ms']:.3f})")
    kinds = results["kinds"]
    same = kinds["s4"]["b_equals_a"] and kinds["s8s4"]["b_equals_a"]
    right = all(r["a_ok"] and r["b_ok"] for r in kinds.values())
    print(f"s4 and s8s4 equal a bit for bit: {same}; every kind right in both trees: "
          f"{right}")
    return 0 if same and right else 1


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip()


def cuda_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def run(args) -> dict:
    """Bits and times of every kernel of both trees at every shape
    (`["shapes"][label][kind]`), and the kernels named as changed."""
    if not torch.cuda.is_available():
        raise RuntimeError("compare_builds times kernels on the card: no CUDA device")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {"changed": list(args.changed), "shapes": {}}
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        trees = {}
        for tag in ("a", "b"):
            (Path(tmp) / tag).mkdir()
            trees[tag] = build(getattr(args, tag), Path(tmp) / tag)
        for label, (B, T, H, Dh) in SHAPES.items():
            gen = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(B, T, H * Dh, generator=gen, device="cuda").bfloat16()
                       for _ in range(3))
            outs = {(tag, kind): torch.empty_like(q) for tag in trees for kind in KINDS}
            calls = {key: launcher(trees[key[0]], key[1], q, k, v, outs[key], H)
                     for key in outs}
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            out["shapes"][label] = rows = {}
            for kind in KINDS:
                times = {"a": [], "b": []}
                for tag in TURNS:
                    times[tag].append(cuda_ms(calls[(tag, kind)]))
                rows[kind] = {
                    "b_equals_a": bool(torch.equal(outs[("b", kind)], outs[("a", kind)])),
                    **{f"{tag}_equals_1": bool(torch.equal(outs[(tag, kind)],
                                                           outs[(tag, "#1")]))
                       for tag in trees},
                    **{f"{tag}_ms": min(times[tag]) for tag in trees},
                    **{f"{tag}_median_ms": statistics.median(times[tag]) for tag in trees}}
    return out


def report(results: dict) -> int:
    print(f"card: {card_line()}")
    changed = set(results["changed"])
    for label, rows in results["shapes"].items():
        print(f"{label}, bf16 (best / median of {len(TURNS) // 2} turns of {ITERS}):")
        for kind, r in rows.items():
            note = " (changed kernel: its bits may differ)" if kind in changed else ""
            print(f"  {kind:13s} a {r['a_ms']:.4f} / {r['a_median_ms']:.4f} ms, "
                  f"b {r['b_ms']:.4f} / {r['b_median_ms']:.4f} ms (b/a "
                  f"{r['b_ms'] / r['a_ms']:.3f}); b equals a: {r['b_equals_a']}{note}; "
                  f"equal to #1: a {r['a_equals_1']}, b {r['b_equals_1']}")
    same = all(r["b_equals_a"] for rows in results["shapes"].values()
               for kind, r in rows.items() if kind not in changed)
    print(f"every kernel not named as changed equals a bit for bit: {same}")
    return 0 if same else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.gemm:
        if not torch.cuda.is_available():
            raise RuntimeError("compare_builds times kernels on the card: no CUDA device")
        return report_gemm(run_gemm(args))
    return report(run(args))


if __name__ == "__main__":
    sys.exit(main())
