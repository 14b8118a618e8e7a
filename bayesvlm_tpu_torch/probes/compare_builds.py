"""The kernels of two source trees, side by side on the card: the bf16
attention kernels, (--gemm) the GEMM probes' kernels, (--int8) the int8
lane's two kernels, (--epig) the EPIG joint-entropy kernel, or (--block)
the attention sublayer kernel, or (--packed) the packed-head probe kernels.

    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR [--changed v2 v3]
    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR --gemm
    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR --int8
    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR --epig
    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR --block
    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR --packed

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
of --tiles, which both trees must build), and s4 x s4 and s8 x s4 at
tile 0 (their only one), are timed in the same turns.
The exit code is 1 when s4 or s8 x s4 differ between the trees, or a
kind is wrong in either tree.

--int8: each tree's `mlp_int8.cu` and `linear_int8.cu` are built and
called through their C interfaces, `bvt_mlp_int8` and `bvt_linear_int8`
(the same arguments and scratch in both trees), on the same seeded
operands at the ViT-L/14 int8 lane's shapes (M = 64 x 257, D = 1024, F =
4096) and at a ragged M = 333, in bf16 and fp32: mlp plain, fused pre-LN
and fused pre-LN with 4-bit weights (tanh-GELU); linear the fused QKV (N
= 3072, three chunks) and the out-projection (N = 1024). Each output of b
must equal a's bit for bit, and each tree's lie within the JAX package's
flip tolerance of the plain version; at the full M both trees are timed
in the same turns. The exit code is 1 when any output differs between the
trees or strays from plain in either.

--epig: each tree's `xlogy_rowsum.cu` is built and called through its C
interface, `bvt_xlogy_rowsum_bf16` and `bvt_xlogy_rowsum_int8` (the same
arguments and scratch in both trees), on seeded class probabilities
(softmax over C = 65 classes, flattened as `epig_from_probs_fused` does)
at the operating point (pool 4000, targets 2000, K = 100: M = 260,000, N
= 130,000; the resident instantiation) and at K = 400 (pool 1000, targets
500; the streamed one), bf16 and int8. Each tree's row sums must lie
within `epig_joint.ROWSUM_RTOL` of the plain version, row by row (the
summation order may differ between the trees, so their bits need not
agree); both trees are timed in the same turns. The exit code is 1 when
either tree strays from plain.

--block: each tree's `attention_block.cu` is built and called through its
C interface, `bvt_attention_block` (the same arguments and scratch in
both trees), at ViT-L/14 (B = 64, T = 257, D = 1024, H = 16) in bf16 on
seeded operands. Each tree's output is held against the plain version
(`fused_attention_block_reference`) at `BLOCK_TOL` (absolute plus
relative, chip_smoke.py's tolerance for the sublayer) and its max error
printed; whether b equals a bit for bit is printed too (a redesign of its
GEMMs moves the bits: another fp32 summation order). Both are timed in
the same turns. The exit code is 1 when either tree strays from plain.

--packed: each tree's `packed_heads.cu` is built and called through its C
interface, `bvt_qk_scores` and `bvt_pv` (the same arguments in both
trees), on seeded operands at each of PACKED_SHAPES (the probe's B=80,
T=257, H=16 and the ragged shapes chip_smoke.py checks): qk and pv, per
head and packed. Each tree's output is held to the plain version (qk at
rtol = atol = 1e-4, pv by `packed_heads.pv_check`) and whether b's bits
equal a's is printed (a redesign that sums in another order moves them);
at the probe's shape both trees are timed in the same turns. The exit code
is 1 when either tree strays from plain.

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
from bayesvlm_tpu_torch.models.mlp_int8 import FLIP_TOL_MAX, FLIP_TOL_MEAN
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
    p.add_argument("--int8", action="store_true",
                   help="compare the int8 lane's mlp_int8.cu and linear_int8.cu instead")
    p.add_argument("--epig", action="store_true",
                   help="compare the EPIG joint-entropy kernel's xlogy_rowsum.cu instead")
    p.add_argument("--block", action="store_true",
                   help="compare the attention sublayer kernel's attention_block.cu instead")
    p.add_argument("--packed", action="store_true",
                   help="compare the packed-head probe kernels' packed_heads.cu instead")
    args = p.parse_args(argv)
    if args.gemm + args.int8 + args.epig + args.block + args.packed > 1:
        p.error("--gemm, --int8, --epig, --block and --packed compare different kernels: "
                "pass one")
    return args


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
    and s8 timed in turns at each of args.tiles, the s4 kinds at tile 0."""
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
            r["times"] = {}
            for tile in args.tiles if kind in (tg.BF16, tg.S8) else [0]:
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
        for tile, t in r["times"].items():
            print(f"  {kind:5s} tile {tile}: a {t['a_ms']:.4f} / {t['a_median_ms']:.4f} ms, "
                  f"b {t['b_ms']:.4f} / {t['b_median_ms']:.4f} ms (b/a "
                  f"{t['b_ms'] / t['a_ms']:.3f})")
    kinds = results["kinds"]
    same = kinds["s4"]["b_equals_a"] and kinds["s8s4"]["b_equals_a"]
    right = all(r["a_ok"] and r["b_ok"] for r in kinds.values())
    print(f"s4 and s8s4 equal a bit for bit: {same}; every kind right in both trees: "
          f"{right}")
    return 0 if same and right else 1


# --int8: the int8 lane's shapes (rows, D, F) and its cases, held to the
# lane's flip tolerance against plain (models/mlp_int8.py FLIP_TOL_*)
INT8_M = {"vit-l/14": 64 * 257, "ragged": 333}
INT8_D, INT8_F = 1024, 4096
MLP_CASES = {"mlp plain": (8, False), "mlp fused-LN": (8, True), "mlp fused-LN w4": (4, True)}
LINEAR_CASES = {"linear qkv": (3 * INT8_D, 3), "linear out_proj": (INT8_D, 1)}
INT8_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def build_int8(csrc: Path, out: Path) -> dict:
    """mlp_int8.cu and linear_int8.cu of csrc built into out (two nvcc at
    once) and loaded, their C interfaces typed: {"mlp": lib, "linear": lib}."""
    libs = _nvcc_all({"mlp": "mlp_int8.cu", "linear": "linear_int8.cu"}, csrc, out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["mlp"].bvt_mlp_int8.argtypes = [p, i, i, i, i, p, p, f, p, p, p, p, p, p, i,
                                         p, p, p, p, p, p, p]
    libs["linear"].bvt_linear_int8.argtypes = [p, i, i, i, i, p, p, p, i, p, p, p, p]
    for lib in libs.values():
        lib.bvt_error_string.argtypes = [i]
        lib.bvt_error_string.restype = ctypes.c_char_p
    return libs


def _int8_operands(M: int, dtype, gen) -> dict:
    """Seeded x and the lane's weights (the port's quantizer, so both trees
    take the same int8 values), fp32 biases and LN parameters."""
    from bayesvlm_tpu_torch.models import mlp_int8 as mlp

    D, F = INT8_D, INT8_F

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(M, D).to(dtype)
    w1, w2 = randn(F, D, scale=D ** -0.5).to(dtype), randn(D, F, scale=F ** -0.5).to(dtype)
    wqkv, wo = randn(3 * D, D, scale=D ** -0.5).to(dtype), randn(D, D, scale=D ** -0.5).to(dtype)
    return {"x": x, "w1": w1, "w2": w2, "b1": randn(F, scale=0.02), "b2": randn(D, scale=0.02),
            "ln_w": 1.0 + randn(D, scale=0.1), "ln_b": randn(D, scale=0.1),
            "quant": {bits: mlp.quantize_mlp_weights(w1, w2, bits) for bits in (8, 4)},
            "linear": {"linear qkv": (wqkv, randn(3 * D, scale=0.02)),
                       "linear out_proj": (wo, randn(D, scale=0.02))}}


def int8_launcher(libs: dict, case: str, ops: dict, out: torch.Tensor):
    """A call of one tree's kernel for `case` on ops into out, with its own
    scratch."""
    from bayesvlm_tpu_torch.models.linear_int8 import quantize_weight

    x = ops["x"]
    M, D = x.shape
    code = 1 if x.dtype == torch.bfloat16 else 0
    dev = dict(device="cuda")
    if case in MLP_CASES:
        bits, fused = MLP_CASES[case]
        q, F = ops["quant"][bits], INT8_F
        ln = (ops["ln_w"].data_ptr(), ops["ln_b"].data_ptr(), 1e-5) if fused else (None, None, 0.0)
        scratch = [torch.empty(M, D, dtype=torch.int8, **dev), torch.empty(M, **dev),
                   torch.empty(M, F, **dev), torch.empty(M, F, dtype=torch.int8, **dev),
                   torch.empty(M, **dev)]
        args = [x.data_ptr(), code, M, D, F, *ln, q["w1q"].data_ptr(), q["s1"].data_ptr(),
                ops["b1"].data_ptr(), q["w2q"].data_ptr(), q["s2"].data_ptr(),
                ops["b2"].data_ptr(), 1, *(t.data_ptr() for t in scratch), out.data_ptr()]
        lib, fn = libs["mlp"], libs["mlp"].bvt_mlp_int8
    else:
        N, chunks = LINEAR_CASES[case]
        w, b = ops["linear"][case]
        wq, s = quantize_weight(w)
        scratch = [torch.empty(M, D, dtype=torch.int8, **dev), torch.empty(M, **dev), wq, s]
        args = [x.data_ptr(), code, M, D, N, wq.data_ptr(), s.data_ptr(), b.data_ptr(),
                N // chunks, scratch[0].data_ptr(), scratch[1].data_ptr(), out.data_ptr()]
        lib, fn = libs["linear"], libs["linear"].bvt_linear_int8

    def call():
        kernels.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream), case)

    call.scratch = scratch  # kept alive with the call
    return call


def int8_plain(case: str, ops: dict) -> torch.Tensor:
    """The plain version of `case`, laid out as the kernels write it
    (linear: N / chunk contiguous [M, chunk] blocks)."""
    from bayesvlm_tpu_torch.models import linear_int8 as linear
    from bayesvlm_tpu_torch.models import mlp_int8 as mlp

    x = ops["x"]
    if case in MLP_CASES:
        bits, fused = MLP_CASES[case]
        ln = dict(ln_weight=ops["ln_w"], ln_bias=ops["ln_b"], ln_eps=1e-5) if fused else {}
        return mlp.mlp_int8_reference(x, ops["w1"], ops["b1"], ops["w2"], ops["b2"],
                                      "gelu_tanh", quant=ops["quant"][bits], **ln)
    N, chunks = LINEAR_CASES[case]
    ref = linear.linear_int8_reference(x, *ops["linear"][case])
    return torch.stack(ref.chunk(chunks, dim=-1)).contiguous()


def _flip_ok(out: torch.Tensor, ref: torch.Tensor) -> bool:
    d = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max()) + 1e-12
    return float(d.max()) <= FLIP_TOL_MAX * scale and float(d.mean()) <= FLIP_TOL_MEAN * scale


def run_int8(args) -> dict:
    """Both trees' int8 kernels at every case, dtype and M: b's bits against
    a's, each against plain, and at the full M both timed in turns."""
    out = {"cases": {}}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        trees = {}
        for tag in ("a", "b"):
            (Path(tmp) / tag).mkdir()
            trees[tag] = build_int8(getattr(args, tag), Path(tmp) / tag)
        for mname, M in INT8_M.items():
            for dname, dtype in INT8_DTYPES.items():
                ops = _int8_operands(M, dtype, torch.Generator(device="cuda").manual_seed(M))
                for case in (*MLP_CASES, *LINEAR_CASES):
                    shape = (M, INT8_D) if case in MLP_CASES else (
                        LINEAR_CASES[case][1], M, LINEAR_CASES[case][0] // LINEAR_CASES[case][1])
                    outs = {tag: torch.full(shape, float("nan"), dtype=dtype, device="cuda")
                            for tag in trees}
                    calls = {tag: int8_launcher(trees[tag], case, ops, outs[tag]) for tag in trees}
                    for call in calls.values():
                        call()
                    torch.cuda.synchronize()
                    ref = int8_plain(case, ops)
                    r = {"b_equals_a": bool(torch.equal(outs["a"], outs["b"])),
                         **{f"{tag}_ok": _flip_ok(outs[tag], ref) for tag in trees}}
                    if mname == "vit-l/14":
                        times = {"a": [], "b": []}
                        for tag in TURNS:
                            times[tag].append(cuda_ms(calls[tag]))
                        r.update({f"{tag}_ms": min(times[tag]) for tag in trees})
                        r.update({f"{tag}_median_ms": statistics.median(times[tag])
                                  for tag in trees})
                    out["cases"][(case, dname, mname)] = r
                    del outs, calls, ref
                del ops
    return out


def report_int8(results: dict) -> int:
    print(f"card: {card_line()}")
    print(f"int8 lane at M={INT8_M}, D={INT8_D}, F={INT8_F} (times best / median of "
          f"{len(TURNS) // 2} turns of {ITERS}):")
    for (case, dname, mname), r in results["cases"].items():
        line = (f"  {case:16s} {dname} {mname:8s}: b equals a: {r['b_equals_a']}; "
                f"within the flip tolerance of plain: a {r['a_ok']}, b {r['b_ok']}")
        if "a_ms" in r:
            line += (f"; a {r['a_ms']:.4f} / {r['a_median_ms']:.4f} ms, b {r['b_ms']:.4f} / "
                     f"{r['b_median_ms']:.4f} ms (b/a {r['b_ms'] / r['a_ms']:.3f})")
        print(line)
    same = all(r["b_equals_a"] for r in results["cases"].values())
    right = all(r["a_ok"] and r["b_ok"] for r in results["cases"].values())
    print(f"every int8 output of b equals a bit for bit: {same}; every output within "
          f"the flip tolerance in both trees: {right}")
    return 0 if same and right else 1


# --epig: (pool images, target images, K, streamed) of each case; C classes
EPIG_CASES = {"operating point": (4000, 2000, 100, False),
              "K=400 streamed": (1000, 500, 400, True)}
EPIG_C, EPIG_ITERS = 65, 5


def build_epig(csrc: Path, out: Path) -> ctypes.CDLL:
    """xlogy_rowsum.cu of csrc built into out and loaded, its two entry
    points typed."""
    lib = _nvcc_all({"xlogy_rowsum": "xlogy_rowsum.cu"}, csrc, out)["xlogy_rowsum"]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bvt_xlogy_rowsum_bf16.argtypes = [p, p, p, i, i, i, f, i, p]
    lib.bvt_xlogy_rowsum_int8.argtypes = [p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.bvt_error_string.argtypes = [i]
    lib.bvt_error_string.restype = ctypes.c_char_p
    return lib


def epig_launcher(lib, pool, targ, K: int, use_int8: bool, streamed: bool, out):
    """A call of one tree's kernel on the flattened operands into out, with
    its own padded bf16 copies and int8 scratch (`epig_joint._plan`)."""
    from bayesvlm_tpu_torch.select import epig_joint as ej

    (M, _), N = pool.shape, targ.shape[0]
    plan = ej._plan(M, N, K, use_int8)
    k_pad = plan["k_pad"]
    a, b = ej._padded_bf16(pool, k_pad), ej._padded_bf16(targ, k_pad)
    scratch = [torch.empty(shape, dtype=dtype, device="cuda")
               for shape, dtype in plan["scratch"].values()]
    args = [a.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in scratch), out.data_ptr(),
            M, N, k_pad, 1.0 / K, int(streamed)]
    fn = lib.bvt_xlogy_rowsum_int8 if use_int8 else lib.bvt_xlogy_rowsum_bf16

    def call():
        kernels.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream),
                      "xlogy_rowsum kernel")

    call.keep = (a, b, scratch)  # kept alive with the call
    return call


def run_epig(args) -> dict:
    """Both trees' EPIG kernel at each case, bf16 and int8: each tree's row
    sums against plain, and both timed in turns."""
    from bayesvlm_tpu_torch.select import epig_joint as ej

    out = {"cases": {}, "rtol": ej.ROWSUM_RTOL}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        libs = {}
        for tag in ("a", "b"):
            (Path(tmp) / tag).mkdir()
            libs[tag] = build_epig(getattr(args, tag), Path(tmp) / tag)
        for label, (n_pool, n_targ, K, streamed) in EPIG_CASES.items():
            gen = torch.Generator(device="cuda").manual_seed(K)

            def probs(n):
                return ej._flatten(torch.softmax(torch.randn(
                    n, K, EPIG_C, generator=gen, device="cuda"), -1))

            pool, targ = probs(n_pool), probs(n_targ)
            for dname, use_int8 in (("bf16", False), ("int8", True)):
                ref = ej.joint_xlogy_rowsums_reference(pool, targ, K, use_int8=use_int8)
                outs = {tag: torch.full_like(ref, float("nan")) for tag in libs}
                calls = {tag: epig_launcher(libs[tag], pool, targ, K, use_int8, streamed,
                                            outs[tag]) for tag in libs}
                for call in calls.values():
                    call()
                torch.cuda.synchronize()
                r = {}
                for tag in libs:
                    err = (outs[tag] - ref).abs()
                    r[f"{tag}_max_rel_err"] = float((err / ref.abs()).max())
                    r[f"{tag}_ok"] = bool((err <= ej.ROWSUM_RTOL * ref.abs()).all())
                times = {"a": [], "b": []}
                for tag in TURNS:
                    times[tag].append(cuda_ms(calls[tag], EPIG_ITERS))
                r.update({f"{tag}_ms": min(times[tag]) for tag in libs})
                r.update({f"{tag}_median_ms": statistics.median(times[tag]) for tag in libs})
                out["cases"][(label, dname)] = r
                del outs, calls, ref
    return out


def report_epig(results: dict) -> int:
    print(f"card: {card_line()}")
    print(f"EPIG joint-entropy kernel (C={EPIG_C}; times best / median of "
          f"{len(TURNS) // 2} turns of {EPIG_ITERS}):")
    for (label, dname), r in results["cases"].items():
        print(f"  {label:16s} {dname}: within {results['rtol']:.0e} of plain row by row: a {r['a_ok']} "
              f"(max rel {r['a_max_rel_err']:.3e}), b {r['b_ok']} (max rel "
              f"{r['b_max_rel_err']:.3e}); a {r['a_ms']:.4f} / {r['a_median_ms']:.4f} ms, "
              f"b {r['b_ms']:.4f} / {r['b_median_ms']:.4f} ms (b/a {r['b_ms'] / r['a_ms']:.3f})")
    right = all(r["a_ok"] and r["b_ok"] for r in results["cases"].values())
    print(f"every row sum within the tolerance of plain in both trees: {right}")
    return 0 if right else 1


# --block: (B, T, D, H) of the sublayer, its tolerance against plain (bf16:
# the last two roundings, one ulp each; chip_smoke.py's BLOCK_TOL) and the
# calls a turn
BLOCK_SHAPE = (64, 257, 1024, 16)
BLOCK_TOL = 2.0 ** -6
BLOCK_ITERS = 20


def build_block(csrc: Path, out: Path) -> ctypes.CDLL:
    """attention_block.cu of csrc built into out and loaded, its entry point
    typed."""
    lib = _nvcc_all({"attention_block": "attention_block.cu"}, csrc, out)["attention_block"]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bvt_attention_block.argtypes = [p, p, p, f, *[p] * 8, i, i, i, i, i, f, *[p] * 5]
    lib.bvt_error_string.argtypes = [i]
    lib.bvt_error_string.restype = ctypes.c_char_p
    return lib


def run_block(args) -> dict:
    """Both trees' sublayer kernel at BLOCK_SHAPE in bf16: each against
    plain, b against a, and both timed in turns."""
    from bayesvlm_tpu_torch.models.attention import fused_attention_block_reference

    B, T, D, H = BLOCK_SHAPE
    M, Dh = B * T, D // H
    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(B, T, D).bfloat16()
    ln_w, ln_b = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
    params = [t for _ in range(4)
              for t in (randn(D, D, scale=D ** -0.5).bfloat16(), randn(D, scale=0.02).bfloat16())]
    ref = fused_attention_block_reference(x, ln_w, ln_b, *params, num_heads=H).float()
    h, attn = (torch.empty(M, D, device="cuda", dtype=torch.bfloat16) for _ in range(2))
    qkv = torch.empty(3, M, D, device="cuda", dtype=torch.bfloat16)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {"shape": BLOCK_SHAPE, "tol": BLOCK_TOL}
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        libs, outs, calls = {}, {}, {}
        for tag in ("a", "b"):
            (Path(tmp) / tag).mkdir()
            libs[tag] = lib = build_block(getattr(args, tag), Path(tmp) / tag)
            outs[tag] = o = torch.full_like(x, float("nan"))

            def call(lib=lib, o=o):
                err = lib.bvt_attention_block(
                    x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), 1e-5,
                    *(t.data_ptr() for t in params), B, T, D, H, 1, 1.0 / math.sqrt(Dh),
                    h.data_ptr(), qkv.data_ptr(), attn.data_ptr(), o.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                kernels.check(lib, err, "attention block kernel")

            calls[tag] = call
            call()
        torch.cuda.synchronize()
        for tag in libs:
            err = (outs[tag].float() - ref).abs()
            out[f"{tag}_max_abs_err"] = float(err.max())
            out[f"{tag}_worst"] = float((err / (BLOCK_TOL + BLOCK_TOL * ref.abs())).max())
        out["b_equals_a"] = bool(torch.equal(outs["a"], outs["b"]))
        times = {"a": [], "b": []}
        for tag in TURNS:
            times[tag].append(cuda_ms(calls[tag], BLOCK_ITERS))
        out.update({f"{tag}_ms": min(times[tag]) for tag in libs})
        out.update({f"{tag}_median_ms": statistics.median(times[tag]) for tag in libs})
    return out


def report_block(r: dict) -> int:
    B, T, D, H = r["shape"]
    print(f"card: {card_line()}")
    print(f"attention sublayer B={B} T={T} D={D} H={H} bf16 (best / median of "
          f"{len(TURNS) // 2} turns of {BLOCK_ITERS}): a {r['a_ms']:.4f} / "
          f"{r['a_median_ms']:.4f} ms, b {r['b_ms']:.4f} / {r['b_median_ms']:.4f} ms "
          f"(b/a {r['b_ms'] / r['a_ms']:.3f})")
    right = r["a_worst"] <= 1.0 and r["b_worst"] <= 1.0
    print(f"  vs plain (tol {r['tol']:.3e} abs + rel): a max_abs_err {r['a_max_abs_err']:.3e} "
          f"(worst/bound {r['a_worst']:.3f}), b {r['b_max_abs_err']:.3e} "
          f"(worst/bound {r['b_worst']:.3f}); b equals a bit for bit: {r['b_equals_a']}")
    print(f"both trees within the tolerance of plain: {right}")
    return 0 if right else 1


# --packed: (B, T, H) of each case, as chip_smoke.py's PACKED_SHAPES (the
# probe's shape first: the one timed), and the calls a turn
PACKED_SHAPES = {"probe": (80, 257, 16), "ragged": (3, 50, 12), "t63": (4, 63, 6),
                 "t64": (3, 64, 4), "t65": (2, 65, 8), "t1": (3, 1, 2), "t577": (2, 577, 4)}
PACKED_ITERS = 20
PACKED_QK_TOL = 1e-4


def build_packed(csrc: Path, out: Path) -> ctypes.CDLL:
    """packed_heads.cu of csrc built into out and loaded, its two entry
    points typed."""
    lib = _nvcc_all({"packed_heads": "packed_heads.cu"}, csrc, out)["packed_heads"]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_qk_scores.argtypes = [p, p, p, i, i, i, ctypes.c_float, i, p]
    lib.bvt_pv.argtypes = [p, p, p, i, i, i, i, p]
    lib.bvt_error_string.argtypes = [i]
    lib.bvt_error_string.restype = ctypes.c_char_p
    return lib


def packed_launcher(lib, name: str, x, y, out, num_heads: int):
    """A call of one tree's kernel `name` (a key of packed_heads.KERNELS) on
    x, y into out."""
    from bayesvlm_tpu_torch.probes import packed_heads as ph

    packed = int(name.endswith("packed"))
    B, T = y.shape[:2]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if name.startswith("qk"):
            err = lib.bvt_qk_scores(x.data_ptr(), y.data_ptr(), out.data_ptr(), B, T,
                                    num_heads, ph.SCALE, packed, stream)
        else:
            err = lib.bvt_pv(x.data_ptr(), y.data_ptr(), out.data_ptr(), B, T, num_heads,
                             packed, stream)
        kernels.check(lib, err, f"{name} kernel")

    return call


def run_packed(args) -> dict:
    """Both trees' four packed-head kernels at each shape: each against
    plain, b's bits against a's, and at the probe's shape both timed in
    turns."""
    from bayesvlm_tpu_torch.probes import packed_heads as ph

    out = {"cases": {}}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        libs = {}
        for tag in ("a", "b"):
            (Path(tmp) / tag).mkdir()
            libs[tag] = build_packed(getattr(args, tag), Path(tmp) / tag)
        for label, (B, T, H) in PACKED_SHAPES.items():
            gen = torch.Generator(device="cuda").manual_seed(T + H)
            q, k, v = (torch.randn(B, T, H * 64, generator=gen, device="cuda").bfloat16()
                       for _ in range(3))
            p = torch.randn(B, H, T, T, generator=gen, device="cuda")
            operands = {"qk_scores": (q, k), "qk_scores_packed": (q, k), "pv": (p, v),
                        "pv_packed": (ph.pack_pairs(p).contiguous(), v)}
            for name, (_, plain, _, _) in ph.KERNELS.items():
                x, y = operands[name]
                ref = plain(x, y, H)
                outs = {tag: torch.full_like(ref, float("nan")) for tag in libs}
                calls = {tag: packed_launcher(libs[tag], name, x, y, outs[tag], H)
                         for tag in libs}
                for call in calls.values():
                    call()
                torch.cuda.synchronize()
                r = {"b_equals_a": bool(torch.equal(outs["a"], outs["b"]))}
                for tag in libs:
                    if name.startswith("qk"):
                        err = (outs[tag] - ref).abs()
                        r[f"{tag}_max_abs_err"] = float(err.max())
                        r[f"{tag}_ok"] = bool(
                            (err <= PACKED_QK_TOL + PACKED_QK_TOL * ref.abs()).all())
                    else:
                        try:
                            r[f"{tag}_max_abs_err"] = ph.pv_check(outs[tag], ref)[
                                "max_abs_err"]
                            r[f"{tag}_ok"] = True
                        except RuntimeError:
                            r[f"{tag}_max_abs_err"] = float(
                                (outs[tag].float() - ref.float()).abs().max())
                            r[f"{tag}_ok"] = False
                if label == "probe":
                    times = {"a": [], "b": []}
                    for tag in TURNS:
                        times[tag].append(cuda_ms(calls[tag], PACKED_ITERS))
                    r.update({f"{tag}_ms": min(times[tag]) for tag in libs})
                    r.update({f"{tag}_median_ms": statistics.median(times[tag])
                              for tag in libs})
                out["cases"][(label, (B, T, H), name)] = r
                del outs, calls, ref
    return out


def report_packed(results: dict) -> int:
    print(f"card: {card_line()}")
    print(f"packed-head probe kernels (times at the probe's shape, best / median of "
          f"{len(TURNS) // 2} turns of {PACKED_ITERS}):")
    for (label, (B, T, H), name), r in results["cases"].items():
        line = (f"  {label:6s} B={B} T={T} H={H} {name:16s} right: a {r['a_ok']} (max |d| "
                f"{r['a_max_abs_err']:.3e}), b {r['b_ok']} ({r['b_max_abs_err']:.3e}); "
                f"b equals a: {r['b_equals_a']}")
        if "a_ms" in r:
            line += (f"; a {r['a_ms']:.4f} / {r['a_median_ms']:.4f} ms, b {r['b_ms']:.4f} / "
                     f"{r['b_median_ms']:.4f} ms (b/a {r['b_ms'] / r['a_ms']:.3f})")
        print(line)
    right = all(r["a_ok"] and r["b_ok"] for r in results["cases"].values())
    print(f"every output right in both trees: {right}")
    return 0 if right else 1


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip()


def cuda_ms(fn, iters: int = ITERS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    if args.gemm or args.int8 or args.epig or args.block or args.packed:
        if not torch.cuda.is_available():
            raise RuntimeError("compare_builds times kernels on the card: no CUDA device")
        if args.packed:
            return report_packed(run_packed(args))
        if args.epig:
            return report_epig(run_epig(args))
        if args.block:
            return report_block(run_block(args))
        return report_int8(run_int8(args)) if args.int8 else report_gemm(run_gemm(args))
    return report(run(args))


if __name__ == "__main__":
    sys.exit(main())
