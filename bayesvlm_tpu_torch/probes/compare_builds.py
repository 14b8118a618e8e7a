"""The bf16 attention kernels of two source trees, side by side on the card.

    python -m bayesvlm_tpu_torch.probes.compare_builds --a DIR --b DIR [--changed v2 v3]

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
    return p.parse_args(argv)


def build(csrc: Path, out: Path) -> dict:
    """attention.cu and attention_variants.cu of csrc built into out (two
    nvcc at once) and loaded: {"attention": lib, "variants": lib}."""
    jobs = {"attention": "attention.cu", "variants": "attention_variants.cu"}
    procs = {name: subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                                     str(out / f"{name}.so"), str(csrc / src)])
             for name, src in jobs.items()}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {csrc / jobs[name]}")
    libs = {name: ctypes.CDLL(str(out / f"{name}.so")) for name in jobs}
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
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
    return report(run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
