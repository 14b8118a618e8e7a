"""Where the fused probit head's time goes inside its kernel, on the card.

torch.profiler times a launch whole. This probe builds a copy of
`csrc/smith_head.cu` with `%globaltimer` stamps added (`instrumented`),
calls it through `compare_builds.smith_launcher` at each of
`compare_builds.SMITH_CASES`, and reports, for each phase of the fused
kernel, the mean and the largest time over its CTAs:

  first     the wait for the first stage of the ring;
  main      the main loops of all the CTA's column tiles (first included);
  epilogue  split k: the cluster's combine (barriers, bulk copies, the
            adds, the row scales and the probit); split columns: each
            tile's logits from the accumulators;
  softmax   the row softmax (split columns: with the cluster's exchange
            of row maxima and sums);

and the launch's span (first CTA start to last CTA end) beside the spread
of the CTAs' starts, which shows the waves of clusters. The stamps cost a
few registers and stores; the probe's times are not the kernel's.

    python -m bayesvlm_tpu_torch.probes.smith_phases [--csrc DIR]

There is no CPU mode: without a card and nvcc it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.probes import compare_builds as cb

PHASES = ("first", "main", "epilogue", "softmax")
MAX_CTAS = 4096
ITERS = 20

_SOFTMAX_COLUMNS = ("    softmax_columns<NT>(logits, l.ld, smem + l.stats, cluster, cs, rank, ct0, "
                    "dct, p, row0);\n")
_TILE_END = "                         p.C, scaled, lt == 0);\n  }\n"
# (text of smith_head.cu, what replaces it), each text found once
_EDITS = (
    ("namespace {\n\nconstexpr int BM = 64;",
     "__device__ unsigned long long bvt_stamps[4096][6];\n"
     "__device__ __forceinline__ unsigned long long bvt_now() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n\nnamespace {\n\nconstexpr int BM = 64;"),
    ("  const int g = lane / 4, t = lane % 4;\n",
     "  unsigned long long ts_[6] = {bvt_now(), 0, 0, 0, 0, 0}, tt = 0;\n"
     "  const int g = lane / 4, t = lane % 4;\n"),
    ("    for (int j = 0; j < n_st; ++j) {\n      wg::mbar_wait(&full[slot], phase);\n",
     "    tt = bvt_now();\n"
     "    for (int j = 0; j < n_st; ++j) {\n      wg::mbar_wait(&full[slot], phase);\n"
     "      if (j == 0 && lt == 0) ts_[1] = bvt_now() - tt;\n"),
    ("#pragma unroll\n    for (int off = 1; off < 4; off *= 2) {  // the rows' E",
     "    ts_[2] += bvt_now() - tt;\n    tt = bvt_now();\n"
     "#pragma unroll\n    for (int off = 1; off < 4; off *= 2) {  // the rows' E"),
    (_TILE_END,
     "                         p.C, scaled, lt == 0);\n    ts_[3] += bvt_now() - tt;\n  }\n"
     "  tt = bvt_now();\n"),
    (_SOFTMAX_COLUMNS + "}",
     _SOFTMAX_COLUMNS + "  ts_[4] = bvt_now() - tt;\n  ts_[5] = bvt_now();\n"
     "  const int cta = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "  if (threadIdx.x == 0 && cta < 4096)\n"
     "    for (int i = 0; i < 6; ++i) bvt_stamps[cta][i] = ts_[i];\n}"),
    ("const char* bvt_error_string(int err)",
     "int bvt_smith_stamps(unsigned long long* host) {\n"
     "  return cudaMemcpyFromSymbol(host, bvt_stamps, sizeof(bvt_stamps));\n}\n\n"
     "const char* bvt_error_string(int err)"),
)


def instrumented(source: str) -> str:
    """smith_head.cu's text with the phase stamps and their reader,
    `bvt_smith_stamps`, added; raises when a text it edits is not found
    once (the kernel moved on and this probe has to follow it)."""
    for old, new in _EDITS:
        if source.count(old) != 1:
            raise ValueError(f"smith_phases: not found once in smith_head.cu: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csrc", type=Path, default=kernels.CSRC,
                   help="the csrc/ directory whose smith_head.cu is instrumented")
    return p.parse_args(argv)


def run(args) -> dict:
    """Each case's plan, CUDA-event ms of the instrumented kernel and its
    phases over the CTAs (`["cases"][label]`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("smith_phases times the kernel on the card: no CUDA device")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {"cases": {}}
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        csrc = Path(tmp) / "csrc"
        csrc.mkdir()
        for header in args.csrc.glob("*.cuh"):
            (csrc / header.name).write_text(header.read_text())
        (csrc / "smith_head.cu").write_text(
            instrumented((args.csrc / "smith_head.cu").read_text()))
        lib = cb.build_smith(csrc, Path(tmp))
        lib.bvt_smith_head_resources.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        log_scale = torch.full((1,), cb.SMITH_LOGIT_SCALE, device="cuda")
        for label, (B, C, D) in cb.SMITH_CASES.items():
            gen = torch.Generator(device="cuda").manual_seed(B + C + D)
            ops = (torch.randn(B, D, generator=gen, device="cuda"),
                   0.01 + 0.49 * torch.rand(B, D, generator=gen, device="cuda"),
                   torch.randn(C, D, generator=gen, device="cuda"),
                   0.01 + 0.49 * torch.rand(C, D, generator=gen, device="cuda"))
            res = (ctypes.c_int * 9)()
            kernels.check(lib, lib.bvt_smith_head_resources(B, C, D, res), "smith_head plan")
            ctas = res[2] * -(-B // 64)
            call = cb.smith_launcher(lib, *ops, log_scale, torch.empty(B, C, device="cuda"))
            ms = cb.cuda_ms(call, ITERS)
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (MAX_CTAS * 6))()
            kernels.check(lib, lib.bvt_smith_stamps(buf), "smith_head stamps")
            a = np.array(buf, dtype=np.float64).reshape(MAX_CTAS, 6)[:min(ctas, MAX_CTAS)]
            r = {"ms": ms, "ctas": ctas, "cluster": res[2], "tiles": res[1],
                 "span_us": (a[:, 5].max() - a[:, 0].min()) / 1e3,
                 "start_spread_us": (a[:, 0].max() - a[:, 0].min()) / 1e3}
            for i, name in enumerate(PHASES, start=1):
                r[name] = {"mean_us": a[:, i].mean() / 1e3, "max_us": a[:, i].max() / 1e3}
            out["cases"][(label, (B, C, D))] = r
    return out


def report(results: dict) -> int:
    print(f"card: {cb.card_line()}")
    print("fused probit head, phases of the instrumented kernel (mean / max over its "
          "CTAs, us):")
    for (label, (B, C, D)), r in results["cases"].items():
        mode = "split k" if r["tiles"] == 1 else f"split columns ({r['tiles']} tiles)"
        print(f"  {label} B={B} C={C} D={D}: {r['ms']:.4f} ms a call, {r['ctas']} CTAs in "
              f"clusters of {r['cluster']}, {mode}; span {r['span_us']:.2f}, starts spread "
              f"over {r['start_spread_us']:.2f}")
        print("    " + "; ".join(f"{name} {r[name]['mean_us']:.2f} / {r[name]['max_us']:.2f}"
                                 for name in PHASES))
    return 0


def main(argv=None) -> int:
    return report(run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
