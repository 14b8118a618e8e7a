"""The TPU probes of `scripts/dev/`, ported to the card.

The attention-schedule probes (this module's harness):

Each probe module (`bench_attn_variants`, `bench_attn_variants2`,
`bench_attn_variants3`, `bench_split_attn`) is run as

    python -m bayesvlm_tpu_torch.probes.<name> [--device cuda] [shape flags]

and does what its script does, at the script's shape (B=80, T=257,
H=16, Dh=64, bf16, inputs from `np.random.default_rng(0).normal`): it
checks each variant against the one-block kernel #1 (`max |base - vX|`)
and against its own plain version, then times #1, each variant and its
plain version with CUDA events (best of REPS runs of N_ITER launches, a
tenth of that for the plain versions), beside the bound and
`F.scaled_dot_product_attention` (timed only; the port never calls it).
This module holds what they share; `card` holds what every probe
shares (peaks, bound, CUDA-event timing).

The packed-head and GEMM probes (`probe_packed_heads`, `bench_int8_mxu`,
`bench_int8_sweep`, `bench_int4_mxu`; kernels in `packed_heads` and
`tile_gemm`) carry their own. Every probe module has the same entry:
`parse_args(argv)`, `run(args)` (the numbers; each kernel's under
`["kernels"][name]`), `report(results)` and `main(argv)`.

`--device cpu` runs the plain versions at a tiny shape for the tests:
the checks run, no time is measured ("not measured").

`compare_builds` is no port of a script: it builds the bf16 attention
kernels of two `csrc/` trees (a parent commit's and this one) and times
them in turns on the card, so that a redesign is measured against what
it replaces in one run.
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bayesvlm_tpu_torch.probes import card
from bayesvlm_tpu_torch.probes.card import device_ms
from bayesvlm_tpu_torch.probes.card import fmt_ms as _ms

# the scripts' shape and timing (scripts/dev/bench_attn_variants.py:35-37)
B, T, H, DH = 80, 257, 16, 64
N_ITER, REPS = 50, 5
# the scripts' dtype
DTYPE = torch.bfloat16
# kernel vs plain, as chip_smoke.py holds #1 in bf16: both round p and the
# output at the same points; an fp32 sum in another order moves a value
# across a rounding boundary by one bf16 ulp (2^-8 relative), and a p flip
# and an output flip can stack
TOL = 2.0 ** -6


class Variant(NamedTuple):
    """One timed variant of a probe: the kernel's wrapper and its plain
    version, each called as fn(q, k, v, num_heads); the kernel's name in
    `attention_variants.KERNELS` (for its body, shared memory, registers
    and blocks an SM), None for a kernel of `models.attention`; what it
    changes."""

    fn: Callable
    plain: Callable
    kernel: Optional[str]
    what: str


Variants = Dict[str, Variant]


def parse_args(argv, description: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--seq", type=int, default=T)
    p.add_argument("--heads", type=int, default=H)
    p.add_argument("--head-dim", type=int, default=DH)
    return p.parse_args(argv)


def inputs(args) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v [B, T, H*Dh] drawn as the scripts draw them."""
    rng = np.random.default_rng(0)
    shape = (args.batch, args.seq, args.heads * args.head_dim)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(args.device, DTYPE) for _ in range(3))


def bound(args) -> dict:
    """The least time the card could take: q, k, v read and o written once
    over the memory rate, against 4 B H T^2 Dh operations over the tensor
    cores' bf16 rate."""
    nbytes = 4 * args.batch * args.seq * args.heads * args.head_dim * DTYPE.itemsize
    flops = 4 * args.batch * args.heads * args.seq ** 2 * args.head_dim
    return {**card.bound(nbytes, flops, "bf16"), "bytes": nbytes, "flops": flops}


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def run(variants: Variants, args) -> dict:
    """The probe: #1 (the one-block fused_attention, `base`) and each
    variant on the scripts' inputs; each variant's max |base - v| and its
    error against its plain version (which must stay within TOL); then
    the times. Returns the numbers (ms None off the card)."""
    import torch.nn.functional as F

    from bayesvlm_tpu_torch.models.attention import fused_attention
    from bayesvlm_tpu_torch.probes.attention_variants import MEAN_TOL, block_resources

    device = torch.device(args.device)
    q, k, v = inputs(args)
    nh = args.heads
    ob = fused_attention(q, k, v, nh)
    out = {"shape": dict(B=args.batch, T=args.seq, H=nh, Dh=args.head_dim,
                         dtype="bf16"), "variants": {},
           "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                      else device.type)}
    for label, (fn, plain, kernel, _) in variants.items():
        o, ref = fn(q, k, v, nh), plain(q, k, v, nh)
        err = (o.float() - ref.float()).abs()
        if float((err / (TOL + TOL * ref.float().abs())).max()) > 1.0:
            raise RuntimeError(f"{label} disagrees with its plain version: max |d| "
                               f"{float(err.max()):.3e} (tol {TOL:.3e} abs + rel)")
        if float(err.mean()) > MEAN_TOL.get(kernel, math.inf):
            raise RuntimeError(f"{label} strays from its plain version: mean |d| "
                               f"{float(err.mean()):.3e} (tol {MEAN_TOL[kernel]:.0e})")
        out["variants"][label] = r = {"vs_base": _max_abs(ob, o),
                                      "max_abs_err": _max_abs(o, ref), "body": None,
                                      "smem_bytes": None, "registers": None,
                                      "blocks_per_sm": None}
        if kernel is not None and device.type == "cuda":
            r.update(block_resources(kernel, args.batch, args.seq, nh, args.head_dim,
                                     q.dtype))

    def time(fn, iters=N_ITER):
        return device_ms(lambda: fn(q, k, v, nh), device, iters, REPS)

    out["base_ms"] = time(fused_attention)
    for label, (fn, plain, _, _) in variants.items():
        r = out["variants"][label]
        r["ms"], r["plain_ms"] = time(fn), time(plain, N_ITER // 10)
    heads = [t.view(args.batch, args.seq, nh, args.head_dim).transpose(1, 2)
             for t in (q, k, v)]
    out["sdpa_ms"] = device_ms(lambda: F.scaled_dot_product_attention(*heads), device,
                               N_ITER, REPS)
    out.update(bound(args))
    # each kernel's numbers under its name, as every probe gives them
    out["kernels"] = {kernel: dict(out["variants"][label], library_ms=out["sdpa_ms"],
                                   base_ms=out["base_ms"], bound_ms=out["bound_ms"],
                                   bound_by=out["bound_by"])
                      for label, (_, _, kernel, _) in variants.items() if kernel is not None}
    return out


def report(variants: Variants, results: dict) -> int:
    """Print the probe's lines (as the script's, plus the bound, #1 and
    SDPA beside each time); returns the exit code."""
    s = results["shape"]
    print(f"shape B={s['B']} T={s['T']} H={s['H']} Dh={s['Dh']} {s['dtype']} "
          f"on {results['device']}")
    for label, r in results["variants"].items():
        print(f"max |base - {label}| = {r['vs_base']:.6g}   "
              f"(vs its plain version: {r['max_abs_err']:.3e})")

    def rate(ms):
        return "" if ms is None else f"  ({results['flops'] / ms / 1e9:.1f} TFLOP/s)"

    print(f"base (#1 one-block): {_ms(results['base_ms'])}{rate(results['base_ms'])}")
    for label, r in results["variants"].items():
        block = ("" if r["smem_bytes"] is None else
                 f"  [body {r['body']}: {r['smem_bytes']} B shared memory, "
                 f"{r['registers']} registers, {r['blocks_per_sm']} blocks/SM]")
        print(f"{label} ({variants[label].what}): {_ms(r['ms'])}{rate(r['ms'])}  "
              f"base {_ms(results['base_ms'])}  plain {_ms(r['plain_ms'])}  bound "
              f"{results['bound_ms']:.4g} ms ({results['bound_by']})  SDPA "
              f"{_ms(results['sdpa_ms'])}{block}")
    return 0


def entry_points(variants: Variants, description: str):
    """A probe module's `parse_args(argv)`, `run(args)`, `report(results)`
    and `main(argv)`: the entry every probe module has (the packed-head
    and GEMM probes define theirs)."""

    def probe_parse_args(argv=None) -> argparse.Namespace:
        return parse_args(argv, description)

    def probe_run(args) -> dict:
        return run(variants, args)

    def probe_report(results: dict) -> int:
        return report(variants, results)

    def probe_main(argv=None) -> int:
        return probe_report(probe_run(probe_parse_args(argv)))

    return probe_parse_args, probe_run, probe_report, probe_main
