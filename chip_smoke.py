#!/usr/bin/env python3
"""Drive the PyTorch port's Stage-2 and Stage-3 paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, without the result line):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel of the paths (csrc/attention.cu,
     csrc/attention_block.cu, csrc/attention_variants.cu,
     csrc/mlp_int8.cu, csrc/linear_int8.cu, csrc/xlogy_rowsum.cu,
     csrc/smith_head.cu, csrc/packed_heads.cu, csrc/tile_gemm.cu; nvcc,
     sm_90a, one process each, all started together) from this checkout,
     with each one's time;
  3. attention kernel vs plain at the ViT-L/14 shape (B=64, T=257, H=16,
     Dh=64) and the ViT-B/32 shape (T=50, H=12), bf16 and fp32, with
     errors and CUDA-event times; F.scaled_dot_product_attention timed
     beside it as the yardstick (library_ms; the port never calls it).
     The same for the split-key and packed-pair schedules at ViT-L/14
     (bf16, fp32) and packed at T=50, and one-block at SigLIP's T=256
     (no class token, no remainder row) and, bf16, one-block and packed
     at ViT-L/14 at 336 px (T=577) and packed at T=1024; at T=50
     split_key takes the one-block schedule (its count is the one that
     moves). bf16 packed must equal bf16 one-block bit for bit at every
     shape. Beside each time: the body the launch took (bf16 every
     schedule the tensor-core body, "mma"; fp32 the CUDA-core body,
     "simt"), its shared memory a block, registers a thread and blocks
     an SM. Then, at ViT-L/14 bf16, the shipped packed pair (two heads
     side by side in a block) timed in turns beside the in-turn design
     (two heads walked in turn, the probes' group kernel at 2 heads a
     block) and one-block. Then each schedule's entry point,
     fused_attention(..., split_key=True) and (..., packed_heads=True),
     driven once with every count set to 0;
  3b. the attention sublayer kernel chain (fused_attention_block) vs
     plain at the ViT-L/14 sublayer (B=64, T=257, D=1024, H=16), bf16 and
     fp32, and a ragged small shape; beside it, for reference only (no
     single PyTorch call computes the sublayer), the chain F.layer_norm
     -> F.linear (QKV) -> SDPA -> F.linear -> add; the body, shared
     memory, registers and blocks an SM of its attention core; and, bf16,
     its two projections' (the wgmma body with the bias epilogue) shared
     memory, registers and blocks an SM, each launch of a call (LN, QKV,
     core, out-projection) timed apart by torch.profiler, and the
     projections alone (QKV; the out-projection with and without its
     residual) by CUDA events;
  4. int8 kernels vs plain at the ViT-L/14 shapes in bf16 (M = 64*257):
     mlp_int8 plain and fused pre-LN (D=1024, F=4096, tanh-GELU), once
     with 4-bit weights; linear_int8 for the fused QKV (N=3072, three
     outputs) and the out-projection (N=1024); and a ragged M. Beside
     them, for reference only (no single PyTorch call computes the W8A8
     function): the bf16 cuBLAS sublayer each replaces and torch._int_mm
     on the same int8 operands; the body (both GEMMs on the wgmma body
     of csrc/wgmma_gemm.cuh), shared memory, blocks an SM and registers
     of their GEMMs, and each call's launches (quantize, GEMM1, activation
     + requantize, GEMM2) timed apart by torch.profiler;
  5. EPIG joint-entropy kernel vs plain at the reference operating point
     (pool 4000, targets 2000, C=65, K=100 MC samples: a [260000, 130000]
     joint), bf16 and int8, a ragged small shape, and K=400 (the streamed
     instantiation; pool 1000, targets 500): row sums and EPIG
     scores within a stated tolerance, top-50 overlap with the plain
     ranking (printed), times, bound and the cuBLAS bf16 product of the
     same shape as a yardstick (reference only), and each instantiation's
     shared memory, registers, local memory and blocks an SM (the wgmma
     body: resident at K=100, streamed at K=400). The int8 kernel's path,
     `epig_from_probs_fused(use_int8=True)`, is read with its count;
  5b. fused probit head kernel (fused_probit_probs, csrc/smith_head.cu)
     vs plain in fp32 at B=2048 with C=1000, D=768 (ImageNet, ViT-L/14
     widths) and C=102, D=1024 (flowers102, SigLIP-L), at predict's head
     (B=64, C=100, D=768) and a ragged B=37, C=13, D=80: max |d| within
     rtol 1e-4 / atol 1e-5 at SigLIP's logit scale, rows summing to 1
     within 1e-5, the kernel's resources (registers, shared memory, local
     memory, cluster width), CUDA-event times and two bounds (3xTF32 on
     the tensor cores, the old fp32 CUDA-core one); a C past the
     shared-memory limit must raise;
  6. bf16 main path: ProbabilisticVLM.from_pretrained("clip-large", bf16,
     seeded random towers, synthetic full-dimension K-FAC factors) ->
     set_class_prompts(100 prompts) -> predict on [64, 224, 224, 3]
     pixels; checks shape, finiteness, row sums, 24 attention launches
     per image-tower forward and agreement with an fp32 predict;
  7. int8 main path: the same with mlp_int8=True, attn_int8=True; checks
     24 mlp_int8, 48 linear_int8 and 24 attention launches per forward,
     none from the text tower, and the image embeddings' cosine against
     the bf16 lane's; prints img/s beside the bf16 lane's;
  7b. block lane: the bf16 lane's towers, with the vision tower rebuilt
     from dataclasses.replace(vision, attn_pallas_block=True) and the
     same weights (as the JAX package reaches the lane), then
     set_class_prompts -> predict; checks 24 attention_block launches
     and no other per forward, none from the text tower, and the
     embeddings' cosine against the bf16 lane's; prints img/s;
  8. Stage-3 online EPIG path at clip-large width: from_pretrained, 6000
     pool and 2000 target images of seeded pixels and 65 prompts encoded,
     then select_epig_online(budget=3, num_samples=100,
     pool_subsampling="knn_wasserstein", the active-learning defaults);
     checks 3 distinct indices, finite scores, one kernel launch per step
     and pool chunk, and lambda moved; ms per step and its split;
  8b. Stage-2 zero-shot evaluation at siglip-large width through the
     port's CLI, zeroshot.run (the steps under zeroshot.main): seeded
     bf16 towers (24 x 1024 vision at 256 px / 16, T=256; 24 x 1024
     text, length 64), synthetic
     full-dimension K-FAC factors (A 4097 image, 1025 text), `synthetic`
     with 2048 test images of 256 px and 100 classes, batch 64,
     pseudo_data_count 10 and the CLI's 1000 lambda steps; then the fused
     head on the run's own features and sigma. Checks ACC, NLPD, ECE
     finite (ECE in [0, 1]), lambda moved, 24 attention launches per
     image-tower forward (none from the text tower or the probe), one
     fused-head launch, and the fused head's probabilities against the
     CLI's (rtol 1e-4, atol 1e-5); prints the seconds of steps [1]-[4],
     img/s of the image features and the head's times at the run's shape
     beside the CLI's eager chain;
  9. tiny-clip on the card against tiny-clip on the CPU, in the default
     lane and in the block lane; tiny-siglip the same, default lane;
  10. the attention-schedule probes (bayesvlm_tpu_torch/probes,
     csrc/attention_variants.cu): v2, v3, v4, v5 (H/2 heads a block) and
     v6 (2 batch rows a block) vs plain at the probes' shape (B=80,
     T=257, H=16, Dh=64) and a ragged T=50, H=12, bf16 and fp32, v2 and
     v3 also in bf16 at T=1024, Dh 64 and 80; v5 and v6 also equal to #1
     of their dtype bit for bit; each with the body it took (bf16 the
     tensor-core body, fp32 the CUDA-core body);
  10b. the packed-head and GEMM probe kernels (csrc/packed_heads.cu,
     csrc/tile_gemm.cu) vs plain: qk scores and p . v, per head and
     packed (wgmma; q, k, v, o by TMA, the fp32 tensor by bulk copies),
     at B=80, T=257, H=16 and the ragged PACKED_SHAPES (qk rtol = atol =
     1e-4; pv one bf16 ulp and a mean |d| limit that a single bf16
     rounding of p must exceed, both means printed), with each kernel's
     threads, registers, shared memory, blocks an SM and local memory,
     the qk staging plan at each T, and at the probe's shape each
     kernel's CUDA-event time beside its device time a call by
     torch.profiler; the GEMM at the
     probes' M, K, N = 16384, 1024, 4096, a ragged 1000 x 128 x 1008 and
     1000 x 128 x 2144 (N past the last full epilogue box) and 1000 x 96
     x 1008 (K not a multiple of 64), bf16 and s8 on the wgmma body at
     each of its 8 configurations, s4 x s4 and s8 x s4 on its tile 0
     after their unpacking prepass (the prepass alone equal to the plain
     unpacking; s8, s4 x s4, s8 x s4 exact; bf16 within 1e-5 of max
     |ref|; at the probes' shape each s4 kind's prepass and GEMM timed
     apart by torch.profiler); then
     the probes' entry points, each probe module's run and report (the
     attention probes: the check against #1 and against plain,
     CUDA-event times beside #1, the bound and SDPA; probe_packed_heads,
     bench_int8_mxu, bench_int8_sweep (all 8 tiles) and bench_int4_mxu:
     their checks, then times beside the bound, plain and the library
     call of the same function where there is one: torch.baddbmm (fp32
     out) for qk, torch.mm (fp32 out) for the bf16 GEMM, torch._int_mm
     for s8), with every count set to 0 just before and read just after;
  11. prints the kernels line (the attention and probe entries with the
     body they launched, their shared memory, registers and blocks an
     SM), then the result line {"ok": true, "device": {...}} last.

Each path's launch counts are set to 0 just before it and read just
after; the launches of phases 3, 4, 5, 5b, 10's and 10b's comparisons
are not counted.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np

MODEL = "clip-large"
BATCH = 64
NUM_PROMPTS = 100
PREDICT_CALLS = 5
SEED = 0
# bf16 kernel vs plain: both round p and the output to bf16; a different
# fp32 summation order moves a value across a rounding boundary by one
# bf16 ulp (2^-8 relative), and a p flip and an output flip can stack.
# fp32: summation order only.
KERNEL_TOL = {"bf16": 2.0 ** -6, "fp32": 1e-4}
# attention sublayer kernel vs plain: LN, q, k, v, p, the attention output,
# the out-projection and x + out are each rounded to bf16 once, at the same
# points in both. A flip upstream (one ulp of one q, k, v or a element)
# moves the fp32 sums after it by far less than an ulp of their result
# (it is one term of a 1024-term sum, ~2^-8 of its size), so what reaches
# the output is the last two roundings, out and x + out, one ulp each:
# the attention kernel's tolerance again. fp32: summation order only.
BLOCK_TOL = KERNEL_TOL
# block lane vs bf16 lane of the same weights: both bf16 with the same
# rounding points but one per projection (the block kernel adds the bias
# before it rounds) and the summation order; each changes a value by at
# most an ulp (2^-8), a random walk over 24 layers of ~1e-2 relative at
# worst, a cosine above 0.9999. 0.999 leaves room and still catches a
# wrong weight, head or layout (a cosine far below 0.99).
BLOCK_EMBED_COS_MIN = 0.999
# bf16 towers vs fp32 towers of the same weights. With random weights
# the probit probs are near uniform (max ~0.014 over 100 classes), so
# top-1 agreement is decided by noise-sized margins and is only printed.
# Checked instead: the log-probs, whose error is at most twice the
# largest logit error; a logit is a cosine times e^4.6 = 100 (divided by
# sqrt(1 + pi/8 var) >= 1), and bf16 keeps 2^-9 relative per rounding,
# which over 24 layers leaves cosine errors of a few 1e-3, i.e. logit
# errors of ~0.1-0.3. And the image embeddings' cosine similarity.
BF16_LOGP_ATOL = 0.5
BF16_EMBED_COS_MIN = 0.99
# int8 lane vs bf16 lane of the same weights: W8A8 rounds every
# activation row and weight channel to 1/127 of its absmax, a relative
# error of ~1-2% per sublayer output (the JAX package bounds one MLP at
# 5% relative L2, tests/test_mlp_int8.py). 48 such sublayers feed the
# residual stream; their errors are independent, so they add as a random
# walk, ~sqrt(48) * 2% = 14% relative L2 at worst-typical, a cosine of
# ~0.99. 0.95 leaves room for ~30% and still catches a lane that is
# wrong (a wrong scale or layout gives a cosine near 0).
INT8_EMBED_COS_MIN = 0.95
# tiny-clip fp32 on the card vs on the CPU: fp32 summation order only
TINY_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and operations/s
# of the tensor cores by operand type (fp32: the CUDA cores)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "tf32": 494.7e12}
# transcendentals (MUFU lg2) per SM per clock; the card's rate is this
# times its SM count and maximum SM clock, read in phase_device
MUFU_PER_SM_CLOCK = 16
DEVICE = {}
# the EPIG reference operating point (the JAX package's bench.py)
EPIG_POOL, EPIG_TARG, EPIG_C, EPIG_K = 4000, 2000, 65, 100
# EPIG kernel vs plain, row sums: both take the same fp32 s (bf16 products
# are exact; int8 sums exact in both), so they differ by the fp32
# summation order of N = 130,000 terms of one sign (a kernel thread adds
# a row's N / 4 as tile sums of 16: at worst (16 + N / 64) * 2^-24 =
# 1.2e-4 of the sum, typically about the square root of that count times
# 2^-24, 3e-6) and by lg2.approx (<= 3e-7 s a term).
# A score is (sum over the C rows of a pool item) / N_t, so its error is
# at most 1e-4 * sum_c |r| / N_t.
ROWSUM_RTOL = 1e-4
# Stage-3 online EPIG path, the active-learning script's settings
# (scripts/activelearning.py:67-71, 185-210)
EPIG_POOL_IMAGES, EPIG_TARGET_IMAGES, EPIG_CLASSES = 6000, 2000, 65
EPIG_BUDGET, EPIG_CHUNK = 3, 4096
# fused probit head vs plain: both fp32, summation order only; the JAX
# package's tolerance (tests/test_pallas_smith.py:30)
SMITH_RTOL, SMITH_ATOL, SMITH_ROW_TOL = 1e-4, 1e-5, 1e-5
SMITH_SHAPES = {"imagenet vit-l/14": (2048, 1000, 768),
                "flowers102 siglip-l": (2048, 102, 1024),
                "predict head": (BATCH, NUM_PROMPTS, 768),
                "ragged": (37, 13, 80)}
# Stage-2 zero-shot evaluation (scripts/zeroshot.py's chain) at full width
ZS_MODEL, ZS_IMAGES, ZS_CLASSES, ZS_BATCH, ZS_IMAGE_SIZE = (
    "siglip-large", 2048, 100, 64, 256)
# EPIG past the resident block's shared memory: the streamed instantiation
EPIG_LONG_POOL, EPIG_LONG_TARG, EPIG_LONG_K = 1000, 500, 400
# the probes of scripts/dev/, each run through its module's run and report
PROBES = ("bench_attn_variants", "bench_attn_variants2", "bench_attn_variants3",
          "bench_split_attn", "probe_packed_heads", "bench_int8_mxu", "bench_int8_sweep",
          "bench_int4_mxu")
# each probe kernel: the probe whose run gives its line, its source under
# bayesvlm_tpu_torch/csrc/ and the TPU body it replaces (under scripts/dev/)
PROBE_KERNELS = {
    "attention_v2": ("bench_attn_variants", "attention_variants.cu",
                     "bench_attn_variants.py:45"),
    "attention_v3": ("bench_attn_variants", "attention_variants.cu",
                     "bench_attn_variants.py:45"),
    "attention_v4": ("bench_attn_variants2", "attention_variants.cu",
                     "bench_attn_variants2.py:46"),
    "attention_group_heads": ("bench_attn_variants2", "attention_variants.cu",
                              "bench_attn_variants2.py:68"),
    "attention_group_rows": ("bench_attn_variants3", "attention_variants.cu",
                             "bench_attn_variants3.py:37"),
    "qk_scores": ("probe_packed_heads", "packed_heads.cu", "probe_packed_heads.py:46"),
    "qk_scores_packed": ("probe_packed_heads", "packed_heads.cu",
                         "probe_packed_heads.py:58"),
    "pv": ("probe_packed_heads", "packed_heads.cu", "probe_packed_heads.py:86"),
    "pv_packed": ("probe_packed_heads", "packed_heads.cu", "probe_packed_heads.py:97"),
    "tile_gemm_bf16": ("bench_int8_mxu", "tile_gemm.cu", "bench_int8_mxu.py:64"),
    "tile_gemm_s8": ("bench_int8_mxu", "tile_gemm.cu", "bench_int8_mxu.py:64"),
    "tile_gemm_s4": ("bench_int4_mxu", "tile_gemm.cu", "bench_int4_mxu.py:49"),
    "tile_gemm_s8s4": ("bench_int4_mxu", "tile_gemm.cu", "bench_int4_mxu.py:49"),
}
# what a probe kernel's line carries beside the contract's keys, where its
# probe gives it (reference_ms: a product of another function, timed for
# reference only)
PROBE_EXTRAS = ("smem_bytes", "blocks_per_sm", "base_ms", "vs_base", "tops", "tile", "mma",
                "yardstick", "reference_ms")
# the body of each kernel source other than the attention kernel, the
# attention probes and the GEMM probes (which report their own: the GEMMs
# "wgmma" for all four kinds, the s4 kinds after an unpacking prepass
# that widens their nibbles to s8): "wgmma" where its
# products run on wgmma fed by TMA with the PTX of csrc/wgmma_gemm.cuh
# (the attention sublayer's bf16 projections, the int8 lane's two kernels,
# the EPIG kernel, the fused head's 3xTF32 products), "mma" where they run
# on the tensor cores by mma.sync, "simt" where they run as fp32 FMAs on
# the CUDA cores
SOURCE_BODY = {"attention_block.cu": "wgmma", "mlp_int8.cu": "wgmma", "linear_int8.cu": "wgmma",
               "xlogy_rowsum.cu": "wgmma", "smith_head.cu": "wgmma", "packed_heads.cu": "wgmma"}
# the packed-head kernels at the probe's shape (first: the one timed) and
# ragged ones (B, T, H): T mod 4 = 2, 3, 0, 1 (a last strip of one row), T =
# 1, and T = 577 (two p chunks a side, qk strips of fewer than 64 rows
# packed); probes/compare_builds.py --packed checks the same
PACKED_SHAPES = {"probe": (80, 257, 16), "ragged": (3, 50, 12), "t63": (4, 63, 6),
                 "t64": (3, 64, 4), "t65": (2, 65, 8), "t1": (3, 1, 2), "t577": (2, 577, 4)}
# the launches inside one packed-head kernel call (csrc/packed_heads.cu)
PACKED_PARTS = (("qk_kernel", r"qk_kernel"), ("pv_kernel", r"pv_kernel"))
# the GEMM at the probes' shape and three ragged ones (M, K, N); N a
# multiple of 16; "ragged-n" (N = 96 mod 128 and 256: the wgmma epilogue
# skips the boxes past N); "ragged-k" (K not a multiple of a wgmma stage,
# 64 bf16 or 128 s8, nor of 64: the s4 kinds' packed A rows are 48 bytes)
GEMM_SHAPES = {"probe": (16384, 1024, 4096), "ragged": (1000, 128, 1008),
               "ragged-n": (1000, 128, 2144), "ragged-k": (1000, 96, 1008)}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, op_type: str,
          transcendentals: float = 0.0) -> dict:
    """The least time the card could take: the largest of the bytes over
    the memory rate, the operations over the peak rate of their type and
    the transcendentals over the MUFU rate."""
    times = {"bytes": nbytes / HBM_BYTES_S * 1e3,
             "operations": ops / PEAK_OPS_S[op_type] * 1e3,
             "transcendentals": transcendentals / DEVICE.get("mufu_s", 1.0) * 1e3}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by}


def phase_device(torch) -> str:
    check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(clk.stdout.strip().splitlines()[0])
    DEVICE["mufu_s"] = MUFU_PER_SM_CLOCK * sms * mhz * 1e6
    print(f"SMs {sms}, max SM clock {mhz:.0f} MHz: {DEVICE['mufu_s']:.4e} "
          f"transcendentals/s")
    # cuDNN runs fp32 convolutions in TF32 by default; fp32 matmuls stay
    # full fp32 (the default, left as it is)
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0)


def phase_build(kernels, modules) -> None:
    t0 = time.perf_counter()
    seconds = kernels.build_all()
    wall = time.perf_counter() - t0
    for name, sec in seconds.items():
        took = "already built" if sec is None else f"{sec:.2f} s"
        print(f"build: {kernels.library_path(name).name} {took}")
    print(f"build: {len(seconds)} kernels in {wall:.2f} s wall (in parallel)")
    check(set(seconds) == {"attention", "attention_block", "attention_variants",
                           "mlp_int8", "linear_int8", "xlogy_rowsum", "smith_head",
                           "packed_heads", "tile_gemm"},
          f"kernel sources {sorted(seconds)}")
    for module in modules:
        module._library()


def _attention_case(torch, attention, label: str, B: int, T: int, H: int, Dh: int,
                    dname: str, **schedule) -> dict:
    """One schedule of the attention kernel vs plain on seeded q, k, v."""
    import torch.nn.functional as F

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dname]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(B, T, H * Dh, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    out = attention.fused_attention(q, k, v, H, **schedule)
    ref = attention.fused_attention_reference(q, k, v, H)
    torch.cuda.synchronize()
    if schedule.get("packed_heads") and dname == "bf16":
        # each warp of the pair does a one-block warp's work for its head
        same = torch.equal(out, attention.fused_attention(q, k, v, H))
        print(f"attention {label} bf16 equal to one-block bit for bit: {same}")
        check(same, f"{label} bf16 packed pair differs from one-block")
    err = (out.float() - ref.float()).abs()
    tol = KERNEL_TOL[dname]
    worst = float((err / (tol + tol * ref.float().abs())).max())
    ms = cuda_ms(torch, lambda: attention.fused_attention(q, k, v, H, **schedule))
    plain_ms = cuda_ms(torch, lambda: attention.fused_attention_reference(q, k, v, H))
    heads = [t.view(B, T, H, Dh).transpose(1, 2) for t in (q, k, v)]
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(*heads))
    # the real work whatever the schedule: q, k, v read and o written once,
    # 4 B H T^2 Dh operations (no padded keys, no zero blocks)
    b = bound(4 * B * T * H * Dh * q.element_size(), 4 * B * H * T * T * Dh, dname)
    max_err = float(err.max())
    res = attention.kernel_resources(T, Dh, dtype, attention.schedule_for(T, **schedule))
    print(f"attention {label} vs plain {dname} B={B} T={T} H={H} Dh={Dh}: "
          f"max_abs_err={max_err:.3e} (tol {tol:.3e} abs + rel, worst/bound="
          f"{worst:.3f}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"sdpa_ms={library_ms:.4f} bound_ms={b['bound_ms']:.4f} ({b['bound_by']})"
          f"\n  body {res['body']}: {res['smem_bytes']} B shared memory, "
          f"{res['registers']} registers a thread, {res['blocks_per_sm']} blocks/SM")
    check(worst <= 1.0, f"{label} {dname} attention kernel disagrees with plain "
                        f"(max_abs_err {max_err})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **b, **res)


def phase_attention_vs_plain(torch, attention) -> dict:
    """The three schedules of csrc/attention.cu vs plain."""
    shapes = {"vit-l/14": (BATCH, 257, 16, 64), "vit-b/32": (BATCH, 50, 12, 64),
              "siglip-l/16": (BATCH, 256, 16, 64)}
    results = {}
    for shape_name, shape in shapes.items():
        for dname in ("bf16", "fp32"):
            results[(shape_name, dname)] = _attention_case(
                torch, attention, f"one-block {shape_name}", *shape, dname)
    for sched in ("split_key", "packed_heads"):
        for dname in ("bf16", "fp32"):
            results[("vit-l/14", dname, sched)] = _attention_case(
                torch, attention, f"{sched} vit-l/14", *shapes["vit-l/14"], dname,
                **{sched: True})
    results[("vit-b/32", "bf16", "packed_heads")] = _attention_case(
        torch, attention, "packed_heads vit-b/32", *shapes["vit-b/32"], "bf16",
        packed_heads=True)
    # ViT-L/14 at 336 px: T=577, past what the CUDA-core body's bf16 score
    # tile held at its speed (the tensor-core body takes any T); the
    # packed pair there, and at T=1024, past what its two score tiles held
    results[("vit-l/14-336", "bf16")] = _attention_case(
        torch, attention, "one-block vit-l/14-336", BATCH, 577, 16, 64, "bf16")
    results[("vit-l/14-336", "bf16", "packed_heads")] = _attention_case(
        torch, attention, "packed_heads vit-l/14-336", BATCH, 577, 16, 64, "bf16",
        packed_heads=True)
    results[("t1024", "bf16", "packed_heads")] = _attention_case(
        torch, attention, "packed_heads T=1024", 16, 1024, 16, 64, "bf16",
        packed_heads=True)
    # T=50 has no 128-key main block: split_key takes the one-block
    # schedule, as in JAX, and counts there
    fa = attention.fused_attention
    before = fa.launches, fa.launches_split
    _attention_case(torch, attention, "split_key vit-b/32", *shapes["vit-b/32"], "bf16",
                    split_key=True)
    moved = fa.launches - before[0], fa.launches_split - before[1]
    print(f"attention split_key at T=50 (t_main = 0) took the one-block schedule: "
          f"one-block launches +{moved[0]}, split-key +{moved[1]}")
    check(moved[0] > 0 and moved[1] == 0, "split_key at T=50 must run one-block")
    return results


def phase_packed_pair_designs(torch, attention, av) -> dict:
    """The packed pair's two tensor-core designs at ViT-L/14 bf16, timed
    in turns (side, in turn, #1, #1, in turn, side; each the best of its
    two): the shipped one, two heads side by side in a block of 8 warps
    (fused_attention(..., packed_heads=True)), and two heads walked in
    turn by a block of 4 warps (mha_mma_kernel<64, kOneBlock, 2, 1>, the
    probes' group kernel at 2 heads a block, launched through the probe
    library for this timing only). Both must equal #1 bit for bit."""
    from bayesvlm_tpu_torch import kernels

    B, T, H, Dh = BATCH, 257, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    q, k, v = (torch.randn(B, T, H * Dh, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    lib = av._library()
    o = torch.empty_like(q)

    def in_turn():
        err = lib.bvt_attn_variant(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   B, T, H, Dh, 1, 1.0 / math.sqrt(Dh), av.GROUP, 2, 1,
                                   torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, err, "in-turn packed pair")
        return o

    designs = {"side_by_side": lambda: attention.fused_attention(q, k, v, H,
                                                                 packed_heads=True),
               "in_turn": in_turn,
               "one_block": lambda: attention.fused_attention(q, k, v, H)}
    base = designs["one_block"]()
    for name in ("side_by_side", "in_turn"):
        same = torch.equal(designs[name](), base)
        check(same, f"packed pair {name} differs from one-block")
    ms = {name: math.inf for name in designs}
    for name in ("side_by_side", "in_turn", "one_block", "one_block", "in_turn",
                 "side_by_side"):
        ms[name] = min(ms[name], cuda_ms(torch, designs[name], iters=50))
    print(f"packed pair designs B={B} T={T} H={H} Dh={Dh} bf16 (both equal to one-block "
          f"bit for bit): side by side {ms['side_by_side']:.4f} ms (shipped), in turn "
          f"{ms['in_turn']:.4f} ms, one-block {ms['one_block']:.4f} ms")
    return ms


def phase_schedule_paths(torch, attention, counters) -> dict:
    """The entry point that reaches the split-key and packed-pair kernels
    in JAX, fused_attention(q, k, v, 16, split_key=True) and
    (..., packed_heads=True), at the ViT-L/14 shape in bf16, each driven
    once with every count set to 0 just before and read just after."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    q, k, v = (torch.randn(BATCH, 257, 1024, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    launches = {}
    for sched, count in (("split_key", "attention_split"),
                         ("packed_heads", "attention_packed")):
        for c in counters.values():
            c.launches = 0
        out = attention.fused_attention(q, k, v, 16, **{sched: True})
        torch.cuda.synchronize()
        got = {n: c.launches for n, c in counters.items()}
        print(f"{sched} path fused_attention(..., {sched}=True) B={BATCH} T=257: "
              f"launches={got}")
        check(got == {n: int(n == count) for n in counters}, f"{sched} path launches")
        check(bool(torch.isfinite(out.float()).all()), f"{sched}: non-finite output")
        launches[count] = got[count]
    return launches


def phase_block_vs_plain(torch, attention) -> dict:
    """The attention sublayer kernel chain vs plain."""
    import torch.nn.functional as F

    results = {}
    for label, (B, T, D, H) in (("vit-l/14", (BATCH, 257, 1024, 16)),
                                ("ragged", (3, 37, 80, 1))):
        for dname in ("bf16", "fp32"):
            dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dname]
            gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

            def randn(*shape, scale=1.0):
                return torch.randn(*shape, generator=gen, device="cuda") * scale

            x = randn(B, T, D).to(dtype)
            ln_w, ln_b = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
            ws = [randn(D, D, scale=D ** -0.5).to(dtype) for _ in range(4)]
            bs = [randn(D, scale=0.02).to(dtype) for _ in range(4)]
            params = [t for pair in zip(ws, bs) for t in pair]
            run = lambda: attention.fused_attention_block(x, ln_w, ln_b, *params,
                                                          num_heads=H)
            plain = lambda: attention.fused_attention_block_reference(
                x, ln_w, ln_b, *params, num_heads=H)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            tol = BLOCK_TOL[dname]
            worst = float((err / (tol + tol * ref.float().abs())).max())
            r = {"max_abs_err": float(err.max())}
            print(f"attention block {label} vs plain {dname} B={B} T={T} D={D} H={H}: "
                  f"max_abs_err={r['max_abs_err']:.3e} (tol {tol:.3e} abs + rel, "
                  f"worst/bound={worst:.3f})")
            check(worst <= 1.0, f"{label} {dname} attention block kernel disagrees "
                                f"with plain (max_abs_err {r['max_abs_err']})")
            if label == "ragged":
                continue
            r["ms"], r["plain_ms"] = cuda_ms(torch, run), cuda_ms(torch, plain, iters=5)
            r["core"] = attention.kernel_resources(T, D // H, dtype)
            if dname == "bf16":
                # the two projections on the wgmma body: what they take, and
                # each launch of a call timed apart
                r["gemms"] = attention.block_gemm_resources()
                r["parts_ms"] = _launch_parts(torch, run, BLOCK_PARTS)
                r["projections_ms"] = _block_projections_ms(torch, attention, x, ws, bs)
                print(f"  bf16 GEMMs (wgmma_gemm_kernel, EpiBias): {r['gemms']}")
                _print_parts(f"attention block {label}", r["parts_ms"])
                print(f"  the projections alone (CUDA events, on x as the input): "
                      f"{r['projections_ms']}")
            # yardstick (reference only): the cuBLAS / SDPA chain on the same
            # tensors, the QKV weights concatenated once outside the timing
            wqkv, bqkv = torch.cat(ws[:3]), torch.cat(bs[:3])

            def chain():
                h = F.layer_norm(x.float(), (D,), ln_w, ln_b, 1e-5).to(dtype)
                q, k, v = (t.view(B, T, H, D // H).transpose(1, 2)
                           for t in F.linear(h, wqkv, bqkv).split(D, dim=-1))
                a = F.scaled_dot_product_attention(q, k, v)
                return x + F.linear(a.transpose(1, 2).reshape(B, T, D), ws[3], bs[3])

            r["chain_ms"] = cuda_ms(torch, chain)
            # the function's bytes: x read, out written, the four weights,
            # biases and LN parameters; its operations: the four products
            # and the attention core (attention_pallas.py:344)
            Dh = D // H
            nbytes = ((2 * B * T * D + 4 * D * D + 4 * D) * x.element_size()
                      + 2 * D * 4)
            r.update(bound(nbytes, B * (8 * T * D * D + 4 * H * T * T * Dh), dname))
            print(f"  kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); yardstick "
                  f"(reference only) LN -> F.linear QKV -> SDPA -> F.linear -> add "
                  f"{r['chain_ms']:.4f} ms; attention core: {r['core']}")
            results[dname] = r
    return results


def _block_projections_ms(torch, attention, x, ws, bs) -> dict:
    """The sublayer's bf16 projections alone through their C entry, on x
    [B, T, D] as the input: QKV (three weights), the out-projection with
    the residual x, and without it (the residual's cost)."""
    a = x.view(-1, x.shape[-1])
    out = torch.empty(3, *a.shape, device=x.device, dtype=x.dtype)

    def gemm(idx, residual):
        return lambda: attention._block_projection(a, [ws[i] for i in idx],
                                                   [bs[i] for i in idx], residual, out)

    return {"qkv": cuda_ms(torch, gemm((0, 1, 2), None), iters=50),
            "out_proj": cuda_ms(torch, gemm((3,), a), iters=50),
            "out_proj_no_residual": cuda_ms(torch, gemm((3,), None), iters=50)}


def _flip_check(torch, name: str, out, ref) -> dict:
    """An int8 kernel against its plain version, to the lane's flip
    tolerance (the JAX package's, tests/test_mlp_int8.py:50-62)."""
    from bayesvlm_tpu_torch.models.mlp_int8 import FLIP_TOL_MAX, FLIP_TOL_MEAN

    d = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max()) + 1e-12
    max_err, mean_err = float(d.max()), float(d.mean())
    print(f"  {name}: max_abs_err={max_err:.3e} (tol {FLIP_TOL_MAX * scale:.3e}) "
          f"mean_abs_err={mean_err:.3e} (tol {FLIP_TOL_MEAN * scale:.3e}) "
          f"flipped={int((d > 0).sum())}/{d.numel()}")
    check(max_err <= FLIP_TOL_MAX * scale and mean_err <= FLIP_TOL_MEAN * scale,
          f"{name}: the kernel disagrees with its plain version")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err}


# the launches inside one int8 kernel call, by the name the profiler gives
# them (the first pattern that matches)
INT8_PARTS = (("GEMM1 (EpiDequant<float, false>)", r"EpiDequant<float, false>"),
              ("GEMM2 or linear (EpiDequant<out, residual>)", r"EpiDequant<"),
              ("activation + requantize (act_quant_rows_kernel)", r"act_quant_rows_kernel"),
              ("quantize x (quant_rows_kernel)", r"quant_rows_kernel"))
# the same for one attention sublayer call (csrc/attention_block.cu)
BLOCK_PARTS = (("QKV (wgmma_gemm_kernel, EpiBias<false>)", r"EpiBias<false>"),
               ("out-projection + residual (EpiBias<true>)", r"EpiBias<true>"),
               ("LayerNorm (ln_rows_kernel)", r"ln_rows_kernel"),
               ("attention core (mha_mma_kernel)", r"mha_mma_kernel|mha_kernel"))


def _launch_parts(torch, fn, table=INT8_PARTS, calls: int = 5) -> dict:
    """Each launch of a kernel call timed apart: torch.profiler over
    `calls` calls, device ms a call by `table` (anything else under
    "other")."""
    import re

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        label = next((lb for lb, pat in table if re.search(pat, e.key)), "other")
        parts[label] = parts.get(label, 0.0) + us / 1e3 / calls
    check(sum(parts.values()) > 0, "the profiler recorded no device time for a kernel call")
    return parts


def _print_parts(label: str, parts: dict) -> None:
    total = sum(parts.values())
    print(f"  {label} by launch (torch.profiler, device ms a call; shares of "
          f"{total:.4f}): " + ", ".join(f"{k} {v:.4f} ({v / total:.1%})"
                                       for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))


def phase_int8_vs_plain(torch, mlp, linear) -> dict:
    """Both int8 kernels at the ViT-L/14 int8 lane's shapes, bf16: each
    against plain, its time beside the bound and the yardsticks, its GEMMs'
    resources, and the share of each launch inside a call."""
    import torch.nn.functional as F

    M, D, Fd = BATCH * 257, 1024, 4096
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(M, D).bfloat16()
    w1 = randn(Fd, D, scale=D ** -0.5).bfloat16()
    w2 = randn(D, Fd, scale=Fd ** -0.5).bfloat16()
    b1, b2 = randn(Fd, scale=0.02), randn(D, scale=0.02)
    ln = dict(ln_weight=1.0 + randn(D, scale=0.1), ln_bias=randn(D, scale=0.1),
              ln_eps=1e-5)
    results = {}

    print(f"int8 kernels vs plain (bf16, M={M}):")
    for label, bits, kw in (("mlp_int8 plain", 8, {}), ("mlp_int8 fused-LN", 8, ln),
                            ("mlp_int8 fused-LN w4", 4, ln)):
        quant = mlp.quantize_mlp_weights(w1, w2, bits)
        run = lambda: mlp.mlp_int8(x, w1, b1, w2, b2, "gelu_tanh", quant=quant, **kw)
        plain = lambda: mlp.mlp_int8_reference(x, w1, b1, w2, b2, "gelu_tanh",
                                               quant=quant, **kw)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        r = _flip_check(torch, f"{label} D={D} F={Fd}", out, ref)
        r["ms"], r["plain_ms"] = cuda_ms(torch, run), cuda_ms(torch, plain, iters=5)
        # the function's bytes: x read, out written, int8 weights, fp32
        # scales, biases and LN parameters; its operations: the two int8
        # products (the fp32 epilogues are ~1% of them)
        nbytes = (2 * M * D * x.element_size() + 2 * D * Fd
                  + 4 * (2 * Fd + 2 * D + (2 * D if kw else 0)))
        r.update(bound(nbytes, 4 * M * D * Fd, "int8"))
        r.update(mlp.kernel_resources(x.dtype))
        print(f"  {label}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); body {r['body']}: "
              f"{r['smem_bytes']} B shared memory, {r['blocks_per_sm']} blocks/SM, "
              f"registers at launch GEMM1 / GEMM2 {r['registers_gemm']}")
        r["parts_ms"] = _launch_parts(torch, run)
        _print_parts(label, r["parts_ms"])
        results[label] = r

    xq, _ = mlp._quant_rows(x.float())
    w1q, w2q = mlp.quantize_weight(w1)[0], mlp.quantize_weight(w2)[0]
    aq = torch.randint(-127, 128, (M, Fd), generator=gen, device="cuda",
                       dtype=torch.int8)
    yard = {
        "bf16_cublas_ms": cuda_ms(torch, lambda: F.linear(
            F.gelu(F.linear(x, w1, b1.bfloat16()), approximate="tanh"),
            w2, b2.bfloat16())),
        "int_mm_ms": cuda_ms(torch, lambda: (torch._int_mm(xq, w1q.t()),
                                             torch._int_mm(aq, w2q.t()))),
    }
    print(f"  yardsticks mlp (reference only): bf16 F.linear->GELU->F.linear "
          f"{yard['bf16_cublas_ms']:.4f} ms, torch._int_mm x2 "
          f"{yard['int_mm_ms']:.4f} ms")
    results["mlp_int8 yardsticks"] = yard
    del aq

    wqkv = randn(3 * D, D, scale=D ** -0.5).bfloat16()
    bqkv = randn(3 * D, scale=0.02)
    wo, bo = randn(D, D, scale=D ** -0.5).bfloat16(), randn(D, scale=0.02)
    for label, w, b, chunks in (("linear_int8 qkv", wqkv, bqkv, 3),
                                ("linear_int8 out_proj", wo, bo, 1)):
        N = w.shape[0]
        run = lambda: linear.linear_int8(x, w, b, chunks=chunks)
        plain = lambda: linear.linear_int8_reference(x, w, b)
        out = run()
        out = torch.cat(out, dim=-1) if chunks > 1 else out
        ref = plain()
        torch.cuda.synchronize()
        r = _flip_check(torch, f"{label} K={D} N={N}", out, ref)
        r["ms"], r["plain_ms"] = cuda_ms(torch, run), cuda_ms(torch, plain, iters=5)
        # bytes: x read, out written, the bf16 weight (quantized per call,
        # as in the JAX package), the fp32 bias
        nbytes = (M * D + M * N) * x.element_size() + N * D * w.element_size() + 4 * N
        r.update(bound(nbytes, 2 * M * D * N, "int8"))
        wq = linear.quantize_weight(w)[0]
        r["bf16_cublas_ms"] = cuda_ms(torch, lambda: F.linear(x, w, b.bfloat16()))
        r["int_mm_ms"] = cuda_ms(torch, lambda: torch._int_mm(xq, wq.t()))
        r.update(linear.kernel_resources(x.dtype, N, chunks))
        print(f"  {label}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); yardsticks "
              f"(reference only): bf16 F.linear {r['bf16_cublas_ms']:.4f} ms, "
              f"torch._int_mm {r['int_mm_ms']:.4f} ms; body {r['body']}: "
              f"{r['smem_bytes']} B shared memory, {r['blocks_per_sm']} blocks/SM, "
              f"{r['registers']} registers at launch, TMA store {r['tma_store']}")
        check(r["tma_store"], f"{label}: the chunked output should go out by the TMA")
        r["parts_ms"] = _launch_parts(torch, run)
        _print_parts(label, r["parts_ms"])
        results[label] = r

    # a ragged M (no multiple of the 128-row tile or of 32)
    Mr = 333
    xr = x[:Mr]
    quant = mlp.quantize_mlp_weights(w1, w2)
    _flip_check(torch, f"mlp_int8 fused-LN ragged M={Mr}",
                mlp.mlp_int8(xr, w1, b1, w2, b2, quant=quant, **ln),
                mlp.mlp_int8_reference(xr, w1, b1, w2, b2, quant=quant, **ln))
    _flip_check(torch, f"linear_int8 qkv ragged M={Mr}",
                torch.cat(linear.linear_int8(xr, wqkv, bqkv, chunks=3), dim=-1),
                linear.linear_int8_reference(xr, wqkv, bqkv))
    return results


def _drive(torch, counters, hessian_dir: str, pixels, prompts, per_forward: dict,
           vision=None, **lanes):
    """from_pretrained -> set_class_prompts -> predict x (PREDICT_CALLS+1)
    with every launch count set to 0 just before and read just after;
    checks each kernel's launches per image-tower forward (every count
    per_forward does not name: 0) and that the text tower launches none.
    `vision`: VisionConfig fields the image tower is rebuilt with, on the
    same weights (a lane from_pretrained has no keyword for, as in JAX).
    Returns (vlm, probs, launches, img/s, from_pretrained seconds, first
    call seconds, row-sum error)."""
    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    per_forward = {**dict.fromkeys(counters, 0), **per_forward}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    vlm = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="bf16",
                                           device="cuda", seed=SEED, **lanes)
    if vision:
        vlm.image_encoder = rebuild_image_encoder(vlm.image_encoder, **vision)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    vlm.set_class_prompts(prompts)
    check(all(c.launches == 0 for c in counters.values()),
          "the causal text tower must launch no kernel of the vision lanes")
    times, probs = [], None
    for _ in range(PREDICT_CALLS + 1):
        before = {n: c.launches for n, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = vlm.predict(pixels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = {n: c.launches - before[n] for n, c in counters.items()}
        check(got == per_forward, f"launches per image-tower forward: expected "
                                  f"{per_forward}, got {got}")
    launches = {n: c.launches for n, c in counters.items()}
    check(tuple(probs.shape) == (BATCH, NUM_PROMPTS), f"shape {tuple(probs.shape)}")
    check(bool(torch.isfinite(probs).all()), "non-finite probabilities")
    row_err = float((probs.sum(-1) - 1.0).abs().max())
    check(row_err <= 1e-5, f"rows sum to 1 within {row_err:.2e}")
    steady = times[1:]  # the first call pays cuBLAS/cuDNN warm-up
    img_s = BATCH * len(steady) / sum(steady)
    return vlm, probs, launches, img_s, t_load, times[0], row_err


def phase_main_path(torch, counters, hessian_dir: str, pixels, prompts):
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    vlm, probs, launches, img_s, t_load, t_first, row_err = _drive(
        torch, counters, hessian_dir, pixels, prompts, {"attention": L})
    print(f"bf16 main path: lambda_img={vlm.info['lambda_img']!r} "
          f"lambda_txt={vlm.info['lambda_txt']!r} from_pretrained_s={t_load:.2f} "
          f"predict_first_s={t_first:.3f} predict_img_s_B{BATCH}={img_s:.1f} "
          f"launches={launches} row_sum_err={row_err:.2e}")
    embeds = vlm.encode_images(pixels).embeds

    vlm32 = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="fp32",
                                             device="cuda", seed=SEED)
    vlm32.set_class_prompts(prompts)
    probs32 = vlm32.predict(pixels)
    logp_diff = float((probs.float().log() - probs32.log()).abs().max())
    top1 = float((probs.argmax(-1) == probs32.argmax(-1)).float().mean())
    cos = float(torch.nn.functional.cosine_similarity(
        embeds, vlm32.encode_images(pixels).embeds, dim=-1).min())
    print(f"bf16 vs fp32 predict: max_abs_logp_diff={logp_diff:.3e} "
          f"(tol {BF16_LOGP_ATOL}) max_abs_prob_diff="
          f"{float((probs.float() - probs32).abs().max()):.3e} "
          f"min_embed_cos={cos:.6f} (min {BF16_EMBED_COS_MIN}) "
          f"top1_agreement={top1:.3f} max_prob_fp32={float(probs32.max()):.4f} "
          f"lambda_img_fp32={vlm32.info['lambda_img']!r}")
    check(logp_diff <= BF16_LOGP_ATOL, "bf16 log-probs stray from fp32")
    check(cos >= BF16_EMBED_COS_MIN, "bf16 image embeddings stray from fp32")
    del vlm, vlm32
    return launches, img_s, embeds, probs


def phase_int8_path(torch, counters, hessian_dir: str, pixels, prompts,
                    bf16_embeds, bf16_probs, bf16_img_s):
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    vlm, probs, launches, img_s, t_load, t_first, row_err = _drive(
        torch, counters, hessian_dir, pixels, prompts,
        {"attention": L, "mlp_int8": L, "linear_int8": 2 * L},
        mlp_int8=True, attn_int8=True)
    cos = float(torch.nn.functional.cosine_similarity(
        vlm.encode_images(pixels).embeds, bf16_embeds, dim=-1).min())
    logp_diff = float((probs.float().log() - bf16_probs.float().log()).abs().max())
    print(f"int8 main path (mlp_int8 + attn_int8): from_pretrained_s={t_load:.2f} "
          f"predict_first_s={t_first:.3f} predict_img_s_B{BATCH}={img_s:.1f} "
          f"(bf16 lane {bf16_img_s:.1f}) launches={launches} "
          f"row_sum_err={row_err:.2e}")
    print(f"int8 vs bf16 lane: min_embed_cos={cos:.6f} (min {INT8_EMBED_COS_MIN}) "
          f"max_abs_logp_diff={logp_diff:.3e}")
    check(cos >= INT8_EMBED_COS_MIN, "int8 image embeddings stray from the bf16 lane")
    del vlm
    return launches, img_s


def phase_block_path(torch, counters, hessian_dir: str, pixels, prompts,
                     bf16_embeds, bf16_probs, bf16_img_s):
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    vlm, probs, launches, img_s, t_load, t_first, row_err = _drive(
        torch, counters, hessian_dir, pixels, prompts, {"attention_block": L},
        vision={"attn_pallas_block": True})
    cos = float(torch.nn.functional.cosine_similarity(
        vlm.encode_images(pixels).embeds, bf16_embeds, dim=-1).min())
    logp_diff = float((probs.float().log() - bf16_probs.float().log()).abs().max())
    print(f"block lane (attn_pallas_block): from_pretrained_s={t_load:.2f} "
          f"predict_first_s={t_first:.3f} predict_img_s_B{BATCH}={img_s:.1f} "
          f"(bf16 lane {bf16_img_s:.1f}) launches={launches} "
          f"row_sum_err={row_err:.2e}")
    print(f"block vs bf16 lane: min_embed_cos={cos:.6f} (min {BLOCK_EMBED_COS_MIN}) "
          f"max_abs_logp_diff={logp_diff:.3e}")
    check(cos >= BLOCK_EMBED_COS_MIN, "block-lane image embeddings stray from the "
                                      "bf16 lane")
    del vlm
    return launches, img_s


def _smith_operands(torch, B: int, C: int, D: int, seed: int):
    """Embeddings and positive diagonal covariances, seeded on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, D, generator=gen, device="cuda"),
            0.01 + 0.49 * torch.rand(B, D, generator=gen, device="cuda"),
            torch.randn(C, D, generator=gen, device="cuda"),
            0.01 + 0.49 * torch.rand(C, D, generator=gen, device="cuda"))


def _smith_check(torch, pk, label: str, ops, logit_scale, ref=None) -> dict:
    """The fused head vs `ref` (default: its plain version) on `ops`:
    |d| <= atol + rtol |ref| everywhere, rows summing to 1."""
    out = pk.fused_probit_probs(*ops, logit_scale)
    if ref is None:
        ref = pk.smith_probit_probs_reference(*ops, logit_scale)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    worst = float((err / (SMITH_ATOL + SMITH_RTOL * ref.abs())).max())
    row_err = float((out.sum(-1) - 1.0).abs().max())
    r = {"max_abs_err": float(err.max()), "row_sum_err": row_err}
    print(f"  {label}: max_abs_err={r['max_abs_err']:.3e} (rtol {SMITH_RTOL} atol "
          f"{SMITH_ATOL}, worst/bound={worst:.3f}) row_sum_err={row_err:.2e}")
    check(worst <= 1.0, f"{label}: the fused head disagrees (max_abs_err "
                        f"{r['max_abs_err']})")
    check(row_err <= SMITH_ROW_TOL, f"{label}: rows sum to 1 within {row_err:.2e}")
    return r


def _smith_bound(B: int, C: int, D: int) -> dict:
    """The least time at the accuracy the head is held to: three TF32
    passes of the three products, 18 B C D operations at the TF32 tensor
    rate, against the four fp32 operands read and the [B, C] output written
    once; beside it (fp32_bound_ms) the old yardstick, 6 B C D fp32
    operations on the CUDA cores."""
    nbytes = 4 * (2 * B * D + 2 * C * D + B * C)
    fp32 = bound(nbytes, 6 * B * C * D, "fp32")
    return {**bound(nbytes, 18 * B * C * D, "tf32"), "fp32_bound_ms": fp32["bound_ms"],
            "fp32_bound_by": fp32["bound_by"]}


def phase_smith_vs_plain(torch, pk) -> dict:
    """The fused probit head kernel vs plain, fp32, at the CLI's and
    predict's shapes and a ragged one; a C past the limit must raise."""
    logit_scale = 4.7651  # SigLIP's (models/encoders.DEFAULT_LOGIT_SCALE)
    print("fused probit head (csrc/smith_head.cu: 3xTF32 wgmma, split-k clusters) vs "
          "plain, fp32:")
    results = {}
    for i, (label, (B, C, D)) in enumerate(SMITH_SHAPES.items()):
        ops = _smith_operands(torch, B, C, D, SEED + 10 + i)
        r = _smith_check(torch, pk, f"{label} B={B} C={C} D={D}", ops, logit_scale)
        res = pk.kernel_resources(B, C, D)
        print(f"    resources: {res['registers']} registers, {res['smem_bytes']} B shared "
              f"memory, {res['local_bytes']} B local a thread; clusters of "
              f"{res['cluster']} (k split), {res['max_active_clusters']} at once; column "
              f"tile {res['nt']} x {res['tiles']}, {res['stages']} stages")
        r.update(registers=res["registers"], smem_bytes=res["smem_bytes"],
                 local_bytes=res["local_bytes"], cluster=res["cluster"])
        if label == "ragged":
            continue
        r["ms"] = cuda_ms(torch, lambda: pk.fused_probit_probs(*ops, logit_scale))
        r["plain_ms"] = cuda_ms(torch, lambda: pk.smith_probit_probs_reference(
            *ops, logit_scale))
        r.update(_smith_bound(B, C, D))
        print(f"    kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} (the eager "
              f"cuBLAS fp32 chain) bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, 3xTF32 "
              f"on the tensor cores) fp32_bound_ms={r['fp32_bound_ms']:.4f} "
              f"({r['fp32_bound_by']}, fp32 on the CUDA cores)")
        results[label] = r
    limit = pk.max_classes()
    ops = _smith_operands(torch, 4, limit + 1, 16, SEED + 20)
    try:
        pk.fused_probit_probs(*ops, logit_scale)
    except ValueError as e:
        print(f"  C={limit + 1} (past the limit of {limit}) raises: {e}")
    else:
        check(False, f"C={limit + 1} past the shared-memory limit did not raise")
    return results


def phase_zeroshot(torch, counters, hessian_dir: str) -> dict:
    """Stage-2 zero-shot evaluation at siglip-large width through the
    port's CLI (`zeroshot.run`, the steps under `main`), then the fused
    head on the run's features, every count set to 0 just before and read
    just after."""
    from bayesvlm_tpu_torch import zeroshot
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.probforward import kernels as pk
    from bayesvlm_tpu_torch.probforward.smith import activation_diag_covariance

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = zeroshot.run(
        "synthetic", hessian_dir, ZS_MODEL, pseudo_data_count=10,
        batch_size=ZS_BATCH, dtype="bf16", device="cuda",
        dataset_overrides=dict(image_size=ZS_IMAGE_SIZE, num_test=ZS_IMAGES,
                               num_classes=ZS_CLASSES))
    wall = time.perf_counter() - t0
    (acc, nlpd, ece), info = run["metrics"], run["info"]
    head, img, lab = run["head"], run["image_outputs"], run["label_outputs"]

    def sigmas():
        return (activation_diag_covariance(img.activations, head.source_covariance,
                                           head.source_projection_has_bias),
                activation_diag_covariance(lab.activations, head.target_covariance,
                                           head.target_projection_has_bias))

    sig_s, sig_t = sigmas()
    ops = (img.embeds, sig_s, lab.embeds, sig_t)
    fused = _smith_check(torch, pk, f"fused head on the run's features vs the CLI's "
                         f"probabilities B={len(img)} C={len(lab)}", ops,
                         head.logit_scale, ref=run["probs"])
    launches = {n: c.launches for n, c in counters.items()}

    L = CONFIGS_BY_NAME[ZS_MODEL].vision.num_layers
    forwards = -(-ZS_IMAGES // ZS_BATCH)
    expected = {n: 0 for n in counters}
    expected.update(attention=L * forwards, smith_head=1)
    sec = run["seconds"]
    img_s = ZS_IMAGES / sec["[2] image features"]
    print(f"zero-shot path ({ZS_MODEL}, bf16, synthetic {ZS_IMAGES} images of "
          f"{ZS_IMAGE_SIZE} px, {ZS_CLASSES} classes, batch {ZS_BATCH}): ACC={acc!r} "
          f"NLPD={nlpd!r} ECE={ece!r} lambda_img={info['lambda_img']!r} "
          f"lambda_txt={info['lambda_txt']!r} wall_s={wall:.2f} launches={launches}")
    for step, seconds in sec.items():
        print(f"  zero-shot step {step}: {seconds:.3f} s")
    print(f"  precompute_image_features: {img_s:.1f} img/s")
    check(all(np.isfinite(v) for v in (acc, nlpd, ece)), "non-finite metrics")
    check(0.0 <= ece <= 1.0, f"ECE {ece} outside [0, 1]")
    check(info["lambda_img"] != 300.0 and info["lambda_txt"] != 300.0,
          "lambda did not move from its initial 300")
    check(launches == expected, f"zero-shot path launches: expected {expected}, "
                                f"got {launches}")

    # the head at the run's shape: the kernel (given sigma), its plain
    # version, sigma alone, and the CLI's eager chain from the features
    # (make_predictions in one batch, then the probit softmax)
    from bayesvlm_tpu_torch.inference.predictions import make_predictions

    def cli_chain():
        pl = make_predictions(head, img, lab, batch_size=len(img))
        return torch.softmax(pl.mean / torch.sqrt(1.0 + np.pi / 8 * pl.var), dim=-1)

    B, C, D = len(img), len(lab), img.embeds.shape[1]
    fused["ms"] = cuda_ms(torch, lambda: pk.fused_probit_probs(*ops, head.logit_scale))
    fused["plain_ms"] = cuda_ms(torch, lambda: pk.smith_probit_probs_reference(
        *ops, head.logit_scale))
    fused["sigma_ms"] = cuda_ms(torch, sigmas)
    fused["cli_chain_ms"] = cuda_ms(torch, cli_chain)
    fused.update(_smith_bound(B, C, D))
    print(f"  fused head B={B} C={C} D={D}: kernel_ms={fused['ms']:.4f} "
          f"plain_ms={fused['plain_ms']:.4f} bound_ms={fused['bound_ms']:.4f} "
          f"({fused['bound_by']}, 3xTF32) fp32_bound_ms={fused['fp32_bound_ms']:.4f}; "
          f"sigma (both sides) {fused['sigma_ms']:.4f} ms; "
          f"yardstick (reference only) the CLI's eager chain from the features, "
          f"sigma included: {fused['cli_chain_ms']:.4f} ms")
    return {"launches": launches, "head": fused, "seconds": sec, "img_s": img_s}


def phase_tiny_reference(torch, attention, hessian_dir: str,
                         model: str = "tiny-clip",
                         lanes=("default", "block")) -> None:
    """A tiny model in fp32 through the kernels on the card vs the plain
    path on the CPU, with the same weights and Hessian factors, in the
    default lane and (tiny-clip) in the block lane."""
    from pathlib import Path

    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    cpu = ProbabilisticVLM.from_pretrained(model, hessian_dir,
                                           dtype="fp32", device="cpu",
                                           prior_num_steps=50)
    wd = Path(hessian_dir)
    torch.save(cpu.image_encoder.module.state_dict(), wd / "vision.pt")
    torch.save(cpu.text_encoder.module.state_dict(), wd / "text.pt")
    gpu = ProbabilisticVLM.from_pretrained(model, hessian_dir,
                                           weights_dir=hessian_dir,
                                           dtype="fp32", device="cuda",
                                           prior_num_steps=50)
    prompts = ["a cat", "a dog", "a bird"]
    pixels = np.random.default_rng(SEED + 2).normal(
        size=(8, 32, 32, 3)).astype(np.float32)
    for lane in lanes:
        if lane == "block":
            for vlm in (cpu, gpu):
                vlm.image_encoder = rebuild_image_encoder(vlm.image_encoder,
                                                          attn_pallas_block=True)
        ref = cpu.set_class_prompts(prompts).predict(pixels)
        before = attention.fused_attention_block.launches
        out = gpu.set_class_prompts(prompts).predict(pixels).cpu()
        blocks = attention.fused_attention_block.launches - before
        diff = float((out - ref).abs().max())
        print(f"{model} {lane} lane card vs CPU (fp32): max_abs_diff={diff:.3e} "
              f"(tol {TINY_TOL}) attention_block launches={blocks}")
        check(diff <= TINY_TOL, f"{model} {lane} lane on the card disagrees "
                                f"with the CPU")
        check(blocks == (0 if lane == "default" else 2), f"{model} {lane} lane "
                                                          f"block launches {blocks}")


class _Count:
    """One kernel's launch count, read and set as `.launches`."""

    def __init__(self, obj, attr: str):
        self.obj, self.attr = obj, attr

    @property
    def launches(self) -> int:
        return getattr(self.obj, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.obj, self.attr, value)


def _top_overlap(torch, a, b, k: int = 50) -> int:
    k = min(k, a.numel())
    ta = set(torch.topk(a, k).indices.tolist())
    return len(ta & set(torch.topk(b, k).indices.tolist()))


def _rowsum_check(torch, ej, label: str, pool, targ, k: int, use_int8: bool):
    """Kernel vs plain row sums and EPIG scores on the same operands."""
    n_p, n_t = pool.shape[0] // EPIG_C, targ.shape[0] // EPIG_C
    out = ej.joint_xlogy_rowsums(pool, targ, k, use_int8=use_int8)
    ref = ej.joint_xlogy_rowsums_reference(pool, targ, k, use_int8=use_int8)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    row_ok = bool((err <= ROWSUM_RTOL * ref.abs()).all())
    s_k = ej.scores_from_rowsums(pool, targ, out, n_p, n_t, EPIG_C)
    s_p = ej.scores_from_rowsums(pool, targ, ref, n_p, n_t, EPIG_C)
    score_tol = ROWSUM_RTOL * ref.abs().reshape(n_p, EPIG_C).sum(1) / n_t
    score_err = (s_k - s_p).abs()
    r = {"max_abs_err": float(err.max()), "max_rel_err": float((err / ref.abs()).max()),
         "max_score_err": float(score_err.max()), "scores": s_k, "plain_scores": s_p}
    print(f"  {label}: max |d rowsum|={r['max_abs_err']:.3e} (max rel "
          f"{r['max_rel_err']:.3e}, tol {ROWSUM_RTOL:.0e} rel) max |d EPIG|="
          f"{r['max_score_err']:.3e} (tol {float(score_tol.min()):.3e}.."
          f"{float(score_tol.max()):.3e}, per row)")
    check(row_ok, f"{label}: row sums disagree with the plain version")
    check(bool((score_err <= score_tol).all()),
          f"{label}: EPIG scores disagree with the plain version")
    return r


def _resources_line(r: dict) -> str:
    """The EPIG kernel instantiation's resources, as kernel_resources reads
    them."""
    kind = "streamed" if r["streamed"] else "resident"
    return (f"body {r['body']} ({kind}, K padded to {r['k_pad']}): {r['smem_bytes']} B "
            f"shared memory (limit {r['smem_limit']}), {r['threads']} threads of "
            f"{r['registers']} registers at launch, {r['local_bytes']} B local memory, "
            f"{r['blocks_per_sm']} blocks/SM")


def phase_epig_vs_plain(torch, ej, counters) -> dict:
    """The joint-entropy kernel, bf16 and int8, at the operating point."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def probs(n, k=EPIG_K):
        return torch.softmax(torch.randn(n, k, EPIG_C, generator=gen, device="cuda"), -1)

    probs_pool, probs_targ = probs(EPIG_POOL), probs(EPIG_TARG)
    pool, targ = ej._flatten(probs_pool), ej._flatten(probs_targ)
    M, N, K = pool.shape[0], targ.shape[0], EPIG_K
    print(f"EPIG joint-entropy kernel vs plain (pool {EPIG_POOL}, targets "
          f"{EPIG_TARG}, C={EPIG_C}, K={K}: M={M}, N={N}):")
    results = {}
    for name, use_int8, op_type in (("bf16", False, "bf16"), ("int8", True, "int8")):
        r = _rowsum_check(torch, ej, f"{name} M={M} N={N} K={K}", pool, targ, K,
                          use_int8)
        r["top50_overlap"] = _top_overlap(torch, r["scores"], r["plain_scores"])
        r["ms"] = cuda_ms(torch, lambda: ej.joint_xlogy_rowsums(
            pool, targ, K, use_int8=use_int8), iters=10, warmup=2)
        r["plain_ms"] = cuda_ms(torch, lambda: ej.joint_xlogy_rowsums_reference(
            pool, targ, K, use_int8=use_int8), iters=3, warmup=1)
        # the function's bytes: the fp32 operands read once, the row sums
        # written; its operations: the product at the unpadded K; one log
        # per joint element
        r.update(bound((M + N) * K * 4 + M * 4, 2 * M * N * K, op_type,
                       transcendentals=M * N))
        r.update(ej.kernel_resources(use_int8, K))
        print(f"  {name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) top50 overlap with "
              f"plain={r['top50_overlap']}/50\n  {_resources_line(r)}")
        # the streamed instantiation forced at the operating point: what
        # the resident one saves there (the wrapper takes it only past the
        # resident block's shared memory)
        ref = ej.joint_xlogy_rowsums_reference(pool, targ, K, use_int8=use_int8)
        err = (ej._launch(pool, targ, K, use_int8, streamed=True) - ref).abs()
        r["streamed_ms"] = cuda_ms(torch, lambda: ej._launch(
            pool, targ, K, use_int8, streamed=True), iters=10, warmup=2)
        r["streamed_max_rel_err"] = float((err / ref.abs()).max())
        print(f"  {name} streamed instantiation forced at K={K}: kernel_ms="
              f"{r['streamed_ms']:.4f} (resident {r['ms']:.4f}) max rel err "
              f"{r['streamed_max_rel_err']:.3e}")
        check(bool((err <= ROWSUM_RTOL * ref.abs()).all()),
              f"{name} streamed at K={K} disagrees with the plain version")
        results[name] = r

    # yardstick (reference only: no single PyTorch call computes the
    # function): the cuBLAS bf16 product of the same shape, in the plain
    # version's pool chunks, writing the joint chunk by chunk
    a16, b16 = pool.bfloat16(), targ.bfloat16()
    rows = ej._CHUNK_ELEMS // N

    def cublas():
        for i in range(0, M, rows):
            torch.matmul(a16[i:i + rows], b16.T)

    yard = cuda_ms(torch, cublas, iters=5, warmup=1)
    results["bf16"]["cublas_bf16_ms"] = yard
    print(f"  yardstick (reference only): cuBLAS bf16 joint product in "
          f"{-(-M // rows)} chunks of {rows} rows: {yard:.4f} ms")

    s16, s8 = results["bf16"]["scores"], results["int8"]["scores"]
    print(f"  int8 vs bf16 EPIG scores (printed only; the JAX package measured "
          f"int8 ranking-destroying): max |d|={float((s8 - s16).abs().max()):.3e} "
          f"score spread={float(s16.max() - s16.min()):.3e} top50 overlap="
          f"{_top_overlap(torch, s8, s16)}/50")

    # the int8 kernel's path (the JAX package's epig_from_probs_pallas with
    # use_int8=True), counts set to 0 just before and read just after
    for c in counters.values():
        c.launches = 0
    scores = ej.epig_from_probs_fused(probs_pool, probs_targ, use_int8=True)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    expected = {n: int(n == "xlogy_rowsum_int8") for n in counters}
    print(f"  int8 scoring path epig_from_probs_fused(use_int8=True): "
          f"launches={launches}")
    check(launches == expected, f"int8 scoring path launches {launches}")
    check(bool(torch.isfinite(scores).all()), "non-finite int8 EPIG scores")
    check(torch.equal(scores, s8), "the int8 scoring path disagrees with its kernel")
    results["int8"]["launches"] = launches["xlogy_rowsum_int8"]

    # a ragged small shape: M, N no multiple of the 128-row tiles, K = 9
    gen.manual_seed(SEED + 6)
    small_p, small_t = ej._flatten(probs(37, 9)), ej._flatten(probs(29, 9))
    for name, use_int8 in (("bf16", False), ("int8", True)):
        _rowsum_check(torch, ej, f"{name} ragged M={small_p.shape[0]} "
                      f"N={small_t.shape[0]} K=9", small_p, small_t, 9, use_int8)

    # K past the resident block's shared memory: the streamed instantiation
    K = EPIG_LONG_K
    gen.manual_seed(SEED + 11)
    long_p = ej._flatten(probs(EPIG_LONG_POOL, K))
    long_t = ej._flatten(probs(EPIG_LONG_TARG, K))
    Ml, Nl = long_p.shape[0], long_t.shape[0]
    for name, use_int8, op_type in (("bf16", False, "bf16"), ("int8", True, "int8")):
        r = _rowsum_check(torch, ej, f"{name} streamed M={Ml} N={Nl} K={K}", long_p,
                          long_t, K, use_int8)
        r["ms"] = cuda_ms(torch, lambda: ej.joint_xlogy_rowsums(
            long_p, long_t, K, use_int8=use_int8), iters=5, warmup=1)
        r.update(bound((Ml + Nl) * K * 4 + Ml * 4, 2 * Ml * Nl * K, op_type,
                       transcendentals=Ml * Nl))
        r.update(ej.kernel_resources(use_int8, K))
        print(f"  {name} streamed K={K}: kernel_ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})\n  {_resources_line(r)}")
        results[name][f"k{K}"] = {k: r[k] for k in (
            "max_abs_err", "max_rel_err", "ms", "bound_ms", "bound_by", "smem_bytes",
            "registers", "blocks_per_sm", "local_bytes")}
    for r in results.values():
        del r["scores"], r["plain_scores"]
    return results


def phase_epig_path(torch, counters, hessian_dir: str) -> dict:
    """Stage 3 at clip-large width: features from the port's bf16 towers
    on seeded pixels, then select_epig_online as the active-learning
    script runs it."""
    from bayesvlm_tpu_torch.io.artifacts import load_hessians
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
    from bayesvlm_tpu_torch.probforward import smith
    from bayesvlm_tpu_torch.select import epig as epig_mod
    from bayesvlm_tpu_torch.types import EncoderResult
    from bayesvlm_tpu_torch.utils import get_image_size

    t0 = time.perf_counter()
    vlm = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="bf16",
                                           device="cuda", seed=SEED)
    size = get_image_size(MODEL)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def encode(n: int, batch: int = 250) -> EncoderResult:
        parts = []
        for i in range(0, n, batch):
            pixels = torch.randn(min(batch, n - i), size, size, 3, generator=gen,
                                 device="cuda")
            parts.append(vlm.encode_images(pixels))
        r = EncoderResult.concatenate(parts)
        return EncoderResult(r.embeds.float(), r.activations.float(),
                             r.residuals.float())

    pool, targ = encode(EPIG_POOL_IMAGES), encode(EPIG_TARGET_IMAGES)
    labels = vlm.encode_texts([f"a photo of a thing of class {i}"
                               for i in range(EPIG_CLASSES)])
    labels = EncoderResult(labels.embeds.float(), labels.activations.float(),
                           labels.residuals.float())
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    A_img, B_img = load_hessians(hessian_dir, "img")
    A_txt, B_txt = load_hessians(hessian_dir, "txt")
    kernel = vlm.image_encoder.projection_weight().detach().float().T.contiguous()
    class_ids = np.random.default_rng(SEED + 7).integers(
        0, EPIG_CLASSES, size=EPIG_POOL_IMAGES)
    kwargs = dict(
        label_features=labels, pool_features=pool, target_features=targ,
        pool_class_ids=class_ids, projection_kernel=kernel, projection_bias=None,
        head=vlm.head, A_img=A_img, A_txt=A_txt, B_img=B_img, B_txt=B_txt,
        cov_info=vlm.info, budget=EPIG_BUDGET, lr=1e-4, hessian_update_scale=10.0,
        num_samples=EPIG_K, seed=0,
        projection_l2=vlm.image_encoder.projection_l2(),
        projection_num_params=vlm.image_encoder.projection_num_params(),
        chunk_size=EPIG_CHUNK, pool_subsampling="knn_wasserstein",
        k_nearest_neighbors=1, device="cuda")
    print(f"EPIG path (clip-large, bf16 towers): projection {tuple(kernel.shape)}, "
          f"{EPIG_POOL_IMAGES} pool + {EPIG_TARGET_IMAGES} target images and "
          f"{EPIG_CLASSES} prompts encoded; from_pretrained + features "
          f"{t_feat:.2f} s; lambda_img={vlm.info['lambda_img']!r}")

    # the main run: every count set to 0 just before, read just after
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    selected, scores = epig_mod.select_epig_online(**kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}

    # a second run with each part timed (synchronised wrappers) for the
    # split of a step; it also reads the pool subsample and lambda
    spans: dict = {}
    seen: dict = {"n_pool": [], "lambda": []}

    def timed(module, name, span, note=None):
        fn = getattr(module, name)

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[span] = spans.get(span, 0.0) + time.perf_counter() - t
            if note:
                note(args, kw, out)
            return out
        return fn, wrapper

    notes = {
        "epig_from_logits_using_matmul":
            lambda a, kw, out: seen["n_pool"].append(len(a[0])),
        "optimize_prior_precision":
            lambda a, kw, out: seen["lambda"].append(float(out)),
    }
    patches = [(epig_mod, "epig_from_logits_using_matmul", "scoring"),
               (smith, "probabilistic_logits", "scoring"),
               (epig_mod, "_epig_sgd_step", "sgd step + re-embed"),
               (epig_mod, "update_embeddings", "sgd step + re-embed"),
               (epig_mod, "hessian_infonce", "hessian update"),
               (epig_mod, "optimize_prior_precision", "lambda re-opt"),
               (epig_mod, "compute_covariances", "covariances")]
    originals = []
    for module, name, span in patches:
        fn, wrapper = timed(module, name, span, notes.get(name))
        originals.append((module, name, fn))
        setattr(module, name, wrapper)
    try:
        t0 = time.perf_counter()
        selected2, scores2 = epig_mod.select_epig_online(**kwargs)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)

    n_pool = seen["n_pool"][0]
    expected = {n: 0 for n in counters}
    expected["xlogy_rowsum"] = EPIG_BUDGET * -(-n_pool // EPIG_CHUNK)
    for span in ("scoring", "sgd step + re-embed", "hessian update",
                 "lambda re-opt", "covariances"):
        ms = spans.get(span, 0.0) / EPIG_BUDGET * 1e3
        print(f"  EPIG step split: {span}: {ms:.2f} ms per step")
    rest = (wall2 - sum(spans.values())) / EPIG_BUDGET * 1e3
    print(f"  EPIG step split: rest (subsampling, argsort, host loop): "
          f"{rest:.2f} ms per step")
    ms_step = wall / EPIG_BUDGET * 1e3
    print(f"EPIG path: selected={selected} scores={scores} pool_subsample={n_pool} "
          f"launches={launches} ms_per_step={ms_step:.2f} "
          f"(timed run {wall2 / EPIG_BUDGET * 1e3:.2f}) lambda_img "
          f"{vlm.info['lambda_img']!r} -> {seen['lambda']}")
    check(len(set(selected)) == EPIG_BUDGET, f"selected {selected}")
    check(all(np.isfinite(s) for s in scores), f"scores {scores}")
    check(launches == expected, f"EPIG path launches: expected {expected}, "
                                f"got {launches}")
    check(seen["lambda"][-1] != vlm.info["lambda_img"], "lambda_img did not move")
    check(selected2 == selected, "a second run selected other indices")
    del vlm
    return {"launches": launches, "ms_per_step": ms_step, "n_pool": n_pool}


def phase_probes_vs_plain(torch, attention, av) -> None:
    """Each probe kernel vs its plain version at the probes' shape and a
    ragged one, bf16 and fp32, and v2 and v3 in bf16 at T=1024 (Dh 64 and
    80, where the rounding of q * scale is real), each with the body its
    launch took (bf16 the tensor-core body, fp32 a CUDA-core one); v4's
    scores are bf16 in both dtypes: the bf16 tolerance for the max; the
    kernels of av.MEAN_TOL also within its mean (v4's, which #1's
    function, v4 without its rounding, must exceed); the group kernels
    (v5, v6) also equal to #1 in the same dtype bit for bit."""
    shapes = {"probe": (80, 257, 16, 64), "ragged": (BATCH, 50, 12, 64),
              "t1024": (4, 1024, 16, 64), "t1024 dh80": (4, 1024, 16, 80)}
    print("attention-schedule probe kernels (csrc/attention_variants.cu) vs plain:")
    for label, (B, T, H, Dh) in shapes.items():
        long = label.startswith("t1024")
        for dname in ("bf16",) if long else ("bf16", "fp32"):
            dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dname]
            gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
            q, k, v = (torch.randn(B, T, H * Dh, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            base = None if long else attention.fused_attention(q, k, v, H)
            for name, (fn, plain) in av.KERNELS.items():
                if long and name not in ("attention_v2", "attention_v3"):
                    continue
                out, ref = fn(q, k, v, H), plain(q, k, v, H)
                torch.cuda.synchronize()
                res = av.block_resources(name, B, T, H, Dh, dtype)
                check(res["body"] == ("mma" if dname == "bf16" else "simt"),
                      f"{name} {dname} took the {res['body']} body")
                print(f"  {name} {label} T={T} H={H} {dname}: body {res['body']} "
                      f"({res['smem_bytes']} B, {res['registers']} registers, "
                      f"{res['blocks_per_sm']} blocks/SM)")
                if av.VARIANTS[name] == av.GROUP:
                    same = torch.equal(out, base)
                    print(f"  {name} {label} {dname}: equal to #1 bit for bit: {same}")
                    check(same, f"{name} {label} {dname} differs from #1")
                tol = KERNEL_TOL["bf16" if name in av.BF16_SCORES else dname]
                err = (out.float() - ref.float()).abs()
                worst = float((err / (tol + tol * ref.float().abs())).max())
                where = f"{name} {label} B={B} T={T} H={H} Dh={Dh} {dname}"
                print(f"  {where}: max_abs_err={float(err.max()):.3e} (tol {tol:.3e} "
                      f"abs + rel, worst/bound={worst:.3f}) mean_abs_err="
                      f"{float(err.mean()):.3e}")
                check(worst <= 1.0, f"{where} disagrees with plain")
                if name not in av.MEAN_TOL:
                    continue
                mean_tol = av.MEAN_TOL[name]
                check(float(err.mean()) <= mean_tol, f"{where} strays from plain "
                      f"(mean tol {mean_tol:.0e})")
                if name not in av.BF16_SCORES:
                    continue
                # the same function without its rounding: #1's
                unrounded = (attention.fused_attention_reference(q, k, v, H).float()
                             - ref.float()).abs()
                print(f"  {where}: mean |d| kernel {float(err.mean()):.3e}, #1's "
                      f"function (no score rounding) {float(unrounded.mean()):.3e} "
                      f"max {float(unrounded.max()):.3e}; mean tol {mean_tol:.0e}")
                check(float(unrounded.mean()) > mean_tol,
                      f"{where}: the mean tolerance does not pin the score rounding")


def phase_packed_heads_vs_plain(torch, ph) -> dict:
    """qk and pv, per head and packed, vs plain: qk at 1e-4; pv within one
    bf16 ulp (ph.PV_TOL) and a mean |d| limit (ph.PV_MEAN_RTOL of the
    mean |plain|), which a single bf16 rounding of p must exceed. Prints
    each kernel's resources and, at the probe's shape, its CUDA-event time
    beside its device time a call by torch.profiler (the difference is the
    host's share of back-to-back calls); returns those device times."""
    print("packed-head probe kernels (csrc/packed_heads.cu) vs plain:")
    for name in ph.KERNELS:
        r = ph.kernel_resources(name)
        print(f"  {name} resources: {r['threads']} threads of {r['registers']} registers, "
              f"{r['smem_bytes']} B shared memory, {r['blocks_per_sm']} blocks/SM, "
              f"{r['local_bytes']} B local")
    parts = {}
    for label, (B, T, H) in PACKED_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
        q, k, v = (torch.randn(B, T, H * 64, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        p = torch.randn(B, H, T, T, generator=gen, device="cuda")
        operands = {"qk_scores": (q, k), "qk_scores_packed": (q, k), "pv": (p, v),
                    "pv_packed": (ph.pack_pairs(p).contiguous(), v)}
        for name, (fn, plain, _, _) in ph.KERNELS.items():
            x, y = operands[name]
            out, ref = fn(x, y, H), plain(x, y, H)
            torch.cuda.synchronize()
            where = f"{name} {label} B={B} T={T} H={H}"
            if name.startswith("qk"):
                err = (out - ref).abs()
                worst = float((err / (1e-4 + 1e-4 * ref.abs())).max())
                print(f"  {where}: max_abs_err={float(err.max()):.3e} (rtol = atol = "
                      f"1e-4, worst/bound={worst:.3f})")
                check(worst <= 1.0, f"{where} disagrees with plain")
                continue
            r = ph.pv_check(out, ref)
            # the same product from p rounded once to bf16
            rounded = plain(x.to(torch.bfloat16).float(), y, H)
            mean_rounded = float((rounded.float() - ref.float()).abs().mean())
            print(f"  {where}: max_abs_err={r['max_abs_err']:.3e} (tol {ph.PV_TOL:.3e} abs "
                  f"+ rel, worst/bound={r['worst']:.3f}); mean |d| kernel "
                  f"{r['mean_abs_err']:.3e}, one bf16 rounding of p {mean_rounded:.3e}; "
                  f"mean tol {r['mean_tol']:.3e}")
            check(mean_rounded > r["mean_tol"],
                  f"{where}: the mean tolerance does not pin the fp32 products")
        plans = {packed: ph.qk_plan(T, packed) for packed in (False, True)}
        print(f"  qk staging at T={T}: per head {plans[False]}, packed {plans[True]}")
        if label != "probe":
            continue
        for name, (fn, _, _, _) in ph.KERNELS.items():
            x, y = operands[name]
            ms = cuda_ms(torch, lambda: fn(x, y, H))
            parts[name] = _launch_parts(torch, lambda: fn(x, y, H), PACKED_PARTS, calls=20)
            _print_parts(f"{name} {label} (CUDA events {ms:.4f} ms a call back to back)",
                         parts[name])
    return parts


# the launches inside one s4-kind GEMM call (csrc/tile_gemm.cu)
GEMM_S4_PARTS = (("prepass (unpack_s4_kernel)", r"unpack_s4_kernel"),
                 ("s8 GEMM (wgmma_gemm_kernel)", r"wgmma_gemm_kernel"))


def phase_gemm_vs_plain(torch, tg) -> dict:
    """The GEMM kinds vs plain, bf16 and s8 at every tile of the sweep, s4
    x s4 and s8 x s4 at tile 0 after their prepass (which is held alone to
    the plain unpacking, `unpack_s4`, bit for bit): s8, s4 x s4 and s8 x s4
    exact, bf16 within tg.BF16_TOL of max |ref|. Returns each s4 kind's
    launches at the probes' shape timed apart by torch.profiler."""
    print("GEMM probe kernels (csrc/tile_gemm.cu) vs plain:")
    parts = {}
    for label, (Mr, Kr, Nr) in GEMM_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)

        def ints(lo, hi, *shape):
            return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                                 dtype=torch.int8)

        a8, b8 = ints(-127, 127, Mr, Kr), ints(-127, 127, Kr, Nr)
        a4, b4 = ints(-8, 8, Mr, Kr), ints(-8, 8, Kr, Nr)
        a16 = torch.randn(Mr, Kr, generator=gen, device="cuda").bfloat16()
        b16 = torch.randn(Kr, Nr, generator=gen, device="cuda").bfloat16()
        ref8, ref16 = tg.matmul_reference(a8, b8), tg.matmul_reference(a16, b16)
        where = f"{label} M={Mr} K={Kr} N={Nr}"
        for tile in tg.TILES:
            tg.check_exact(f"s8 {where} tile {tile}", tg.matmul(a8, b8, tile), ref8)
            r = tg.check_bf16(f"bf16 {where} tile {tile}", tg.matmul(a16, b16, tile),
                              ref16)
            print(f"  s8 and bf16 {where} tile {tile}: s8 exact, bf16 max_abs_err="
                  f"{r['max_abs_err']:.3e} (tol {tg.BF16_TOL} x {r['max_abs_ref']:.3e})")
        a4p, b4p = tg.pack_s4(a4, 1), tg.pack_s4(b4, 0)
        a_un, bt = tg.unpack_prepass(a4p, b4p)
        check(torch.equal(a_un, a4) and torch.equal(bt, b4.t()),
              f"the s4 prepass {where} differs from the plain unpacking")
        check(torch.equal(tg.unpack_prepass(None, b4p)[1], bt),
              f"the s4 prepass {where} without A differs")
        tg.check_exact(f"s4 x s4 {where}", tg.matmul_s4(a4p, b4p),
                       tg.matmul_reference(a4, b4))
        tg.check_exact(f"s8 x s4 {where}", tg.matmul_s4(a8, b4p),
                       tg.matmul_reference(a8, b4))
        print(f"  s4 x s4 and s8 x s4 {where}: prepass equal to the plain unpacking, "
              f"products exact ({tg.MMA[tg.S4]}; {tg.MMA[tg.S8S4]})")
        if label == "probe":
            for name, a in (("tile_gemm_s4", a4p), ("tile_gemm_s8s4", a8)):
                parts[name] = _launch_parts(torch, lambda a=a: tg.matmul_s4(a, b4p),
                                            GEMM_S4_PARTS, calls=20)
                _print_parts(f"{name} {where}", parts[name])
    return parts


def phase_probes(torch, counters) -> dict:
    """The probes' entry point: each probe's main logic (its module's run
    at the scripts' shape, then its report), every count set to 0 just
    before and read just after."""
    import importlib

    for c in counters.values():
        c.launches = 0
    results = {}
    for name in PROBES:
        mod = importlib.import_module(f"bayesvlm_tpu_torch.probes.{name}")
        print(f"probe {name}:")
        results[name] = mod.run(mod.parse_args([]))
        mod.report(results[name])
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"probes path launches={launches}")
    # probe_packed_heads times #1 and #3 as its yardsticks
    ran = ("attention", "attention_split", "attention_packed", *PROBE_KERNELS)
    check(all(launches[n] > 0 for n in ran), f"a probe kernel did not run: {launches}")
    check(all(launches[n] == 0 for n in launches if n not in ran),
          f"the probes launched another kernel: {launches}")
    return {"launches": launches, "results": results}


def _probe_entries(probe_path: dict, parts: dict) -> list:
    """Each probe kernel's line, from its probe's numbers; the GEMMs that
    the sweep also runs carry its tiles, the s4 kinds and the packed-head
    kernels their launches timed apart (`parts_ms`)."""
    results = probe_path["results"]
    swept = results["bench_int8_sweep"]["kernels"]
    entries = []
    for name, (probe, source, replaces) in PROBE_KERNELS.items():
        r = results[probe]["kernels"][name]
        e = _entry(name, f"bayesvlm_tpu_torch/csrc/{source}", f"scripts/dev/{replaces}",
                   probe_path["launches"][name], r, r["library_ms"])
        e.update((k, r[k]) for k in PROBE_EXTRAS if k in r)
        if name in swept:
            e.update(swept[name], also_replaces="scripts/dev/bench_int8_sweep.py:53")
        if name in parts:
            e["parts_ms"] = parts[name]
        entries.append(e)
    return entries


def _entry(name, source, replaces, launches, r, library_ms):
    """A kernel's entry of the kernels line: its times, error, bound and
    launches, and the body it launched (the attention kernel's from
    kernel_resources and the attention probes' from block_resources, with
    their shared memory, registers and blocks an SM; the other sources'
    from SOURCE_BODY)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches, **{k: r[k] for k in keys},
         "library_ms": library_ms,
         "body": r.get("body") or SOURCE_BODY[source.rsplit("/", 1)[-1]]}
    e.update((k, r[k]) for k in ("smem_bytes", "registers", "blocks_per_sm", "local_bytes")
             if k in r)
    return e


def main() -> int:
    import torch

    kind = phase_device(torch)
    from bayesvlm_tpu_torch import kernels
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
    from bayesvlm_tpu_torch.models import attention, linear_int8, mlp_int8
    from bayesvlm_tpu_torch.models.configs import (
        CONFIGS_BY_NAME,
        TINY_CLIP_CONFIG,
        TINY_SIGLIP_CONFIG,
    )
    from bayesvlm_tpu_torch.probes import attention_variants as av
    from bayesvlm_tpu_torch.probes import packed_heads as ph
    from bayesvlm_tpu_torch.probes import tile_gemm as tg
    from bayesvlm_tpu_torch.probforward import kernels as smith_head
    from bayesvlm_tpu_torch.select import epig_joint
    from bayesvlm_tpu_torch.utils import get_image_size

    phase_build(kernels, (attention, av, ph, tg, mlp_int8, linear_int8, epig_joint,
                          smith_head))
    attention._block_library()
    fa = attention.fused_attention
    counters = {"attention": fa,
                "attention_split": _Count(fa, "launches_split"),
                "attention_packed": _Count(fa, "launches_packed"),
                "attention_block": attention.fused_attention_block,
                "mlp_int8": mlp_int8.mlp_int8,
                "linear_int8": linear_int8.linear_int8,
                "smith_head": smith_head.fused_probit_probs,
                "attention_v2": av.attention_v2,
                "attention_v3": _Count(av.attention_v2, "launches_v3"),
                "attention_v4": av.attention_v4,
                "attention_group_heads": av.attention_group_heads,
                "attention_group_rows": av.attention_group_rows,
                "qk_scores": ph.qk_scores,
                "qk_scores_packed": _Count(ph.qk_scores, "launches_packed"),
                "pv": ph.pv,
                "pv_packed": _Count(ph.pv, "launches_packed"),
                "tile_gemm_bf16": tg.matmul,
                "tile_gemm_s8": _Count(tg.matmul, "launches_s8"),
                "tile_gemm_s4": tg.matmul_s4,
                "tile_gemm_s8s4": _Count(tg.matmul_s4, "launches_s8s4")}
    attn = phase_attention_vs_plain(torch, attention)
    pair_designs = phase_packed_pair_designs(torch, attention, av)
    sched_launches = phase_schedule_paths(torch, attention, counters)
    block = phase_block_vs_plain(torch, attention)
    int8 = phase_int8_vs_plain(torch, mlp_int8, linear_int8)
    smith = phase_smith_vs_plain(torch, smith_head)

    all_counters = {
        **counters,
        "xlogy_rowsum": _Count(epig_joint.joint_xlogy_rowsums, "launches"),
        "xlogy_rowsum_int8": _Count(epig_joint.joint_xlogy_rowsums, "launches_int8"),
    }
    epig = phase_epig_vs_plain(torch, epig_joint, all_counters)
    size = get_image_size(MODEL)
    prompts = [f"a photo of a thing of class {i}" for i in range(NUM_PROMPTS)]
    pixels = np.random.default_rng(SEED + 1).normal(
        size=(BATCH, size, size, 3)).astype(np.float32)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as big, \
            tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as zs, \
            tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tiny, \
            tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tiny_siglip:
        hdir = save_synthetic_hessians(big, CONFIGS_BY_NAME[MODEL], SEED)
        bf16_launches, bf16_img_s, bf16_embeds, bf16_probs = phase_main_path(
            torch, counters, hdir, pixels, prompts)
        int8_launches, _ = phase_int8_path(
            torch, counters, hdir, pixels, prompts, bf16_embeds, bf16_probs,
            bf16_img_s)
        block_launches, _ = phase_block_path(
            torch, counters, hdir, pixels, prompts, bf16_embeds, bf16_probs,
            bf16_img_s)
        epig_path = phase_epig_path(torch, all_counters, hdir)
        zs_path = phase_zeroshot(torch, all_counters, str(save_synthetic_hessians(
            zs, CONFIGS_BY_NAME[ZS_MODEL], SEED)))
        phase_tiny_reference(torch, attention, str(save_synthetic_hessians(
            tiny, TINY_CLIP_CONFIG, SEED)))
        phase_tiny_reference(torch, attention, str(save_synthetic_hessians(
            tiny_siglip, TINY_SIGLIP_CONFIG, SEED)), "tiny-siglip", ("default",))
    phase_probes_vs_plain(torch, attention, av)
    packed_parts = phase_packed_heads_vs_plain(torch, ph)
    gemm_parts = phase_gemm_vs_plain(torch, tg)
    probe_path = phase_probes(torch, all_counters)

    qkv, out_proj = int8["linear_int8 qkv"], int8["linear_int8 out_proj"]
    linear_entry = _entry(
        "linear_int8", "bayesvlm_tpu_torch/csrc/linear_int8.cu",
        "bayesvlm_tpu/models/linear_int8.py:53", int8_launches["linear_int8"],
        qkv, None)
    # the row above is the fused QKV shape; the out-projection's numbers
    linear_entry["out_proj"] = {k: out_proj[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "parts_ms")}
    linear_entry["parts_ms"] = qkv["parts_ms"]
    fused = int8["mlp_int8 fused-LN"]
    mlp_entry = _entry("mlp_int8", "bayesvlm_tpu_torch/csrc/mlp_int8.cu",
                       "bayesvlm_tpu/models/mlp_int8.py:101",
                       int8_launches["mlp_int8"], fused, None)
    mlp_entry["yardsticks"] = int8["mlp_int8 yardsticks"]
    mlp_entry.update(registers_gemm=fused["registers_gemm"], parts_ms=fused["parts_ms"])
    split, packed = attn[("vit-l/14", "bf16", "split_key")], attn[
        ("vit-l/14", "bf16", "packed_heads")]
    # #1's row is the main path's shape (ViT-L/14, bf16); its other bf16
    # shapes beside it
    one_block = _entry("fused_attention", "bayesvlm_tpu_torch/csrc/attention.cu",
                       "bayesvlm_tpu/models/attention_pallas.py:199",
                       bf16_launches["attention"], attn[("vit-l/14", "bf16")],
                       attn[("vit-l/14", "bf16")]["library_ms"])
    shape_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "body", "smem_bytes", "registers", "blocks_per_sm")
    one_block["shapes"] = {shape: {k: attn[(shape, "bf16")][k] for k in shape_keys}
                           for shape in ("siglip-l/16", "vit-b/32", "vit-l/14-336")}
    print(json.dumps({"kernels": [
        one_block,
        _entry("fused_attention_split", "bayesvlm_tpu_torch/csrc/attention.cu",
               "bayesvlm_tpu/models/attention_pallas.py:53",
               sched_launches["attention_split"], split, split["library_ms"]),
        # beside it: #1 in the same phase, and the in-turn design timed in
        # turns with the shipped one and #1
        dict(_entry("fused_attention_packed", "bayesvlm_tpu_torch/csrc/attention.cu",
                    "bayesvlm_tpu/models/attention_pallas.py:132",
                    sched_launches["attention_packed"], packed, packed["library_ms"]),
             base_ms=attn[("vit-l/14", "bf16")]["ms"], designs_ms=pair_designs,
             shapes={shape: {k: attn[(shape, "bf16", "packed_heads")][k]
                             for k in shape_keys}
                     for shape in ("vit-b/32", "vit-l/14-336", "t1024")}),
        dict(_entry("fused_attention_block", "bayesvlm_tpu_torch/csrc/attention_block.cu",
                    "bayesvlm_tpu/models/attention_pallas.py:225",
                    block_launches["attention_block"], block["bf16"], None),
             chain_ms=block["bf16"]["chain_ms"], core=block["bf16"]["core"],
             gemms=block["bf16"]["gemms"], parts_ms=block["bf16"]["parts_ms"],
             projections_ms=block["bf16"]["projections_ms"]),
        mlp_entry,
        linear_entry,
        dict(_entry("xlogy_rowsum", "bayesvlm_tpu_torch/csrc/xlogy_rowsum.cu",
                    "bayesvlm_tpu/select/epig_pallas.py:43",
                    epig_path["launches"]["xlogy_rowsum"], epig["bf16"], None),
             cublas_bf16_ms=epig["bf16"]["cublas_bf16_ms"],
             **{f"k{EPIG_LONG_K}": epig["bf16"][f"k{EPIG_LONG_K}"]}),
        dict(_entry("xlogy_rowsum_int8", "bayesvlm_tpu_torch/csrc/xlogy_rowsum.cu",
                    "bayesvlm_tpu/select/epig_pallas.py:77", epig["int8"]["launches"],
                    epig["int8"], None),
             **{f"k{EPIG_LONG_K}": epig["int8"][f"k{EPIG_LONG_K}"]}),
        # the row is the zero-shot run's shape (B=2048, C=100, D=1024); the
        # other shapes beside it
        dict(_entry("smith_head", "bayesvlm_tpu_torch/csrc/smith_head.cu",
                    "bayesvlm_tpu/probforward/kernels/smith_pallas.py:40",
                    zs_path["launches"]["smith_head"], zs_path["head"], None),
             cli_chain_ms=zs_path["head"]["cli_chain_ms"],
             sigma_ms=zs_path["head"]["sigma_ms"],
             fp32_bound_ms=zs_path["head"]["fp32_bound_ms"],
             shapes={label: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "fp32_bound_ms",
                                               "registers", "smem_bytes", "local_bytes",
                                               "cluster")}
                     for label, r in smith.items()}),
        *_probe_entries(probe_path, {**gemm_parts, **packed_parts}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
