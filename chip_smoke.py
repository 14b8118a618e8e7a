#!/usr/bin/env python3
"""Drive the PyTorch port's Stage-2 main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, without the result line):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles the attention kernel (csrc/attention.cu, nvcc,
     sm_90a) from this checkout;
  3. kernel vs plain: the kernel against its plain PyTorch version at the
     ViT-L/14 shape (B=64, T=257, H=16, Dh=64) and the ViT-B/32 shape
     (T=50, H=12), in bf16 and fp32, with errors and CUDA-event times;
  4. main path: ProbabilisticVLM.from_pretrained("clip-large", bf16,
     seeded random towers, synthetic full-dimension K-FAC factors) ->
     set_class_prompts(100 prompts) -> predict on [64, 224, 224, 3]
     pixels; checks shape, finiteness, row sums, 24 kernel launches per
     image-tower forward, agreement with an fp32 predict of the same
     weights, and tiny-clip on the card against tiny-clip on the CPU;
  5. prints the kernels line, then the result line
     {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
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
# tiny-clip fp32 on the card vs on the CPU: fp32 summation order only
TINY_TOL = 1e-4


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


def phase_device(torch) -> str:
    check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    # cuDNN runs fp32 convolutions in TF32 by default; fp32 matmuls stay
    # full fp32 (the default, left as it is)
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0)


def phase_build(attention) -> None:
    t0 = time.perf_counter()
    lib = attention.build_kernel()
    attention._library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")


def phase_kernel_vs_plain(torch, attention) -> dict:
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    shapes = {"vit-l/14": (BATCH, 257, 16, 64), "vit-b/32": (BATCH, 50, 12, 64)}
    results = {}
    for shape_name, (B, T, H, Dh) in shapes.items():
        for dname, dtype in dtypes.items():
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            q, k, v = (torch.randn(B, T, H * Dh, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            out = attention.fused_attention(q, k, v, H)
            ref = attention.fused_attention_reference(q, k, v, H)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            tol = KERNEL_TOL[dname]
            bound = tol + tol * ref.float().abs()
            worst = float((err / bound).max())
            ms = cuda_ms(torch, lambda: attention.fused_attention(q, k, v, H))
            plain_ms = cuda_ms(
                torch, lambda: attention.fused_attention_reference(q, k, v, H))
            max_err = float(err.max())
            print(f"kernel vs plain {shape_name} {dname} B={B} T={T} H={H} "
                  f"Dh={Dh}: max_abs_err={max_err:.3e} (tol {tol:.3e} abs + "
                  f"rel, worst/bound={worst:.3f}) kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}")
            check(worst <= 1.0, f"{shape_name} {dname} kernel disagrees "
                                f"with plain (max_abs_err {max_err})")
            results[(shape_name, dname)] = dict(max_abs_err=max_err, ms=ms,
                                                plain_ms=plain_ms)
    return results


def _synthetic_hessian_dir(root: str, config) -> str:
    """Random SPD K-FAC factors at the model's full dims (the recipe of
    bench.py's _synthetic_hessian_dir), written from a seed."""
    from bayesvlm_tpu_torch.io.artifacts import save_hessians, save_prior_precision

    rng = np.random.default_rng(SEED)

    def spd(dim, scale):
        M = rng.normal(size=(dim, dim)).astype(np.float32)
        return (M @ M.T / dim + np.eye(dim, dtype=np.float32)) * scale

    D = config.vision.projection_dim
    save_hessians(root, spd(config.vision.hidden_size, 40.0), spd(D, 25.0), "img")
    save_hessians(root, spd(config.text.hidden_size, 35.0), spd(D, 15.0), "txt")
    save_prior_precision(root, 300.0, 1.0, 300.0, 1.0)
    return root


def phase_main_path(torch, attention, hessian_dir: str) -> int:
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
    from bayesvlm_tpu_torch.utils import get_image_size

    vcfg = CONFIGS_BY_NAME[MODEL].vision
    size = get_image_size(MODEL)
    prompts = [f"a photo of a thing of class {i}" for i in range(NUM_PROMPTS)]
    pixels = np.random.default_rng(SEED + 1).normal(
        size=(BATCH, size, size, 3)).astype(np.float32)

    attention.fused_attention.launches = 0
    t0 = time.perf_counter()
    vlm = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="bf16",
                                           device="cuda", seed=SEED)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    vlm.set_class_prompts(prompts)
    check(attention.fused_attention.launches == 0,
          "the causal text tower must not reach the attention kernel")

    times, probs = [], None
    for _ in range(PREDICT_CALLS + 1):
        before = attention.fused_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = vlm.predict(pixels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(attention.fused_attention.launches - before == vcfg.num_layers,
              f"expected {vcfg.num_layers} kernel launches per image-tower "
              f"forward, got {attention.fused_attention.launches - before}")
    launches = attention.fused_attention.launches

    check(tuple(probs.shape) == (BATCH, NUM_PROMPTS), f"shape {tuple(probs.shape)}")
    check(bool(torch.isfinite(probs).all()), "non-finite probabilities")
    row_err = float((probs.sum(-1) - 1.0).abs().max())
    check(row_err <= 1e-5, f"rows sum to 1 within {row_err:.2e}")
    steady = times[1:]  # the first call pays cuBLAS/cuDNN warm-up
    img_s = BATCH * len(steady) / sum(steady)
    print(f"main path: lambda_img={vlm.info['lambda_img']!r} "
          f"lambda_txt={vlm.info['lambda_txt']!r} from_pretrained_s={t_load:.2f} "
          f"predict_first_s={times[0]:.3f} predict_img_s_B{BATCH}={img_s:.1f} "
          f"launches={launches} row_sum_err={row_err:.2e}")

    vlm32 = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="fp32",
                                             device="cuda", seed=SEED)
    vlm32.set_class_prompts(prompts)
    probs32 = vlm32.predict(pixels)
    logp_diff = float((probs.float().log() - probs32.log()).abs().max())
    top1 = float((probs.argmax(-1) == probs32.argmax(-1)).float().mean())
    cos = float(torch.nn.functional.cosine_similarity(
        vlm.encode_images(pixels).embeds, vlm32.encode_images(pixels).embeds,
        dim=-1).min())
    print(f"bf16 vs fp32 predict: max_abs_logp_diff={logp_diff:.3e} "
          f"(tol {BF16_LOGP_ATOL}) max_abs_prob_diff="
          f"{float((probs.float() - probs32).abs().max()):.3e} "
          f"min_embed_cos={cos:.6f} (min {BF16_EMBED_COS_MIN}) "
          f"top1_agreement={top1:.3f} max_prob_fp32={float(probs32.max()):.4f} "
          f"lambda_img_fp32={vlm32.info['lambda_img']!r}")
    check(logp_diff <= BF16_LOGP_ATOL, "bf16 log-probs stray from fp32")
    check(cos >= BF16_EMBED_COS_MIN, "bf16 image embeddings stray from fp32")
    del vlm, vlm32
    return launches


def phase_tiny_reference(torch, hessian_dir: str) -> None:
    """tiny-clip fp32 through the kernel on the card vs the plain path on
    the CPU, with the same weights and Hessian factors."""
    from pathlib import Path

    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    cpu = ProbabilisticVLM.from_pretrained("tiny-clip", hessian_dir,
                                           dtype="fp32", device="cpu",
                                           prior_num_steps=50)
    wd = Path(hessian_dir)
    torch.save(cpu.image_encoder.module.state_dict(), wd / "vision.pt")
    torch.save(cpu.text_encoder.module.state_dict(), wd / "text.pt")
    gpu = ProbabilisticVLM.from_pretrained("tiny-clip", hessian_dir,
                                           weights_dir=hessian_dir,
                                           dtype="fp32", device="cuda",
                                           prior_num_steps=50)
    prompts = ["a cat", "a dog", "a bird"]
    pixels = np.random.default_rng(SEED + 2).normal(
        size=(8, 32, 32, 3)).astype(np.float32)
    ref = cpu.set_class_prompts(prompts).predict(pixels)
    out = gpu.set_class_prompts(prompts).predict(pixels).cpu()
    diff = float((out - ref).abs().max())
    print(f"tiny-clip card vs CPU (fp32): max_abs_diff={diff:.3e} (tol {TINY_TOL})")
    check(diff <= TINY_TOL, "tiny-clip on the card disagrees with the CPU")


def main() -> int:
    import torch

    kind = phase_device(torch)
    from bayesvlm_tpu_torch.models import attention
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME, TINY_CLIP_CONFIG

    phase_build(attention)
    kernel = phase_kernel_vs_plain(torch, attention)
    attention.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=attention.BUILD_DIR) as big, \
            tempfile.TemporaryDirectory(dir=attention.BUILD_DIR) as tiny:
        launches = phase_main_path(
            torch, attention,
            _synthetic_hessian_dir(big, CONFIGS_BY_NAME[MODEL]))
        phase_tiny_reference(torch, _synthetic_hessian_dir(tiny, TINY_CLIP_CONFIG))

    main_shape = kernel[("vit-l/14", "bf16")]
    print(json.dumps({"kernels": [{
        "name": "fused_attention",
        "route": "cuda",
        "source": "bayesvlm_tpu_torch/csrc/attention.cu",
        "replaces": "bayesvlm_tpu/models/attention_pallas.py:199",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
