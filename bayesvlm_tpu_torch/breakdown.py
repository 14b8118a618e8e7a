"""Where a `predict` call's device time goes, by kernel group, on one GPU.

    python -m bayesvlm_tpu_torch.breakdown

For each lane (bf16; the int8 lane: mlp_int8 + attn_int8; the block
lane: the vision tower rebuilt with attn_pallas_block=True on the same
weights), builds clip-large in bf16 (random towers from seed 0,
synthetic full-dimension K-FAC factors), encodes 100 class prompts,
warms up with two `predict`
calls on [64, 224, 224, 3] numpy pixels, then profiles three more with
torch.profiler. Prints, per lane: the wall ms per call (host clock
around synchronised calls), the device's busy ms per call (the sum of
its kernel and copy rows) and idle share, per kernel group its device
ms per call, launches per call and share of busy time, then the ten
kernels with the most device time. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MODEL = "clip-large"
BATCH = 64
CALLS = 3
TOP = 10
# lane -> (from_pretrained keywords, VisionConfig fields of a rebuilt tower)
LANES = {"bf16": ({}, {}), "int8": ({"mlp_int8": True, "attn_int8": True}, {}),
         "block": ({}, {"attn_pallas_block": True})}
# kernel name -> group; the first pattern that matches wins
GROUPS = (
    ("attention kernel (mha_mma_kernel, mha_kernel)", r"mha_mma_kernel|mha_kernel"),
    # the block lane's projections: the wgmma body with its bias epilogue
    # (ahead of the GEMM probes' row, which takes any other instantiation)
    ("block GEMMs (wgmma_gemm_kernel, EpiBias)", r"wgmma_gemm_kernel<.*EpiBias"),
    ("block LayerNorm (ln_rows_kernel)", r"ln_rows_kernel"),
    # the int8 lane's products: the wgmma body with its dequantising
    # epilogue (its raw-accumulator instantiation is the GEMM probes')
    ("int8 GEMMs (wgmma_gemm_kernel, EpiDequant)", r"wgmma_gemm_kernel<.*EpiDequant"),
    ("int8 quantize (quant_rows_kernel, act_quant_rows_kernel)", r"quant_rows_kernel"),
    ("GEMM probes (wgmma_gemm_kernel, EpiRaw)", r"wgmma_gemm_kernel"),
    ("GEMMs (cuBLAS)", r"nvjet|gemm|xmma|cutlass|cublas"),
    ("H2D copy", r"Memcpy HtoD"),
    ("LayerNorm", r"layer_norm|LayerNorm"),
    ("GELU", r"[Gg]elu"),
    ("dtype copies", r"copy"),
    ("elementwise (adds, muls)", r"elementwise"),
)


def _group(name: str) -> str:
    for label, pattern in GROUPS:
        if re.search(pattern, name):
            return label
    return "rest"


def _device_rows(prof):
    """(name, count, device us) of every kernel / copy row."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, e.count, us))
    return rows


def profile_lane(lane: str, hessian_dir, pixels, prompts) -> None:
    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    keywords, vision = LANES[lane]
    vlm = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="bf16",
                                           device="cuda", seed=0, mesh=None, **keywords)
    if vision:
        vlm.image_encoder = rebuild_image_encoder(vlm.image_encoder, **vision)
    vlm.set_class_prompts(prompts)
    for _ in range(2):
        vlm.predict(pixels)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            vlm.predict(pixels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    rows = _device_rows(prof)
    groups: dict = {}
    for name, count, us in rows:
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += us / 1e3 / CALLS
        g[1] += count / CALLS
    busy = sum(ms for ms, _ in groups.values())
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    B = len(pixels)
    print(f"{lane} lane, B={B}: wall_ms_per_call={wall_ms:.3f} "
          f"busy_ms_per_call={busy:.3f} idle_share={1 - busy / wall_ms:.4f} "
          f"img_s_profiled={B / wall_ms * 1e3:.1f}")
    for label, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {label}: {ms:.3f} ms/call, {n:.0f} launches/call, "
              f"{ms / busy:.1%} of busy")
    for name, count, us in sorted(rows, key=lambda r: -r[2])[:TOP]:
        print(f"  top: {us / 1e3 / CALLS:.3f} ms/call, {count / CALLS:.0f} "
              f"launches/call: {name[:110]}")
    del vlm


def main() -> int:
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.utils import get_image_size

    if not torch.cuda.is_available():
        print("no CUDA device: the breakdown is measured on the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    size = get_image_size(MODEL)
    prompts = [f"a photo of a thing of class {i}" for i in range(100)]
    pixels = np.random.default_rng(1).normal(
        size=(BATCH, size, size, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as hdir:
        save_synthetic_hessians(hdir, CONFIGS_BY_NAME[MODEL], seed=0)
        for lane in LANES:
            profile_lane(lane, hdir, pixels, prompts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
