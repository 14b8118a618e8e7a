"""Real-weights preflight, the counterpart of the JAX package's
`scripts/preflight.py:1-209`: the one command to run when HF weights and
datasets become available. Its steps:

  1. convert  (optional) the port reads an HF snapshot directly
              (models/convert.py), so the snapshot goes through
              `convert_weights` only when `--out` or `--force_convert`
              asks (skipped when the converted files are already there);
              the run then reads the converted files
  2. parity   the port's fp32 towers against the `transformers` model of
              the same snapshot (its get_image_features /
              get_text_features, `_hf_features`; on the CPU) on random
              inputs; fails hard above tolerance. Without `transformers`
              the step is skipped with a message and the summary records
              why
  3. zeroshot the Stage-2 probabilistic pipeline (`zeroshot.run`) on the
              dataset with the given Hessians: prints ACC / NLPD / ECE

    python -m bayesvlm_tpu_torch.preflight --model clip-base \\
        --snapshot /weights/hf/CLIP-ViT-B-32-laion2B-s34B-b79K \\
        --hessian_dir hessians/hessian_CLIP-ViT-B-32-laion2B-s34B-b79K \\
        --dataset cifar100 --data_base_dir /data

The last line printed is `[preflight] {json summary}`. Runs on the card
unless `--device` names another.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

PARITY_RTOL = 2e-3
PARITY_ATOL = 2e-4  # fp32 tower tolerances (the JAX script's)
PARITY_SKIPPED = "skipped: transformers not installed"


def step_convert(model_str: str, snapshot: str, out_dir: Path,
                 force: bool = False) -> Path:
    from bayesvlm_tpu_torch import convert_weights

    # head.json is written last (renamed into place), so its presence
    # proves the whole set landed
    complete = all((out_dir / f).exists() for f in ("vision.pt", "text.pt", "head.json"))
    if complete and not force:
        print(f"[convert] cache exists at {out_dir}, skipping (use --force_convert "
              "to redo)")
        return out_dir
    print(f"[convert] {snapshot} -> {out_dir}")
    convert_weights.main(model_str, snapshot, str(out_dir))
    return out_dir


def step_parity(model_str: str, snapshot: str, weights_dir, n_images: int = 4,
                n_texts: int = 4, seed: int = 0, device: str = "cpu") -> dict:
    """The port's fp32 towers (from `weights_dir`) against the HF model of
    the snapshot, on the JAX script's random inputs; returns
    {'image_max_rel', 'text_max_rel'} and raises SystemExit above
    PARITY_RTOL.

    The step checks the conversion (the JAX script forces "highest"
    matmul precision for that reason), so both models run in fp32 on the
    CPU by default. The tolerance is elementwise and was set on tiny
    towers: at clip-large width, random seeded weights, the port's towers
    on an NVIDIA H100 80GB HBM3 (700 W) differ from HF's on the CPU by
    1.5e-6 of the largest feature (fp32 summation order), which
    near-zero features turn into 2.5e-3 / 2.6e-3 (image / text) of the
    ratio, past 2e-3; with both on the CPU, 3.5e-4 / 1.8e-3 (PERF.md,
    section 6)."""
    import transformers

    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.encoders import load_model

    config = CONFIGS_BY_NAME[model_str]
    cls = {"clip": transformers.CLIPModel,
           "siglip": transformers.SiglipModel}[config.family]
    # fp32 whatever the snapshot stores (later transformers load a fp16
    # snapshot in fp16 by default)
    hf, info = cls.from_pretrained(snapshot, dtype=torch.float32, output_loading_info=True)
    hf.eval()
    print(f"[parity] HF {cls.__name__} from {snapshot}: "
          + ", ".join(f"{len(v)} {k}" for k, v in info.items()))
    img_enc, txt_enc, _ = load_model(model_str, weights_dir=str(weights_dir),
                                     dtype=torch.float32, device=torch.device(device))

    rng = np.random.default_rng(seed)
    size = config.vision.image_size
    pixels = rng.normal(size=(n_images, 3, size, size)).astype(np.float32)
    tcfg = config.text
    ids = rng.integers(2, max(3, tcfg.vocab_size - 2),
                       size=(n_texts, tcfg.max_length)).astype(np.int64)
    if config.family == "clip":
        # CLIP pools at the EOS position; give each row one
        ids[:, 0] = 0
        for r in range(n_texts):
            ids[r, 1 + r % (tcfg.max_length - 1)] = tcfg.eos_token_id

    with torch.no_grad():
        hf_img, hf_txt = (t.numpy() for t in _hf_features(
            hf, config.family, torch.tensor(pixels), torch.tensor(ids)))
    ours_img = img_enc(pixels).embeds.cpu().numpy()
    ours_txt = txt_enc(ids).embeds.cpu().numpy()

    def max_rel(a, b):
        return float(np.max(np.abs(a - b) / (np.abs(b) + PARITY_ATOL)))

    res = {"image_max_rel": max_rel(ours_img, hf_img),
           "text_max_rel": max_rel(ours_txt, hf_txt)}
    for k, v in res.items():
        status = "OK" if v <= PARITY_RTOL else "FAIL"
        print(f"[parity] {k}: {v:.2e} ({status}, tol {PARITY_RTOL:.0e})")
    if max(res.values()) > PARITY_RTOL:
        raise SystemExit(
            f"[parity] FAILED: the port's towers diverge from the HF snapshot beyond "
            f"rtol={PARITY_RTOL}; do not trust downstream numbers. {res}")
    return res


def _hf_features(hf, family: str, pixels: torch.Tensor, ids: torch.Tensor):
    """The HF model's image and text features: what `get_image_features` /
    `get_text_features` compute in transformers 4 (the towers' pooled
    outputs, then CLIP's projections; SigLIP's pooled outputs carry their
    heads), spelled out because later releases return those methods'
    results in another type."""
    img = hf.vision_model(pixel_values=pixels).pooler_output
    txt = hf.text_model(input_ids=ids).pooler_output
    if family == "clip":
        img, txt = hf.visual_projection(img), hf.text_projection(txt)
    return img, txt


def _has_transformers() -> bool:
    try:
        import transformers  # noqa: F401
    except ImportError:
        return False
    return True


def main(model_str: str, snapshot: str, hessian_dir: str, dataset: str = "cifar100",
         data_base_dir=None, out=None, tokenizer_dir=None, dtype: str = "bf16",
         batch_size: int = 32, num_workers: int = 4, pseudo_data_count: int = 10,
         skip_parity: bool = False, force_convert: bool = False, use_mesh: bool = True,
         device: str = "cuda", dataset_overrides: Optional[dict] = None) -> dict:
    """The three steps; returns the summary it prints last.
    `dataset_overrides` go to the datamodule (zeroshot.run)."""
    from bayesvlm_tpu_torch import zeroshot

    if data_base_dir is not None:
        import os

        os.environ["DATA_BASE_DIR"] = str(data_base_dir)

    weights_dir = snapshot
    if out is not None or force_convert:
        weights_dir = step_convert(model_str, snapshot,
                                   Path(out) if out else Path("weights") / model_str,
                                   force=force_convert)
    else:
        print("[convert] skipped: the port reads the snapshot directly (--out or "
              "--force_convert converts it)")

    parity = None
    if skip_parity:
        print("[parity] skipped (--skip_parity)")
    elif not _has_transformers():
        print(f"[parity] {PARITY_SKIPPED}: the HF reference model cannot be built "
              "here; the towers are not checked against it")
        parity = PARITY_SKIPPED
    else:
        parity = step_parity(model_str, snapshot, weights_dir)

    if tokenizer_dir is None and (Path(snapshot) / "tokenizer_config.json").exists():
        tokenizer_dir = snapshot
        print("[zeroshot] using tokenizer files from the snapshot")

    acc, nlpd, ece = zeroshot.main(
        dataset=dataset, hessian_dir=hessian_dir, model_str=model_str,
        pseudo_data_count=pseudo_data_count, batch_size=batch_size,
        num_workers=num_workers, weights_dir=str(weights_dir),
        tokenizer_dir=tokenizer_dir, dtype=dtype, use_mesh=use_mesh, device=device,
        dataset_overrides=dataset_overrides)
    summary = {
        "model": model_str, "dataset": dataset,
        "acc": acc, "nlpd": nlpd, "ece": ece,
        "lambda_img": zeroshot.main.last_info["lambda_img"],
        "lambda_txt": zeroshot.main.last_info["lambda_txt"],
        "parity": parity,
    }
    print("[preflight] " + json.dumps(summary))
    return summary


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True)
    parser.add_argument("--snapshot", required=True,
                        help="local HF snapshot dir (config.json + weights)")
    parser.add_argument("--hessian_dir", required=True)
    parser.add_argument("--dataset", default="cifar100")
    parser.add_argument("--data_base_dir", default=None)
    parser.add_argument("--out", default=None,
                        help="convert the snapshot into this directory first "
                             "(default with --force_convert: weights/<model>)")
    parser.add_argument("--tokenizer_dir", default=None)
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--pseudo_data_count", type=int, default=10)
    parser.add_argument("--skip_parity", action="store_true")
    parser.add_argument("--force_convert", action="store_true")
    parser.add_argument("--no_mesh", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs without a card")
    return parser


if __name__ == "__main__":
    args = _parser().parse_args()
    main(model_str=args.model, snapshot=args.snapshot, hessian_dir=args.hessian_dir,
         dataset=args.dataset, data_base_dir=args.data_base_dir, out=args.out,
         tokenizer_dir=args.tokenizer_dir, dtype=args.dtype, batch_size=args.batch_size,
         num_workers=args.num_workers, pseudo_data_count=args.pseudo_data_count,
         skip_parity=args.skip_parity, force_convert=args.force_convert,
         use_mesh=not args.no_mesh, device=args.device)
