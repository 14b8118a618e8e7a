"""Convert a local HF checkpoint snapshot into the port's weight files, the
counterpart of the JAX package's `scripts/convert_weights.py`.

    python -m bayesvlm_tpu_torch.convert_weights --model clip-large \\
        --snapshot /path/to/hf/snapshot --out weights/clip-large

Writes `vision.pt` and `text.pt` (the towers' fp32 state dicts) and
`head.json` (the snapshot's logit scale and bias), the layout
`models/encoders.load_model(weights_dir=...)` reads first. Each file is
written under a temporary name and renamed into place, so an interrupted
run never leaves a truncated file that a later load half-reads.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch


def _replace_into(out_dir: Path, name: str, write) -> Path:
    tmp, final = out_dir / f".{name}.tmp", out_dir / name
    write(tmp)
    os.replace(tmp, final)
    return final


def main(model_str: str, snapshot: str, out: str) -> Path:
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.convert import (
        CONVERTERS,
        _load_state_dict,
        load_logit_scale_bias,
    )

    config = CONFIGS_BY_NAME[model_str]
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    sd = _load_state_dict(Path(snapshot))
    for tower in ("vision", "text"):
        # clone: a slice (SigLIP's q/k/v) would save its whole storage
        params = {k: v.clone() for k, v in CONVERTERS[(config.family, tower)](
            sd, getattr(config, tower).num_layers).items()}
        path = _replace_into(out_dir, f"{tower}.pt", lambda p: torch.save(params, p))
        n = sum(v.numel() for v in params.values())
        print(f"{tower}: {n / 1e6:.1f}M params -> {path}")
    scale, bias = load_logit_scale_bias(sd)
    _replace_into(out_dir, "head.json", lambda p: p.write_text(
        json.dumps({"logit_scale": scale, "logit_bias": bias})))
    print(f"head: scale={scale} bias={bias}")
    return out_dir


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", required=True)
    parser.add_argument("--snapshot", required=True)
    parser.add_argument("--out", required=True)
    return parser


if __name__ == "__main__":
    args = _parser().parse_args()
    main(args.model, args.snapshot, args.out)
