"""Hessian artifact directory format, compatible with the reference and
with `bayesvlm_tpu.io.artifacts`.

Directory layout (ref:bayesvlm/hessians.py:137-167,203-217):

    <la_dir>/A_{img,txt}_analytic.pt     raw K-FAC A factors (already / sqrt(n))
    <la_dir>/B_{img,txt}_analytic.pt     raw K-FAC B factors
    <la_dir>/prior_precision_analytic.json
        {"lambda_img": ..., "n_img": ..., "lambda_txt": ..., "n_txt": ...}

The `.pt` files are plain tensors in torch's zip format, which both the
reference's `torch.save` and the JAX package's writer (with or without
torch installed) produce.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Literal, Union

import numpy as np
import torch

PathLike = Union[str, Path]


def load_hessians(la_dir: PathLike, tag: Literal["img", "txt"]):
    """Raw fp32 A, B factors for one direction, on the CPU
    (ref:bayesvlm/hessians.py:203-217)."""
    la_dir = Path(la_dir)
    return tuple(
        torch.load(la_dir / f"{name}_{tag}_analytic.pt", map_location="cpu",
                   weights_only=True).to(torch.float32)
        for name in ("A", "B"))


def save_hessians(la_dir: PathLike, A, B, tag: Literal["img", "txt"]) -> None:
    la_dir = Path(la_dir)
    la_dir.mkdir(parents=True, exist_ok=True)
    for name, F in (("A", A), ("B", B)):
        F = torch.as_tensor(F).detach().to("cpu", torch.float32).contiguous()
        torch.save(F, la_dir / f"{name}_{tag}_analytic.pt")


def save_prior_precision(la_dir: PathLike, lambda_img: float, n_img: float,
                         lambda_txt: float, n_txt: float) -> None:
    """ref:scripts/hessian_estimation.py:259-266 (same key order)."""
    la_dir = Path(la_dir)
    la_dir.mkdir(parents=True, exist_ok=True)
    result = {
        "lambda_img": float(lambda_img),
        "n_img": float(n_img),
        "lambda_txt": float(lambda_txt),
        "n_txt": float(n_txt),
    }
    with open(la_dir / "prior_precision_analytic.json", "w") as f:
        json.dump(result, f, indent=4)


def save_synthetic_hessians(la_dir: PathLike, config, seed: int = 0) -> Path:
    """Random SPD K-FAC factors at a model's full dims (the recipe of the
    JAX package's bench.py `_synthetic_hessian_dir`), drawn from `seed`,
    with a prior-precision file: a Hessian directory for benchmarks and
    smoke runs of models that have none."""
    rng = np.random.default_rng(seed)

    def spd(dim, scale):
        M = rng.normal(size=(dim, dim)).astype(np.float32)
        return (M @ M.T / dim + np.eye(dim, dtype=np.float32)) * scale

    D = config.vision.projection_dim
    save_hessians(la_dir, spd(config.vision.hidden_size, 40.0), spd(D, 25.0), "img")
    save_hessians(la_dir, spd(config.text.hidden_size, 35.0), spd(D, 15.0), "txt")
    save_prior_precision(la_dir, 300.0, 1.0, 300.0, 1.0)
    return Path(la_dir)
