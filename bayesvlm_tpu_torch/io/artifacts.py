"""Hessian artifact directory format, compatible with the reference and
with `bayesvlm_tpu.io.artifacts`.

Directory layout (ref:bayesvlm/hessians.py:137-167,203-217):

    <la_dir>/A_{img,txt}_analytic.pt     raw K-FAC A factors (already / sqrt(n))
    <la_dir>/B_{img,txt}_analytic.pt     raw K-FAC B factors
    <la_dir>/prior_precision_analytic.json
        {"lambda_img": ..., "n_img": ..., "lambda_txt": ..., "n_txt": ...}

The `.pt` files are plain tensors in torch's zip format, which both the
reference's `torch.save` and the JAX package's writer (with or without
torch installed) produce. The port's second lane is a
torch.distributed.checkpoint under `<la_dir>/factors_dcp` (io/dcp_ckpt.py),
which `load_hessians` reads when the `.pt` files are absent, as the JAX
package falls back to its orbax lane. That orbax checkpoint,
`<la_dir>/factors_orbax`, is not read here.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Literal, Union

import numpy as np
import torch

from bayesvlm_tpu_torch.bayes.kfac import compute_covariances

PathLike = Union[str, Path]


@dataclass
class HessianArtifacts:
    A_img: torch.Tensor
    B_img: torch.Tensor
    A_txt: torch.Tensor
    B_txt: torch.Tensor
    info: dict


def load_info(la_dir: PathLike) -> dict:
    with open(Path(la_dir) / "prior_precision_analytic.json") as f:
        return json.load(f)


def load_hessians(la_dir: PathLike, tag: Literal["img", "txt"],
                  return_info: bool = False):
    """Raw fp32 A, B factors for one direction, on the CPU, and with
    `return_info` the prior-precision info too
    (ref:bayesvlm/hessians.py:203-217). Without the `.pt` files, read from
    the DCP lane `<la_dir>/factors_dcp` (JAX `io/artifacts.py:47-57`)."""
    la_dir = Path(la_dir)
    paths = [la_dir / f"{name}_{tag}_analytic.pt" for name in ("A", "B")]
    if not all(p.exists() for p in paths):
        if (la_dir / "factors_dcp").exists():
            from bayesvlm_tpu_torch.io.dcp_ckpt import load_hessians_dcp

            A, B = (F.to(torch.float32) for F in load_hessians_dcp(la_dir, tag))
            return (A, B, load_info(la_dir)) if return_info else (A, B)
        if (la_dir / "factors_orbax").exists():
            raise FileNotFoundError(
                f"{la_dir} holds the factors only as the JAX package's orbax "
                f"checkpoint (factors_orbax/), which the port cannot read; write "
                f"the .pt files with the JAX package's scripts/convert_artifacts.py "
                f"--to pt, then `python -m bayesvlm_tpu_torch.convert_artifacts "
                f"--to orbax` gives the port's factors_dcp/")
    A, B = (torch.load(p, map_location="cpu", weights_only=True).to(torch.float32)
            for p in paths)
    if return_info:
        return A, B, load_info(la_dir)
    return A, B


def load_covariances(la_dir: PathLike, return_info: bool = False):
    """All four factors, regularized with the stored (n, lambda) and
    inverted, on the CPU (ref:bayesvlm/hessians.py:137-167)."""
    A_img, B_img = load_hessians(la_dir, "img")
    A_txt, B_txt = load_hessians(la_dir, "txt")
    info = load_info(la_dir)
    cov_img, cov_txt = compute_covariances(A_img, B_img, A_txt, B_txt, info)
    if return_info:
        return cov_img, cov_txt, info
    return cov_img, cov_txt


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


def kfac_dims(config) -> dict:
    """tag -> (A dim, B dim) of a model's K-FAC factors: A is the
    projection's input (CLIP: the hidden size; SigLIP: head_fc2's mlp_dim
    activations and the text hidden size) plus the ones column of a
    biased projection (SigLIP), B the projection dim."""
    bias = int(config.projection_has_bias)
    a_img = config.vision.mlp_dim if config.family == "siglip" else config.vision.hidden_size
    D = config.vision.projection_dim
    return {"img": (a_img + bias, D), "txt": (config.text.hidden_size + bias, D)}


def save_synthetic_hessians(la_dir: PathLike, config, seed: int = 0) -> Path:
    """Random SPD K-FAC factors at a model's full dims (the recipe of the
    JAX package's bench.py `_synthetic_hessian_dir`), drawn from `seed`,
    with a prior-precision file: a Hessian directory for benchmarks and
    smoke runs of models that have none, at `kfac_dims(config)`."""
    rng = np.random.default_rng(seed)

    def spd(dim, scale):
        M = rng.normal(size=(dim, dim)).astype(np.float32)
        return (M @ M.T / dim + np.eye(dim, dtype=np.float32)) * scale

    dims = kfac_dims(config)
    for tag, a_scale, b_scale in (("img", 40.0, 25.0), ("txt", 35.0, 15.0)):
        a_dim, b_dim = dims[tag]
        save_hessians(la_dir, spd(a_dim, a_scale), spd(b_dim, b_scale), tag)
    save_prior_precision(la_dir, 300.0, 1.0, 300.0, 1.0)
    return Path(la_dir)
