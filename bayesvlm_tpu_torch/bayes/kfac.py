"""Kronecker-factored Laplace covariance (K-FAC) utilities.

Counterpart of `bayesvlm_tpu.bayes.kfac`. The posterior covariance over
the projection-layer weights is `(A sqrt(n) + sqrt(lambda) I)^-1 (x)
(B sqrt(n) + sqrt(lambda) I)^-1`, with `A` and `B` stored divided by
`sqrt(n)` (ref:scripts/hessian_estimation.py:106-109,
ref:bayesvlm/hessians.py:149-152,170-184). Artifact compatibility
depends on that scaling convention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass
class KroneckerFactorizedCovariance:
    """Inverse Kronecker factors of the posterior covariance
    (ref:bayesvlm/hessians.py:120-134)."""

    A_inv: torch.Tensor
    B_inv: torch.Tensor


def regularize_kfac_factor(F: torch.Tensor, n, lmbda) -> torch.Tensor:
    """`F * sqrt(n) + sqrt(lambda) * I` (ref:bayesvlm/hessians.py:176-179)."""
    eye = torch.eye(F.shape[0], dtype=F.dtype, device=F.device)
    return F * math.sqrt(float(n)) + math.sqrt(float(lmbda)) * eye


def compute_covariance(A: torch.Tensor, B: torch.Tensor, n,
                       lmbda) -> KroneckerFactorizedCovariance:
    """Regularize both factors and invert (ref:bayesvlm/hessians.py:170-184)."""
    return KroneckerFactorizedCovariance(
        A_inv=torch.linalg.inv(regularize_kfac_factor(A, n, lmbda)),
        B_inv=torch.linalg.inv(regularize_kfac_factor(B, n, lmbda)),
    )


def compute_covariances(
    A_img: torch.Tensor,
    B_img: torch.Tensor,
    A_txt: torch.Tensor,
    B_txt: torch.Tensor,
    info: dict,
) -> Tuple[KroneckerFactorizedCovariance, KroneckerFactorizedCovariance]:
    """Image + text covariances from raw factors and the prior-precision
    info {lambda_img, lambda_txt, n_img, n_txt}
    (ref:bayesvlm/hessians.py:187-201)."""
    cov_img = compute_covariance(A_img, B_img, info["n_img"], info["lambda_img"])
    cov_txt = compute_covariance(A_txt, B_txt, info["n_txt"], info["lambda_txt"])
    return cov_img, cov_txt
