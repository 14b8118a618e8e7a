"""Scalar prior-precision (lambda) optimization by marginal-likelihood ascent.

Counterpart of `bayesvlm_tpu.bayes.prior` (ref:bayesvlm/hessians.py:219-280):
Adam on `log lambda` minimising the negative of

    marglik = log_prior(|theta|^2, P, lambda) - logdet_kfac(A_, B_)
    log_prior = -0.5 * lambda * |theta|^2 + 0.5 * P * log(lambda)
    A_ = A * sqrt(n) + sqrt(lambda) I,  B_ likewise
    logdet_kfac = p * logdet(A_) + q * logdet(B_)   # p = dim(A), q = dim(B)

The logdet multipliers are *swapped* relative to the Kronecker identity
(`logdet(A (x) B) = q logdet A + p logdet B`); the reference's shipped
lambda values depend on this convention, so it is kept as it is.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


def log_prior(l2_norm_squared, num_params, lmbda):
    """ref:bayesvlm/hessians.py:273-274."""
    return -0.5 * lmbda * l2_norm_squared + 0.5 * num_params * torch.log(lmbda)


def log_det_kfac(A_reg: torch.Tensor, B_reg: torch.Tensor) -> torch.Tensor:
    """p * logdet(A) + q * logdet(B), reference convention
    (ref:bayesvlm/hessians.py:276-280)."""
    p = A_reg.shape[0]
    q = B_reg.shape[0]
    _, logdet_A = torch.linalg.slogdet(A_reg)
    _, logdet_B = torch.linalg.slogdet(B_reg)
    return logdet_A * p + logdet_B * q


def optimize_prior_precision(
    projection_l2_norm: float,
    projection_num_params: int,
    A: torch.Tensor,
    B: torch.Tensor,
    lmbda_init: float,
    n: float,
    lr: float = 1e-2,
    num_steps: int = 300,
) -> torch.Tensor:
    """Optimize the scalar prior precision lambda on A's device.

    The projection enters only through its squared L2 norm and parameter
    count (ref:bayesvlm/hessians.py:231-235). torch's Adam defaults
    (betas 0.9/0.999, eps 1e-8) are the ones the JAX package takes from
    optax. Returns lambda as a 0-d fp32 tensor.
    """
    A = A.to(torch.float32)
    B = B.to(A.device, torch.float32)
    sqrt_n = math.sqrt(float(n))
    A_n = A * sqrt_n
    B_n = B * sqrt_n
    eye_A = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    eye_B = torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
    proj_l2 = torch.tensor(float(projection_l2_norm), dtype=torch.float32,
                           device=A.device)
    num_params = int(projection_num_params)

    log_lmbda = torch.tensor(math.log(float(lmbda_init)), dtype=torch.float32,
                             device=A.device, requires_grad=True)
    opt = torch.optim.Adam([log_lmbda], lr=lr)
    for _ in range(int(num_steps)):
        opt.zero_grad(set_to_none=True)
        lmbda = torch.exp(log_lmbda)
        sqrt_l = torch.sqrt(lmbda)
        neg_marglik = -(log_prior(proj_l2, num_params, lmbda)
                        - log_det_kfac(A_n + sqrt_l * eye_A,
                                       B_n + sqrt_l * eye_B))
        neg_marglik.backward()
        opt.step()
    return torch.exp(log_lmbda.detach())


def l2_norm_squared(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Sum of squared entries over tensors, in fp32
    (ref:bayesvlm/hessians.py:267-268)."""
    return sum(p.float().square().sum() for p in params)


def param_count(params: Iterable[torch.Tensor]) -> int:
    """Total number of entries over tensors (ref:bayesvlm/hessians.py:270-271)."""
    return int(sum(p.numel() for p in params))
