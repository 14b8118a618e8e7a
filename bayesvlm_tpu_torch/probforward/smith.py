"""Probabilistic image-text similarity head: mean and variance of the
cosine logits under the K-FAC Laplace posterior.

Counterpart of `bayesvlm_tpu.probforward.smith`, the "Smith forward" of
ref:bayesvlm/vlm.py:630-684:

    1. (biased projections) append a ones column to the activations
    2. sigma[i, :] = (a_i^T A_inv a_i) * diag(B_inv)      per-sample diag cov
    3. E||z||^2 = sum(mu^2 + sigma)                        expected sq. norms
    4. mean     = (mu_s / sqrt(Es)) @ (mu_t / sqrt(Et))^T
    5. var      = ((mu_s^2 + sigma_s) @ sigma_t^T + sigma_s @ (mu_t^2)^T)
                  / (Es Et^T)
    6. mean *= e^s, var *= e^{2s}

The head runs in fp32 at "highest" matmul precision, as the JAX head
does (`jax.default_matmul_precision("highest")`): on the card TF32 would
keep about three decimal digits of the variance terms, so
`_highest_fp32_matmul` keeps it out of these GEMMs whatever the caller
set globally.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits


@contextlib.contextmanager
def _highest_fp32_matmul():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@dataclasses.dataclass
class ProbabilisticHead:
    """Similarity head state: temperature, bias and the two posteriors
    (ref:bayesvlm/vlm.py:567-728). `*_projection_has_bias` marks SigLIP's
    biased projections (ones column appended to the activations)."""

    logit_scale: torch.Tensor
    logit_bias: torch.Tensor
    source_covariance: Optional[KroneckerFactorizedCovariance] = None
    target_covariance: Optional[KroneckerFactorizedCovariance] = None
    source_projection_has_bias: bool = False
    target_projection_has_bias: bool = False

    @classmethod
    def create(cls, logit_scale: float, logit_bias: float = 0.0,
               device="cuda", has_bias: bool = False) -> "ProbabilisticHead":
        return cls(
            logit_scale=torch.tensor(logit_scale, dtype=torch.float32, device=device),
            logit_bias=torch.tensor(logit_bias, dtype=torch.float32, device=device),
            source_projection_has_bias=has_bias,
            target_projection_has_bias=has_bias,
        )

    def set_covariances(
        self,
        source_covariance: Optional[KroneckerFactorizedCovariance],
        target_covariance: Optional[KroneckerFactorizedCovariance],
    ) -> "ProbabilisticHead":
        return dataclasses.replace(self, source_covariance=source_covariance,
                                   target_covariance=target_covariance)

    def __call__(self, source: EncoderResult, target: EncoderResult,
                 map_estimate: bool = False) -> ProbabilisticLogits:
        """Dispatch like ref:bayesvlm/vlm.py:686-710."""
        if map_estimate:
            mean = deterministic_logits(source.embeds, target.embeds,
                                        self.logit_scale, self.logit_bias)
            return ProbabilisticLogits(mean=mean, var=torch.zeros_like(mean))
        return probabilistic_logits(self, source, target)


def deterministic_logits(source_embeds: torch.Tensor,
                         target_embeds: torch.Tensor,
                         logit_scale: torch.Tensor,
                         logit_bias: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity logits (ref:bayesvlm/vlm.py:617-628)."""
    s = source_embeds / torch.linalg.norm(source_embeds, dim=-1, keepdim=True)
    t = target_embeds / torch.linalg.norm(target_embeds, dim=-1, keepdim=True)
    with _highest_fp32_matmul():
        return s @ t.T * torch.exp(logit_scale) + logit_bias


def _maybe_append_ones(a: torch.Tensor, has_bias: bool) -> torch.Tensor:
    if has_bias:
        return torch.cat([a, torch.ones_like(a[:, :1])], dim=-1)
    return a


def activation_diag_covariance(activations: torch.Tensor,
                               cov: KroneckerFactorizedCovariance,
                               has_bias: bool = False) -> torch.Tensor:
    """Per-sample diagonal embedding covariance
    sigma[i, :] = (a_i^T A_inv a_i) * diag(B_inv)  (ref:bayesvlm/vlm.py:662).
    Returns [N, D]."""
    a = _maybe_append_ones(activations, has_bias)
    with _highest_fp32_matmul():
        quad = ((a @ cov.A_inv) * a).sum(dim=-1)
    return quad[:, None] * torch.diagonal(cov.B_inv)[None, :]


def probabilistic_logits(head: ProbabilisticHead, source: EncoderResult,
                         target: EncoderResult) -> ProbabilisticLogits:
    """Mean/variance of scaled cosine logits (ref:bayesvlm/vlm.py:630-684)."""
    if head.source_covariance is None or head.target_covariance is None:
        raise ValueError("covariances must be set before the probabilistic forward")
    mu_s, mu_t = source.embeds.float(), target.embeds.float()
    sigma_s = activation_diag_covariance(
        source.activations.float(), head.source_covariance,
        head.source_projection_has_bias)                     # [B, D]
    sigma_t = activation_diag_covariance(
        target.activations.float(), head.target_covariance,
        head.target_projection_has_bias)                     # [C, D]
    n_s = mu_s**2 + sigma_s
    n_t = mu_t**2 + sigma_t
    E_s = n_s.sum(dim=-1, keepdim=True)                      # [B, 1]
    E_t = n_t.sum(dim=-1, keepdim=True)                      # [C, 1]
    with _highest_fp32_matmul():
        mean = (mu_s / torch.sqrt(E_s)) @ (mu_t / torch.sqrt(E_t)).T
        var = (n_s @ sigma_t.T + sigma_s @ (mu_t**2).T) / (E_s * E_t.T)
    scale = torch.exp(head.logit_scale)
    return ProbabilisticLogits(mean=mean * scale, var=var * scale**2)
