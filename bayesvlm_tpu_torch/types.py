"""Core value containers: `EncoderResult` and `ProbabilisticLogits`.

Counterparts of `bayesvlm_tpu.types` (ref:bayesvlm/vlm.py:27-204), as
plain dataclasses of torch tensors. Every Monte-Carlo draw comes from
`_normal`, backed by an explicit `torch.Generator` seeded by the caller;
it gives other numbers than the JAX package's `jax.random` keys for the
same seed, so the two agree in distribution, not bit for bit (a test
hands both packages the same noise by replacing `_normal`).

The probit path takes elementwise variances ([N, C]) as they are, as the
reference's zero-shot script does (ref:scripts/zeroshot.py:119-120).
Full-covariance ([N, C, C]) sampling is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

_PROBIT_C = math.pi / 8.0


@dataclasses.dataclass
class EncoderResult:
    """Frozen-encoder outputs for a batch.

    Attributes:
      embeds:       [N, D] post-projection embeddings.
      activations:  [N, P] pre-projection pooled activations (the Laplace
                    layer's inputs).
      residuals:    [N, D] SigLIP attention-pool skip connection re-added
                    after the fc2 projection (zeros for CLIP).
    """

    embeds: torch.Tensor
    activations: torch.Tensor
    residuals: torch.Tensor

    @classmethod
    def create(cls, embeds: torch.Tensor, activations: torch.Tensor,
               residuals: Optional[torch.Tensor] = None) -> "EncoderResult":
        if residuals is None:
            residuals = torch.zeros_like(embeds)
        return cls(embeds=embeds, activations=activations, residuals=residuals)

    def __len__(self) -> int:
        return self.embeds.shape[0]

    def __getitem__(self, idx) -> "EncoderResult":
        return EncoderResult(self.embeds[idx], self.activations[idx],
                             self.residuals[idx])

    @staticmethod
    def concatenate(results: list["EncoderResult"]) -> "EncoderResult":
        return EncoderResult(
            embeds=torch.cat([r.embeds for r in results]),
            activations=torch.cat([r.activations for r in results]),
            residuals=torch.cat([r.residuals for r in results]),
        )


def probit_scaled_mean(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Multiclass probit scaling mu / sqrt(1 + pi/8 * sigma^2)
    (ref:bayesvlm/vlm.py:74-78, ref:scripts/zeroshot.py:119-120)."""
    return mean / torch.sqrt(1.0 + _PROBIT_C * var)


def _normal(seed: int, shape, device, dtype) -> torch.Tensor:
    """Standard normal noise of `shape` from a generator seeded with
    `seed`: the one source of the Monte-Carlo noise of this module."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


@dataclasses.dataclass
class ProbabilisticLogits:
    """Gaussian distribution over logits: mean [N, C] and elementwise
    variance [N, C] (the Smith forward's output)."""

    mean: torch.Tensor
    var: torch.Tensor

    def __len__(self) -> int:
        return self.mean.shape[0]

    def __getitem__(self, idx) -> "ProbabilisticLogits":
        return ProbabilisticLogits(mean=self.mean[idx], var=self.var[idx])

    def map_softmax(self, dim: int = -1) -> torch.Tensor:
        return torch.softmax(self.mean, dim=dim)

    def probit_softmax(self, dim: int = -1) -> torch.Tensor:
        """num_samples=0 path of ref:bayesvlm/vlm.py:74-78."""
        return torch.softmax(probit_scaled_mean(self.mean, self.var), dim=dim)

    def softmax(self, dim: int = -1, num_samples: int = 400,
                seed: Optional[int] = None) -> torch.Tensor:
        """Expected softmax probabilities: the probit approximation when
        num_samples == 0, else the Monte-Carlo mean of softmax samples
        (ref:bayesvlm/vlm.py:68-103)."""
        if num_samples == 0:
            return self.probit_softmax(dim=dim)
        logits = self._sample_logits(seed, num_samples)
        return torch.softmax(logits, dim=dim).mean(dim=0)

    def _sample_logits(self, seed: Optional[int], num_samples: int) -> torch.Tensor:
        """[S, N, C] Gaussian samples of the logits (diagonal variance)."""
        if self.var.ndim != self.mean.ndim:
            raise NotImplementedError(
                "full-covariance sampling is not ported yet")
        eps = _normal(0 if seed is None else int(seed),
                      (num_samples,) + tuple(self.mean.shape),
                      self.mean.device, self.mean.dtype)
        return self.mean[None] + eps * torch.sqrt(self.var)[None]

    def sample_probas(self, num_samples: int,
                      seed: Optional[int] = None) -> torch.Tensor:
        """[N, S, C] softmax probability samples (ref:bayesvlm/vlm.py:105-139)."""
        logits = self._sample_logits(seed, num_samples)
        return torch.softmax(logits, dim=-1).transpose(0, 1)

    @staticmethod
    def concatenate(parts: list["ProbabilisticLogits"]) -> "ProbabilisticLogits":
        return ProbabilisticLogits(
            mean=torch.cat([p.mean for p in parts]),
            var=torch.cat([p.var for p in parts]),
        )
