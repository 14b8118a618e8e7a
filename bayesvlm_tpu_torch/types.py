"""Core value containers: `EncoderResult` and `ProbabilisticLogits`.

Counterparts of `bayesvlm_tpu.types` (ref:bayesvlm/vlm.py:27-204), as
plain dataclasses of torch tensors. Every Monte-Carlo draw comes from
`_normal`, backed by an explicit `torch.Generator` seeded by the caller;
it gives other numbers than the JAX package's `jax.random` keys for the
same seed, so the two agree in distribution, not bit for bit (a test
hands both packages the same noise by replacing `_normal`).

The probit path takes elementwise variances ([N, C]) as they are, as the
reference's zero-shot script does (ref:scripts/zeroshot.py:119-120), and
the diagonal of a full covariance ([N, C, C]), as the JAX package does.
Full-covariance sampling draws each row's noise from that row's own
generator, so that a row's samples do not depend on the row chunking
(the JAX package folds the row index into its key), and falls back to a
jittered Cholesky factor where a covariance is not positive definite.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch

from bayesvlm_tpu_torch.ops import stream_seed

_PROBIT_C = math.pi / 8.0


@contextlib.contextmanager
def _highest_fp32_matmul():
    """fp32 products at full fp32 precision inside the scope, whatever the
    caller set globally (TF32 keeps about three decimal digits), as the
    JAX package computes them at "highest"."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


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

    def slice(self, start: int, size: int) -> "EncoderResult":
        """`size` rows from `start`, with `lax.dynamic_slice`'s semantics:
        a negative start counts from the end, then the start is clamped so
        that the slice fits."""
        start = int(start) + (len(self) if start < 0 else 0)
        start = max(0, min(start, len(self) - size))
        return self[start:start + size]

    def astype(self, dtype: torch.dtype) -> "EncoderResult":
        return EncoderResult(self.embeds.to(dtype), self.activations.to(dtype),
                             self.residuals.to(dtype))

    @staticmethod
    def concatenate(results: list["EncoderResult"]) -> "EncoderResult":
        return EncoderResult(
            embeds=torch.cat([r.embeds for r in results]),
            activations=torch.cat([r.activations for r in results]),
            residuals=torch.cat([r.residuals for r in results]),
        )


def _diag_var(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Per-class variances whatever the storage: [N, C] as it is, the
    diagonal of [N, C, C]."""
    if var.ndim == mean.ndim + 1:
        return torch.diagonal(var, dim1=-2, dim2=-1)
    return var


def probit_scaled_mean(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Multiclass probit scaling mu / sqrt(1 + pi/8 * sigma^2)
    (ref:bayesvlm/vlm.py:74-78, ref:scripts/zeroshot.py:119-120); a full
    covariance [N, C, C] contributes its diagonal."""
    return mean / torch.sqrt(1.0 + _PROBIT_C * _diag_var(mean, var))


def _draw(seed: int, shape, device, dtype) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _normal(seed: int, shape, device, dtype, rows=None) -> torch.Tensor:
    """Standard normal noise, the one source of the Monte-Carlo noise of
    this module: `shape` from a generator seeded with `seed`, or, with
    `rows` = (start, stop), [stop - start, *shape] whose row r comes from
    a generator of its own, seeded by (`seed`, r): the same row gets the
    same noise in any chunking."""
    if rows is None:
        return _draw(seed, shape, device, dtype)
    return torch.stack([_draw(stream_seed(seed, r), shape, device, dtype)
                        for r in range(*rows)])


def _seed(seed: Optional[int]) -> int:
    return 0 if seed is None else int(seed)


def _softmax_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross entropy with integer targets."""
    logp = torch.log_softmax(logits, dim=-1)
    target = target.to(torch.long).expand(logits.shape[:-1])
    return -logp.gather(-1, target[..., None])[..., 0]


@dataclasses.dataclass
class ProbabilisticLogits:
    """Gaussian distribution over logits: mean [N, C] and either an
    elementwise variance [N, C] (the Smith forward's output) or a full
    covariance [N, C, C] per row (ref:bayesvlm/vlm.py:63-204)."""

    mean: torch.Tensor
    var: torch.Tensor

    def __len__(self) -> int:
        return self.mean.shape[0]

    def __getitem__(self, idx) -> "ProbabilisticLogits":
        return ProbabilisticLogits(mean=self.mean[idx], var=self.var[idx])

    @property
    def diag_var(self) -> torch.Tensor:
        return _diag_var(self.mean, self.var)

    def map_softmax(self, dim: int = -1) -> torch.Tensor:
        return torch.softmax(self.mean, dim=dim)

    def probit_softmax(self, dim: int = -1) -> torch.Tensor:
        """num_samples=0 path of ref:bayesvlm/vlm.py:74-78."""
        return torch.softmax(probit_scaled_mean(self.mean, self.var), dim=dim)

    @property
    def probs(self) -> torch.Tensor:
        """Probit-approximated probabilities (ref:bayesvlm/vlm_elg.py:74-85)."""
        return self.probit_softmax()

    @property
    def log_probs(self) -> torch.Tensor:
        """log-softmax of the probit-scaled mean (ref:bayesvlm/vlm_elg.py:205-207)."""
        return torch.log_softmax(probit_scaled_mean(self.mean, self.var), dim=-1)

    def _sample_logits(self, seed: Optional[int], num_samples: int) -> torch.Tensor:
        """[S, N, C] Gaussian samples of the logits."""
        if self.var.ndim == self.mean.ndim:  # diagonal
            eps = _normal(_seed(seed), (num_samples,) + tuple(self.mean.shape),
                          self.mean.device, self.mean.dtype)
            return self.mean[None] + eps * torch.sqrt(self.var)[None]
        # full covariance: the chunked path in one chunk
        return self._fullcov_logits_chunk(slice(0, len(self)), seed,
                                          num_samples).transpose(0, 1)

    def _fullcov_logits_chunk(self, sl: slice, seed: Optional[int],
                              num_samples: int) -> torch.Tensor:
        """[n, S, C] MVN logit samples for one row chunk. Each row's noise
        is drawn by its global index (`_normal`'s `rows`), so the result
        does not depend on the chunking. A covariance whose Cholesky
        factorisation fails takes the factor of the covariance plus a
        jitter of 1e-6 x max(trace / C, 1) on its diagonal (the reference
        retries with growing jitter, ref:bayesvlm/vlm_elg.py:113-119)."""
        mean, var = self.mean[sl], self.var[sl]
        C = var.shape[-1]
        chol, info = torch.linalg.cholesky_ex(var)
        jitter = 1e-6 * torch.clamp(
            torch.diagonal(var, dim1=-2, dim2=-1).sum(-1) / C, min=1.0)[..., None, None]
        eye = torch.eye(C, dtype=var.dtype, device=var.device)
        chol_j = torch.linalg.cholesky_ex(var + jitter * eye).L
        bad = (info != 0) | torch.isnan(chol).any(dim=(-2, -1))
        chol = torch.where(bad[..., None, None], chol_j, chol)
        eps = _normal(_seed(seed), (num_samples, C), mean.device, mean.dtype,
                      rows=(sl.start, sl.stop))                          # [n, S, C]
        with _highest_fp32_matmul():
            corr = torch.einsum("ncd,nsd->nsc", chol, eps)
        return mean[:, None] + corr

    def _fullcov_chunks(self, chunk_size: Optional[int]) -> list:
        """Row-chunk slices mirroring ref:bayesvlm/vlm.py:87-103
        (chunk_size=10000): they bound the live [n, C, C] Cholesky factors
        and [n, S, C] samples."""
        N = len(self)
        if chunk_size is None or chunk_size >= N:
            return [slice(0, N)]
        return [slice(i, min(i + chunk_size, N)) for i in range(0, N, chunk_size)]

    def softmax(self, dim: int = -1, num_samples: int = 400,
                seed: Optional[int] = None,
                chunk_size: Optional[int] = 10_000) -> torch.Tensor:
        """Expected softmax probabilities: the probit approximation when
        num_samples == 0, else the Monte-Carlo mean of softmax samples,
        row-chunked for a full covariance (ref:bayesvlm/vlm.py:68-103)."""
        if num_samples == 0:
            return self.probit_softmax(dim=dim)
        if self.var.ndim == self.mean.ndim:
            logits = self._sample_logits(seed, num_samples)
            return torch.softmax(logits, dim=dim).mean(dim=0)
        return torch.cat([
            torch.softmax(self._fullcov_logits_chunk(sl, seed, num_samples),
                          dim=-1).mean(dim=1)
            for sl in self._fullcov_chunks(chunk_size)])

    def sample_probas(self, num_samples: int, seed: Optional[int] = None,
                      chunk_size: Optional[int] = 10_000) -> torch.Tensor:
        """[N, S, C] softmax probability samples (ref:bayesvlm/vlm.py:105-139),
        row-chunked for a full covariance."""
        if self.var.ndim == self.mean.ndim:
            logits = self._sample_logits(seed, num_samples)
            return torch.softmax(logits, dim=-1).transpose(0, 1)
        return torch.cat([
            torch.softmax(self._fullcov_logits_chunk(sl, seed, num_samples), dim=-1)
            for sl in self._fullcov_chunks(chunk_size)])

    def expected_aleatoric_entropy(self, num_samples: int = 400, dim: int = -1,
                                   seed: Optional[int] = None,
                                   chunk_size: Optional[int] = 10_000) -> torch.Tensor:
        """E_theta[H[p(y|x,theta)]] by Monte Carlo (ref:bayesvlm/vlm.py:142-158)."""
        def ent(logits, sample_dim):
            logp = torch.log_softmax(logits, dim=-1)
            return (-(torch.exp(logp) * logp).sum(-1)).mean(dim=sample_dim)

        if self.var.ndim == self.mean.ndim:
            return ent(self._sample_logits(seed, num_samples), 0)
        return torch.cat([ent(self._fullcov_logits_chunk(sl, seed, num_samples), 1)
                          for sl in self._fullcov_chunks(chunk_size)])

    def cross_entropy(self, target: torch.Tensor, num_samples: int = 400,
                      reduction: str = "sum", seed: Optional[int] = None,
                      chunk_size: Optional[int] = 10_000) -> torch.Tensor:
        """CE under the logit distribution (ref:bayesvlm/vlm.py:177-198):
        the probit-scaled CE when num_samples == 0, else the Monte-Carlo
        mean. The [N, C] path samples with the diagonal std, as the
        reference does (ref:bayesvlm/vlm.py:185-190)."""
        target = torch.as_tensor(target, device=self.mean.device)
        if num_samples == 0:
            losses = _softmax_ce(probit_scaled_mean(self.mean, self.var), target)
        elif self.var.ndim == self.mean.ndim:
            losses = _softmax_ce(self._sample_logits(seed, num_samples), target).mean(0)
        else:
            losses = torch.cat([
                _softmax_ce(self._fullcov_logits_chunk(sl, seed, num_samples),
                            target[sl, None]).mean(1)
                for sl in self._fullcov_chunks(chunk_size)])
        if reduction == "sum":
            return losses.sum()
        if reduction == "mean":
            return losses.mean()
        return losses

    @staticmethod
    def concatenate(parts: list["ProbabilisticLogits"]) -> "ProbabilisticLogits":
        return ProbabilisticLogits(
            mean=torch.cat([p.mean for p in parts]),
            var=torch.cat([p.var for p in parts]),
        )
