"""Evaluation metrics: ACC, NLPD, ECE, counterparts of
`bayesvlm_tpu.inference.metrics`.

ECE reproduces torchmetrics' `MulticlassCalibrationError(n_bins=20,
norm='l1')` semantics used by the reference (ref:scripts/zeroshot.py:17-23):
top-1 confidence binned into `n_bins` equal-width bins over (0, 1], L1
weighting |acc_bin - conf_bin| * (count_bin / N).
"""

from __future__ import annotations

from typing import Tuple

import torch


def accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample 0/1 accuracy vector (ref:scripts/zeroshot.py:19-20)."""
    return (probs.argmax(dim=-1) == labels.to(probs.device)).float()


def nlpd(probs: torch.Tensor, labels: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-sample negative log predictive density, -log Categorical(probs)[y]
    with the probabilities renormalised first, as torch's Categorical does
    (ref:scripts/zeroshot.py:21)."""
    probs = probs / probs.sum(dim=-1, keepdim=True)
    labels = labels.to(probs.device, torch.long)
    p_true = probs.gather(-1, labels[:, None])[:, 0]
    return -torch.log(p_true + eps)


def expected_calibration_error(probs: torch.Tensor, labels: torch.Tensor,
                               n_bins: int = 20) -> torch.Tensor:
    """L1 ECE with equal-width confidence bins (torchmetrics parity): a
    confidence on an edge falls in the bin below it (searchsorted left,
    minus one, clipped to the bins)."""
    conf, pred = probs.max(dim=-1)
    correct = (pred == labels.to(probs.device)).to(probs.dtype)
    # i * (1 / n_bins) rounded, the edges of jnp.linspace (torch.linspace
    # rounds 0.65 and 0.9 to other floats, which moves a confidence that
    # lies on one into another bin)
    step = torch.tensor(1.0 / n_bins, dtype=probs.dtype, device=probs.device)
    edges = torch.arange(n_bins + 1, dtype=probs.dtype, device=probs.device) * step
    bin_idx = (torch.searchsorted(edges, conf.contiguous(), right=False) - 1
               ).clamp(0, n_bins - 1)
    counts = torch.zeros(n_bins, dtype=probs.dtype, device=probs.device)
    conf_sum, acc_sum = torch.zeros_like(counts), torch.zeros_like(counts)
    counts.index_add_(0, bin_idx, torch.ones_like(conf))
    conf_sum.index_add_(0, bin_idx, conf)
    acc_sum.index_add_(0, bin_idx, correct)
    nonzero = counts > 0
    avg_conf = torch.where(nonzero, conf_sum / counts.clamp_min(1.0), 0.0)
    avg_acc = torch.where(nonzero, acc_sum / counts.clamp_min(1.0), 0.0)
    return ((avg_acc - avg_conf).abs() * (counts / conf.shape[0])).sum()


def evaluate_prediction(probs: torch.Tensor, labels: torch.Tensor,
                        num_classes: int, n_bins: int = 20
                        ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(per-sample acc, per-sample nlpd, scalar ece), as
    ref:scripts/zeroshot.py:17-23. `num_classes` is implied by the shape
    and kept for the CLI's signature."""
    del num_classes
    labels = torch.as_tensor(labels, device=probs.device)
    return (accuracy(probs, labels), nlpd(probs, labels),
            float(expected_calibration_error(probs, labels, n_bins=n_bins)))
