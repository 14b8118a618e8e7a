"""Uncertainty scores and top-k selection strategies
(ref:bayesvlm/selection.py), counterparts of `bayesvlm_tpu.select.scores`.

Score variants:
  entropy variants (ref:selection.py:7-26):
    map_alea   H[softmax(mean)]
    exp_alea   E_theta[H[softmax(sample)]]            (MC)
    comb       H[probit softmax]                      (num_samples=0)
    comb_covar H[MC-average softmax]
  complexity variants (ref:selection.py:28-50):
    var              trace of the per-sample covariance
    logdet           logdet of full covariance
    entropy          one of the entropy variants
    exp_mutual_info  BALD: H_total - E[H_alea]
    map_mutual_info  H_total - H[softmax(mean)]

The scores stay on the logits' device; the top-k keeps the JAX package's
tie order (`ops.topk_exact`). The Gaussian noise comes from
`types._normal`, the random indices from `select/draws.py`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bayesvlm_tpu_torch.ops import topk_exact
from bayesvlm_tpu_torch.select import draws
from bayesvlm_tpu_torch.types import ProbabilisticLogits


def _plain_entropy(probs: torch.Tensor) -> torch.Tensor:
    xlogx = torch.where(probs > 0, probs * torch.log(probs), torch.zeros_like(probs))
    return -xlogx.sum(dim=-1)


def entropy_score(prob_logits: ProbabilisticLogits, variant: str,
                  num_samples: int = 1000, seed: Optional[int] = None,
                  chunk_size: Optional[int] = 10_000) -> torch.Tensor:
    """ref:bayesvlm/selection.py:7-26. `chunk_size` bounds the
    full-covariance Monte-Carlo buffers (ref:bayesvlm/vlm.py:87-103)."""
    if variant == "exp_alea":
        return prob_logits.expected_aleatoric_entropy(
            num_samples=num_samples, seed=seed, chunk_size=chunk_size)
    if variant == "map_alea":
        probas = torch.softmax(prob_logits.mean, dim=-1)
    elif variant == "comb":
        probas = prob_logits.softmax(num_samples=0, seed=seed)
    elif variant == "comb_covar":
        probas = prob_logits.softmax(num_samples=num_samples, seed=seed,
                                     chunk_size=chunk_size)
    else:
        raise ValueError(f"unknown entropy variant {variant}")
    return _plain_entropy(probas)


def complexity_score(prob_logits: ProbabilisticLogits, variant: str,
                     entropy_variant: Optional[str] = None,
                     seed: Optional[int] = None, num_samples: int = 1000,
                     chunk_size: Optional[int] = 10_000) -> torch.Tensor:
    """ref:bayesvlm/selection.py:28-50."""
    kw = dict(seed=seed, num_samples=num_samples, chunk_size=chunk_size)
    if variant == "var":
        return prob_logits.diag_var.sum(dim=-1)
    if variant == "logdet":
        return torch.linalg.slogdet(prob_logits.var)[1]
    if variant == "entropy":
        return entropy_score(prob_logits, entropy_variant, **kw)
    if variant == "exp_mutual_info":
        return (entropy_score(prob_logits, "comb_covar", **kw)
                - entropy_score(prob_logits, "exp_alea", **kw))
    if variant == "map_mutual_info":
        return (entropy_score(prob_logits, "comb_covar", **kw)
                - entropy_score(prob_logits, "map_alea", **kw))
    raise ValueError(f"unknown complexity variant {variant}")


def select_topk(prob_logits: ProbabilisticLogits, k: int, variant: str,
                entropy_variant: Optional[str] = None,
                ignore_percentage: float = 0.0, return_values: bool = False,
                seed: Optional[int] = None, chunk_size: Optional[int] = 10_000):
    """Top-k by complexity, after skipping the top `ignore_percentage` of
    the pool (ref:bayesvlm/selection.py:52-75)."""
    N = prob_logits.mean.shape[0]
    offset = int(N * ignore_percentage) if ignore_percentage > 0 else 0
    n = min(k + offset, N)
    complexity = complexity_score(prob_logits, variant, entropy_variant,
                                  seed=seed, chunk_size=chunk_size)
    values, indices = topk_exact(complexity, n)
    if return_values:
        return indices[offset:], values[offset:]
    return indices[offset:]


def _quotas(class_ids: np.ndarray, k: int):
    """(class positions, classes, per-class counts) of a class-balanced
    draw of k (ref:bayesvlm/selection.py:77-102, 124-140)."""
    classes = np.unique(class_ids)
    per, residuals = divmod(k, len(classes))
    return [(i, c, per + (1 if i < residuals else 0)) for i, c in enumerate(classes)]


def select_topk_classbalanced(prob_logits: ProbabilisticLogits, class_ids, k: int,
                              variant: str, entropy_variant: Optional[str] = None):
    """Per-class quota top-k (ref:bayesvlm/selection.py:77-102).

    DIVERGENCE, kept from the JAX package: the reference returns the
    top-k positions inside each class mask, which are no dataset indices;
    here they are mapped back to global indices."""
    class_ids = np.asarray(torch.as_tensor(class_ids).cpu())
    device = prob_logits.mean.device
    out = []
    for _, c, n in _quotas(class_ids, k):
        if n == 0:
            continue
        members = np.nonzero(class_ids == c)[0]
        sub = prob_logits[torch.as_tensor(members, device=device)]
        if variant == "var":
            # diag_var: a full covariance [n, C, C] must score [n], not [n, C]
            score = sub.diag_var.sum(dim=1)
        else:
            score = entropy_score(sub, entropy_variant)
        _, idx = topk_exact(score, min(n, score.shape[0]))
        out.append(members[idx.cpu().numpy()])
    return torch.as_tensor(np.concatenate(out), device=device)


def select_topk_randomized(prob_logits: ProbabilisticLogits, k: int, temp: float,
                           variant: str, entropy_variant: Optional[str] = None,
                           seed: int = 0) -> torch.Tensor:
    """k categorical draws, with replacement, from softmax(z-scored
    complexity * temp) (ref:bayesvlm/selection.py:104-120)."""
    complexity = complexity_score(prob_logits, variant, entropy_variant)
    z = (complexity - complexity.mean()) / complexity.std(correction=0)
    return torch.as_tensor(draws.categorical(seed, z * temp, k))


def select_random(prob_logits: ProbabilisticLogits, k: int,
                  seed: Optional[int]) -> torch.Tensor:
    """A seeded random permutation's prefix (ref:bayesvlm/selection.py:143-147)."""
    N = prob_logits.var.shape[0]
    return torch.as_tensor(draws.permutation(0 if seed is None else seed, N)[:k])


def select_random_classbalanced(class_ids, k: int, seed: int) -> torch.Tensor:
    """ref:bayesvlm/selection.py:124-140: class i's members permuted with
    stream i of `seed` (the JAX package's i-th key split)."""
    class_ids = np.asarray(torch.as_tensor(class_ids).cpu())
    out = []
    for i, c, n in _quotas(class_ids, k):
        members = np.nonzero(class_ids == c)[0]
        out.append(members[draws.permutation(seed, len(members), stream=i)[:n]])
    return torch.as_tensor(np.concatenate(out))


def create_subset_json(prob_logits: ProbabilisticLogits, class_ids, k: int) -> dict:
    """Every strategy's subset at once (ref:bayesvlm/selection.py:150-174)."""
    def ids(t):
        return t.cpu().numpy().tolist()

    d = {
        "topk_var": ids(select_topk(prob_logits, k, variant="var")),
        "topk_entropy_alea": ids(select_topk(prob_logits, k, variant="entropy",
                                             entropy_variant="map_alea")),
        "topk_entropy_comb": ids(select_topk(prob_logits, k, variant="entropy",
                                             entropy_variant="comb")),
        "topk_entropy_comb_covar": ids(select_topk(prob_logits, k, variant="entropy",
                                                   entropy_variant="comb_covar")),
    }
    for i in range(3):
        d[f"topk_randomized_var_{i}"] = ids(select_topk_randomized(
            prob_logits, k, temp=1.0, variant="var", seed=i))
        for name, ev in (("alea", "map_alea"), ("comb", "comb"),
                         ("comb_covar", "comb_covar")):
            d[f"topk_randomized_entropy_{name}_{i}"] = ids(select_topk_randomized(
                prob_logits, k, temp=1.0, variant="entropy", entropy_variant=ev,
                seed=i))
        d[f"random_{i}"] = ids(select_random(prob_logits, k, seed=i))
    return d
