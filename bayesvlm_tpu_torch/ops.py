"""Primitive helpers shared across the port's subsystems.

topk_exact: the top-k over the last dimension with `jax.lax.top_k`'s tie
order, which the JAX package's `ops.topk_exact` keeps: among equal
values the lower index comes first. `torch.topk` promises no order among
ties on the card, and the kNN dedup reads the order of the columns, so
the top-k here is a stable descending sort cut to k.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def topk_exact(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of a 1-D or
    2-D tensor, in descending order, ties by ascending index. NaN inputs
    are unspecified, as for `lax.top_k`."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def to_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stream_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for member `stream` of a family of independent
    generators of one `seed` (numpy's SeedSequence mixing)."""
    return int(np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(stream)])
               .generate_state(1, np.uint64)[0])
