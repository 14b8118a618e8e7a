"""The port's one source of random index draws: permutations (and the
choices without replacement taken from their prefix) and categorical
samples, each from a CPU `torch.Generator` seeded by the caller, so that
the card and the CPU draw the same indices.

The JAX package draws these with `jax.random` keys; the port draws other
indices for the same seed, so the two agree in distribution, not index
for index. A test hands the port the JAX package's draws by replacing
`permutation` and `categorical`, as it replaces `types._normal` for the
Gaussian noise; callers therefore reach them through this module
(`draws.permutation(...)`), never by a name imported from it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bayesvlm_tpu_torch.ops import stream_seed


def _generator(seed: int, stream: Optional[int]) -> torch.Generator:
    return torch.Generator().manual_seed(
        int(seed) if stream is None else stream_seed(seed, stream))


def permutation(seed: int, n: int, stream: Optional[int] = None) -> np.ndarray:
    """A permutation of range(n) (int64). `stream` i gives the i-th of a
    family of independent permutations of one seed: where the JAX package
    splits its key i + 1 times (`key, sub = split(key)`) and permutes with
    `sub`, the port passes `stream=i`; where it permutes with the seed's
    own key, no stream."""
    return torch.randperm(int(n), generator=_generator(seed, stream)).numpy()


def categorical(seed: int, logits: torch.Tensor, k: int) -> np.ndarray:
    """k draws with replacement from softmax(logits) (int64), as
    `jax.random.categorical(key(seed), logits, shape=(k,))`."""
    probs = torch.softmax(logits.detach().to("cpu", torch.float64), dim=-1)
    return torch.multinomial(probs, int(k), replacement=True,
                             generator=_generator(seed, None)).numpy()
