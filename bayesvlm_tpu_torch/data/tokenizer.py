"""Tokenization for the text towers.

`HashTokenizer` is the deterministic stand-in the JAX package's tests
and benchmarks use (`bayesvlm_tpu.data.tokenizer.HashTokenizer`), copied
so that both packages produce the same ids for the same prompts. Ids are
always padded to the model max length; for causal CLIP the pooled output
is taken at the EOS position, which padding after EOS cannot reach.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np


class HashTokenizer:
    """Deterministic test tokenizer: hashes whitespace tokens into the
    vocab, wraps with BOS/EOS, pads with EOS-id like CLIP's tokenizer."""

    def __init__(self, vocab_size: int, max_length: int, bos_id: int = 0,
                 eos_id: int = None):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id = bos_id
        self.eos_id = eos_id if eos_id is not None else vocab_size - 1

    def _tok(self, text: str) -> List[int]:
        ids = [self.bos_id]
        for w in text.lower().split():
            # stable digest, not Python hash(): hash() is randomized per
            # process (PYTHONHASHSEED)
            h = int.from_bytes(
                hashlib.md5(w.encode()).digest()[:4], "little"
            ) % (self.vocab_size - 2)
            ids.append(1 + h)
        ids = ids[: self.max_length - 1]
        ids.append(self.eos_id)
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos_id, np.int32)
        for i, t in enumerate(texts):
            ids = self._tok(t)
            out[i, : len(ids)] = ids
        return out
