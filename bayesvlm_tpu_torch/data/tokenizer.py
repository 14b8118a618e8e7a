"""Tokenization for the text towers, the port's copy of
`bayesvlm_tpu.data.tokenizer`.

Real runs: `HFTokenizer` wraps an HF tokenizer loaded from a *local*
snapshot directory (offline; `transformers` is imported only there, as a
host-side text codec). `HashTokenizer` is the deterministic stand-in the
JAX package's tests and benchmarks use, copied so that both packages
produce the same ids for the same prompts. Ids are always padded to the
model max length; for causal CLIP the pooled output is taken at the EOS
position, which padding after EOS cannot reach, and SigLIP's reference
pads to max length itself (ref:vlm.py:446).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np


class HFTokenizer:
    """Adapter: HF tokenizer -> fixed-length int32 id matrix."""

    def __init__(self, tokenizer, max_length: int):
        self.tokenizer = tokenizer
        self.max_length = max_length

    @classmethod
    def from_local(cls, path: str, max_length: int) -> "HFTokenizer":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path, local_files_only=True), max_length)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        enc = self.tokenizer(
            text=list(texts),
            padding="max_length",
            truncation=True,
            max_length=self.max_length,
            return_tensors="np",
        )
        return enc["input_ids"].astype(np.int32)


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


def make_tokenizer(text_config, tokenizer_dir=None):
    """The text tower's tokenizer, as the JAX entry points pick it: the HF
    tokenizer of `tokenizer_dir` when given, else `HashTokenizer` over the
    tower's vocabulary with its EOS id."""
    if tokenizer_dir is not None:
        return HFTokenizer.from_local(tokenizer_dir, text_config.max_length)
    return HashTokenizer(text_config.vocab_size, text_config.max_length,
                         eos_id=text_config.eos_token_id)
