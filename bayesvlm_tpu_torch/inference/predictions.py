"""Batched probabilistic predictions over cached features
(ref:bayesvlm/precompute.py:18-65), counterpart of
`bayesvlm_tpu.inference.predictions.make_predictions`.

The image set runs against the full class-prompt set in batches of the
Smith forward; results stay on the features' device. The `.pt` logits
cache of the JAX version is not ported yet.
"""

from __future__ import annotations

from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits


def make_predictions(
    head: ProbabilisticHead,
    image_outputs: EncoderResult,
    text_outputs: EncoderResult,
    batch_size: int = 2048,
    map_estimate: bool = False,
) -> ProbabilisticLogits:
    return ProbabilisticLogits.concatenate([
        head(image_outputs[start:start + batch_size], text_outputs,
             map_estimate=map_estimate)
        for start in range(0, len(image_outputs), batch_size)
    ])
