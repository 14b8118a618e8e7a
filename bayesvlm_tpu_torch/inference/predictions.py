"""Batched probabilistic predictions over cached features
(ref:bayesvlm/precompute.py:18-65), counterpart of
`bayesvlm_tpu.inference.predictions.make_predictions`.

The image set runs against the full class-prompt set in batches of the
Smith forward; results stay on the features' device. With a `cache_dir`
the mean and variance are read from / written to `logits_mean.pt` and
`logits_var.pt`, plain fp32 tensors in torch's zip format: the
reference's files and the JAX package's, which each reads too. Eager
torch needs no fixed-shape padding of the last batch.
`make_predictions_sharded` (the JAX package's mesh path) is not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits


def make_predictions(
    head: ProbabilisticHead,
    image_outputs: EncoderResult,
    text_outputs: EncoderResult,
    batch_size: int = 2048,
    save_predictions: bool = False,
    map_estimate: bool = False,
    cache_dir: Optional[Union[str, Path]] = None,
) -> ProbabilisticLogits:
    device = image_outputs.embeds.device
    if cache_dir is not None:
        cache_dir = Path(cache_dir)
        mean_path = cache_dir / "logits_mean.pt"
        var_path = cache_dir / "logits_var.pt"
        if mean_path.exists() and var_path.exists():
            return ProbabilisticLogits(
                mean=torch.load(mean_path, map_location=device, weights_only=True),
                var=torch.load(var_path, map_location=device, weights_only=True))

    logits = ProbabilisticLogits.concatenate([
        head(image_outputs[start:start + batch_size], text_outputs,
             map_estimate=map_estimate)
        for start in range(0, len(image_outputs), batch_size)
    ])

    if cache_dir is not None and save_predictions:
        cache_dir.mkdir(parents=True, exist_ok=True)
        torch.save(logits.mean.detach().cpu().contiguous(), mean_path)
        torch.save(logits.var.detach().cpu().contiguous(), var_path)
    return logits
