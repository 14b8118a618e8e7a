"""Batched probabilistic predictions over cached features
(ref:bayesvlm/precompute.py:18-65), counterpart of
`bayesvlm_tpu.inference.predictions.make_predictions`.

The image set runs against the full class-prompt set in batches of the
Smith forward; results stay on the features' device. With a `cache_dir`
the mean and variance are read from / written to `logits_mean.pt` and
`logits_var.pt`, plain fp32 tensors in torch's zip format: the
reference's files and the JAX package's, which each reads too. Eager
torch needs no fixed-shape padding of the last batch.

`make_predictions_sharded` splits the image rows over a mesh's ranks
(the text replicated) and gathers the logits, so every rank holds all
of them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from bayesvlm_tpu_torch.dist.mesh import all_gather_rows, local_rows
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


def make_predictions_sharded(
    head: ProbabilisticHead,
    image_outputs: EncoderResult,
    text_outputs: EncoderResult,
    mesh,
    batch_size: int = 2048,
) -> ProbabilisticLogits:
    """The probabilistic predictions with the image rows sharded over the
    mesh's ranks: the rows padded to a multiple of the world size with the
    last row repeated (as JAX pads them), each rank's block through the
    Smith forward in batches of `batch_size`, the text replicated; the
    logits gathered in rank order and the padding cut. Every rank takes
    the full features and returns the full logits. With no mesh (None),
    `make_predictions` on the whole set."""
    n = len(image_outputs)
    local = EncoderResult(*(local_rows(x, mesh, fill="edge")[0] for x in (
        image_outputs.embeds, image_outputs.activations, image_outputs.residuals)))
    logits = make_predictions(head, local, text_outputs, batch_size=batch_size)
    return ProbabilisticLogits(mean=all_gather_rows(logits.mean, mesh)[:n],
                               var=all_gather_rows(logits.var, mesh)[:n])
