"""Sharded K-FAC factor accumulation, counterpart of
`bayesvlm_tpu.dist.hessian_allreduce`: the source rows of a class batch
are split over the mesh's ranks, each rank computes the block statistics
of bayes/hessians.py (w [C], G [D, D]) on its rows, the partials are
`all_reduce`d with SUM and every rank assembles the replicated [D, D]
factor. The [C, D] targets (the contrastive class batch) are replicated.

Every rank takes the same full inputs; its rows are its contiguous block
of the source rows padded with rows of ones to a multiple of the world
size, the padding masked out (`row_mask`), as JAX's `_pad_rows`.
`block_size` walks a rank's rows in blocks (bounding the [block, C]
logits buffers), `chunk_j` the SigLIP target axis, and `precision`
("highest" fp32, "high" 3xTF32 in its own scope) is as on one device;
no global TF32 setting is touched. With a different world size the sums
come in another order: the factors agree to fp32 reassociation. With no
mesh (None) each function is one device's: every row is valid, the mask
multiplies by one, and the factor has the bits of bayes/hessians.py's
dense function.
"""

from __future__ import annotations

from typing import Optional

import torch

from bayesvlm_tpu_torch.bayes.hessians import (
    _assemble_factor,
    _check_precision,
    _infonce_block_stats,
    _l2_normalize,
    _siglip_block_stats,
    _sum_blocks,
    _to_fp32,
)
from bayesvlm_tpu_torch.dist.mesh import all_reduce_sum, check_mesh, local_rows
from bayesvlm_tpu_torch.probforward.smith import _highest_fp32_matmul


def _reduced(w: torch.Tensor, G: torch.Tensor, mesh):
    return all_reduce_sum(w, mesh), all_reduce_sum(G, mesh)


def sharded_hessian_infonce(source_embeds, target_embeds, logit_scale, mesh,
                            block_size: Optional[int] = None,
                            precision: str = "highest") -> torch.Tensor:
    """The InfoNCE GGN over a mesh: the replicated [D, D] factor."""
    _check_precision(precision)
    check_mesh(mesh)
    source, target, scale = _to_fp32(source_embeds, target_embeds, logit_scale)
    src, mask = local_rows(source, mesh)
    Y, _ = _l2_normalize(target)
    w, G = _sum_blocks(lambda lo, hi: _infonce_block_stats(
        src[lo:hi], Y, scale, row_mask=mask[lo:hi], precision=precision),
        src.shape[0], block_size)
    return _assemble_factor(*_reduced(w, G, mesh), Y)


def sharded_hessian_siglip(x_batch, indices_batch, y, logit_scale, logit_bias, mesh,
                           block_size: Optional[int] = None,
                           chunk_j: Optional[int] = None,
                           precision: str = "highest") -> torch.Tensor:
    """The SigLIP GGN over a mesh: the replicated [D, D] factor."""
    _check_precision(precision)
    check_mesh(mesh)
    x, y, scale, bias = _to_fp32(x_batch, y, logit_scale, logit_bias)
    idx = torch.as_tensor(indices_batch).to(x.device, torch.long)
    x_local, mask = local_rows(x, mesh)
    idx_local, _ = local_rows(idx, mesh, fill=0)
    Yn, _ = _l2_normalize(y)
    w, G = _sum_blocks(lambda lo, hi: _siglip_block_stats(
        x_local[lo:hi], idx_local[lo:hi], Yn, scale, bias, row_mask=mask[lo:hi],
        chunk_j=chunk_j, precision=precision), x_local.shape[0], block_size)
    return _assemble_factor(*_reduced(w, G, mesh), Yn)


def sharded_activation_gram(activations, mesh,
                            append_bias_column: bool = False) -> torch.Tensor:
    """activations^T activations over a mesh (with the ones column of a
    biased projection), fp32: the replicated Gram."""
    check_mesh(mesh)
    a = torch.as_tensor(activations).float()
    a_local, mask = local_rows(a, mesh)
    a_masked = a_local * mask[:, None]
    if append_bias_column:
        a_masked = torch.cat([a_masked, mask[:, None]], dim=-1)
    with _highest_fp32_matmul():
        return all_reduce_sum(a_masked.T @ a_masked, mesh)
