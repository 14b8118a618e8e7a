"""Tensor parallelism of a tower over the "model" axis of a port mesh, the
counterpart of `bayesvlm_tpu/dist/tp.py:1-69`.

JAX states Megatron sharding as NamedShardings on the parameter tree and
lets GSPMD split the einsums and insert the all-reduces. The port's
towers are eager torch, so the same rule table is applied by hand, in
place, on a tower that already holds the full weights (every rank loads
them, as every JAX device is handed the full tree to slice):

  q/k/v_proj, fc1 weight [out, in] -> split dim 0 (output features):
                                      head-parallel; bias split dim 0
  out_proj, fc2 weight [out, in]   -> split dim 1 (input features): the
                                      partial products summed over the
                                      "model" group, then the bias once
  everything else (LayerNorms, embeddings, the projection, out/fc2
  biases)                          -> replicated

This is the port's own copy of JAX's table, in torch's [out, in] layout
(JAX's kernels are [in, out]). A split attention runs the fused
attention kernel on the rank's H/m heads.

The mesh is a 2-D `("data", "model")` DeviceMesh over the ranks
(`dist.mesh.make_mesh(("data", "model"), (d, m))`): each rank feeds its
data block through the tower and all-reduces over its "model" group. The
scope is what JAX's tests hold (`tests/test_tp.py:34-110`,
`tests/test_multiprocess_tp.py`): the forward, and the gradient of the
projection, which lies after every split sublayer and is averaged over
the "data" axis (`all_reduce_mean`). A backward through the split
sublayers is not ported: `train.backbone.make_backbone_train_step`
refuses a split tower.

Kernel lanes: a sublayer run by one fused kernel across the split
dimension keeps its full weights and runs unsplit on every rank: the
block lane's attention sublayer (LN, QKV, core and out-projection with
the residual in one kernel), the int8 attention projections (the
out-projection quantizes each row over every head) and the int8 MLP
(LN, fc1, activation and fc2 with the residual; it quantizes each row of
the whole hidden layer). JAX's tower under `shard_tower_params` runs
those lanes and gives the unsharded forward (checked on a virtual CPU
mesh); the port gives the same by running their kernels on the full
weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bayesvlm_tpu_torch.dist.mesh import all_reduce_sum, mesh_size

_COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1")  # split output features
_ROW_PARALLEL = ("out_proj", "fc2")                    # split input features


def _split_dim(name: str) -> Optional[int]:
    *path, kind = name.split(".")
    module = next((n for n in reversed(path) if n in _COL_PARALLEL + _ROW_PARALLEL),
                  None)
    if module in _COL_PARALLEL and kind in ("weight", "bias"):
        return 0
    if module in _ROW_PARALLEL and kind == "weight":
        return 1
    return None


def tower_partition_specs(module: nn.Module) -> Dict[str, Optional[int]]:
    """Each parameter's name -> the dim split over the "model" axis, or
    None where it is replicated (JAX's PartitionSpec tree, module
    docstring)."""
    return {name: _split_dim(name) for name, _ in module.named_parameters()}


class RowParallelLinear(nn.Module):
    """out_proj / fc2 on this rank's slice of the input features: the
    partial product summed over the "model" group in fp32, then the
    replicated bias once, in the input's dtype."""

    def __init__(self, linear: nn.Linear, lo: int, hi: int, group_mesh):
        super().__init__()
        self.weight = nn.Parameter(linear.weight.detach()[:, lo:hi].clone(),
                                   requires_grad=False)
        self.bias = linear.bias
        self.group_mesh = group_mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        total = all_reduce_sum(F.linear(x, self.weight).float(), self.group_mesh)
        if self.bias is not None:
            total = total + self.bias.float()
        return total.to(x.dtype)


def _keep_rows(linear: nn.Linear, lo: int, hi: int) -> None:
    """A column-parallel linear: this rank's output features only."""
    linear.weight = nn.Parameter(linear.weight.detach()[lo:hi].clone(),
                                 requires_grad=False)
    if linear.bias is not None:
        linear.bias = nn.Parameter(linear.bias.detach()[lo:hi].clone(),
                                   requires_grad=False)
    linear.out_features = hi - lo


def _block(n: int, rank: int, m: int, what: str):
    if n % m:
        raise ValueError(f"tensor parallelism over {m} ranks needs {what} divisible "
                         f"by {m}, got {n}")
    return rank * n // m, (rank + 1) * n // m


def shard_tower_params(module: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Split `module` (a tower holding the full weights) in place over the
    mesh's `axis` by the rule table, keeping this rank's slices; each
    split attention runs on H/m heads. Returns the module, marked with
    `tensor_parallel = (axis, m)`. Sublayers of the kernel lanes stay
    whole (module docstring)."""
    from bayesvlm_tpu_torch.models.layers import MLP, MultiHeadAttention

    group = mesh[axis] if mesh.ndim > 1 else mesh
    m, rank = mesh_size(group), int(group.get_local_rank())
    for sub in list(module.modules()):
        if isinstance(sub, MultiHeadAttention):
            if sub.use_pallas_block or sub.use_int8_proj or m == 1:
                continue
            D = sub.q_proj.in_features
            lo, hi = _block(D, rank, m, "the width")
            _block(sub.num_heads, rank, m, "the head count")
            for proj in (sub.q_proj, sub.k_proj, sub.v_proj):
                _keep_rows(proj, lo, hi)
            sub.out_proj = RowParallelLinear(sub.out_proj, lo, hi, group)
            sub.num_heads //= m
        elif isinstance(sub, MLP):
            if sub.use_int8 or m == 1:
                continue
            lo, hi = _block(sub.fc1.out_features, rank, m, "the MLP width")
            _keep_rows(sub.fc1, lo, hi)
            sub.fc2 = RowParallelLinear(sub.fc2, lo, hi, group)
    module.tensor_parallel = (axis, m)
    return module


def all_reduce_mean(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The mean of t over the mesh's `axis` (the data-parallel average of a
    gradient or a loss, each rank's over its own equal block of rows)."""
    group = mesh[axis] if mesh.ndim > 1 else mesh
    return all_reduce_sum(t, group) / mesh_size(group)
