"""Partial-backbone fine-tuning: train the projection plus the last k
transformer layers of a tower and freeze everything else, the
counterpart of `bayesvlm_tpu.train.backbone` (the reference's
`enable_gradients(k_last_layers, enable_projection)`,
ref:bayesvlm/vlm.py:264-277,348-361,537-550).

The JAX package masks the gradients of its scan-stacked [L, ...] leaves
and writes the frozen slices back after each AdamW update. Here the
layers are modules of their own, so only the trainable parameters
require a gradient and sit in the optimizer: every frozen parameter is
left bit for bit as it was, with no mask and no write-back.

The optimizer is `torch.optim.AdamW` with optax's `adamw` defaults (b1
0.9, b2 0.999, eps 1e-8, decoupled decay). Parameters train in the
dtype `load_model` leaves them in (the GEMM weights in the compute
dtype, as the JAX package's `cast_gemm_params`); there is no fp32 master
copy, as in JAX. On the card the gradient passes through the attention
kernel (its backward is the plain version's, models/attention.py); the
int8 and block lanes' kernels have no backward, so a tower built with
them is refused. Towers built with `remat=True` recompute each block's
forward in the backward (models/layers.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn


def trainable_parameters(
    module: nn.Module,
    num_layers: int,
    k_last_layers: int,
    projection_names: Tuple[str, ...],
    enable_projection: bool = True,
) -> Dict[str, nn.Parameter]:
    """Name -> parameter of what trains: those under a module named in
    `projection_names` (if `enable_projection`) and those of
    `encoder.layers[num_layers - k_last_layers:]` (JAX's
    `trainable_mask_fns`)."""
    cutoff = num_layers - k_last_layers
    out = {}
    for name, param in module.named_parameters():
        parts = name.split(".")
        if any(p in parts for p in projection_names):
            if enable_projection:
                out[name] = param
        elif (k_last_layers > 0 and parts[:2] == ["encoder", "layers"]
              and int(parts[2]) >= cutoff):
            out[name] = param
    return out


def _refuse_kernel_lanes(module: nn.Module) -> None:
    from bayesvlm_tpu_torch.models.layers import MLP, MultiHeadAttention

    if getattr(module, "tensor_parallel", None):
        raise ValueError(
            "the backbone fine-tune cannot train a tensor-parallel (TP) tower "
            "(dist.tp.shard_tower_params): a backward through its split sublayers "
            "is not ported; TP covers the forward and the projection's gradient")

    lanes = sorted({lane for m in module.modules() for lane, on in (
        ("mlp_int8", isinstance(m, MLP) and m.use_int8),
        ("attn_int8", isinstance(m, MultiHeadAttention) and m.use_int8_proj),
        ("attn_pallas_block", isinstance(m, MultiHeadAttention) and m.use_pallas_block),
    ) if on})
    if lanes:
        raise ValueError(
            f"the backbone fine-tune cannot train a tower built with {lanes}: those "
            "lanes' kernels (mlp_int8, linear_int8, fused_attention_block) have no "
            "backward, nor in the JAX package; rebuild the tower without them "
            "(encoders.rebuild_image_encoder(enc, mlp_int8=False, attn_int8=False, "
            "attn_pallas_block=False))")


def make_backbone_train_step(
    module: nn.Module,
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    num_layers: int,
    k_last_layers: int,
    projection_names: Tuple[str, ...],
    learning_rate: float = 1e-5,
    weight_decay: float = 5e-2,
    enable_projection: bool = True,
):
    """Build (init_state, step) for `module`, trained in place.

    `init_state()` makes the trainable parameters (trainable_parameters)
    the only ones requiring a gradient and returns the AdamW optimizer
    over them. `step(batch)` takes `loss_fn(module, batch)` (a scalar),
    its gradient and one AdamW update, and returns the loss (detached).
    After a step each trainable parameter's `.grad` holds that step's
    gradient. A tower built with the int8 or block lanes is refused here,
    before any step."""
    _refuse_kernel_lanes(module)
    params = trainable_parameters(module, num_layers, k_last_layers, projection_names,
                                  enable_projection)
    state = {}

    def init_state() -> torch.optim.AdamW:
        module.requires_grad_(False)
        for p in params.values():
            p.requires_grad_(True)
        state["opt"] = torch.optim.AdamW(
            list(params.values()), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay)
        return state["opt"]

    def step(batch) -> torch.Tensor:
        if "opt" not in state:
            raise RuntimeError("call init_state() before the first step")
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(module, batch)
            loss.backward()
        opt.step()
        return loss.detach()

    return init_state, step
