"""Shared transformer building blocks for the CLIP towers.

Counterpart of `bayesvlm_tpu.models.layers`, with its numerics contract:
  - parameters are stored in fp32; `cast_gemm_params` (encoders.py)
    puts the q/k/v/out/fc1/fc2 weights in the compute dtype;
  - layer norms and the attention softmax run in fp32 whatever the
    compute dtype;
  - bf16 towers swap erf-GELU for tanh-GELU (layers.py:250-255 of the
    JAX package: the approximation's error is below bf16 rounding);
  - non-causal, unmasked self-attention goes to the fused kernel
    (models/attention.py); the causal text path stays plain torch
    (matmul, additive mask, fp32 softmax), as the JAX einsum path does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bayesvlm_tpu_torch.models.attention import fused_attention


def get_activation(name: str):
    """The activations the configs name: exact erf-GELU ("gelu") and its
    tanh approximation ("gelu_tanh")."""
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation: {name}")


class LayerNormFP32(nn.Module):
    """LayerNorm computed in fp32 with fp32 parameters; the output has
    the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections (HF layout)."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, D] in the compute dtype; mask [T, T] additive."""
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if mask is None:
            return self.out_proj(fused_attention(q, k, v, self.num_heads))
        B, T, D = q.shape
        H = self.num_heads
        Dh = D // H
        q, k, v = (t.reshape(B, T, H, Dh).transpose(1, 2) for t in (q, k, v))
        # scores in the compute dtype, divided there, then fp32 — the
        # order of the JAX einsum path (layers.py:193-198)
        scores = (q @ k.transpose(-1, -2)) / torch.tensor(
            math.sqrt(Dh), dtype=q.dtype, device=q.device)
        scores = scores.float() + mask.float()
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (probs @ v).transpose(1, 2).reshape(B, T, D)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, hidden_act: str):
        super().__init__()
        self.hidden_act = hidden_act
        self.fc1 = nn.Linear(hidden_size, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.hidden_act
        if act == "gelu" and x.dtype == torch.bfloat16:
            act = "gelu_tanh"
        return self.fc2(get_activation(act)(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHA(LN1(x)); x + MLP(LN2(x))."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 hidden_act: str, layer_norm_eps: float):
        super().__init__()
        self.layer_norm1 = LayerNormFP32(hidden_size, layer_norm_eps)
        self.self_attn = MultiHeadAttention(hidden_size, num_heads)
        self.layer_norm2 = LayerNormFP32(hidden_size, layer_norm_eps)
        self.mlp = MLP(hidden_size, mlp_dim, hidden_act)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class TransformerEncoder(nn.Module):
    """Stack of pre-LN blocks, run as a loop over `layers` (the JAX
    package scans one block over [L, ...]-stacked parameters; the weight
    bridge unstacks them)."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 mlp_dim: int, hidden_act: str, layer_norm_eps: float):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(hidden_size, num_heads, mlp_dim, hidden_act,
                             layer_norm_eps)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Additive causal mask [T, T]: 0 on/below the diagonal, the fp32
    minimum above (as `bayesvlm_tpu.models.layers.causal_mask`)."""
    i = torch.arange(seq_len, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0,
                       torch.finfo(torch.float32).min).to(torch.float32)
