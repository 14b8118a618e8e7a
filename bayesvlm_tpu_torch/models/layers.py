"""Shared transformer building blocks for the CLIP towers.

Counterpart of `bayesvlm_tpu.models.layers`, with its numerics contract:
  - parameters are stored in fp32; `cast_gemm_params` (encoders.py)
    puts the q/k/v/out/fc1/fc2 weights in the compute dtype;
  - layer norms and the attention softmax run in fp32 whatever the
    compute dtype;
  - bf16 towers swap erf-GELU for tanh-GELU (layers.py:250-255 of the
    JAX package: the approximation's error is below bf16 rounding);
  - unmasked self-attention in a tower built with `attn_kernel` (the
    vision towers) goes to the fused kernel (models/attention.py), as the
    JAX package's vision towers take its Pallas kernel on a TPU; masked
    attention (causal CLIP text), the bidirectional SigLIP text tower and
    cross-attention (the SigLIP probe: one query over the patch tokens)
    stay plain torch (matmul, additive mask, fp32 softmax), as the JAX
    einsum path does;
  - the opt-in W8A8 lanes (vision towers only): `MLP(use_int8)` runs
    the whole pre-LN MLP sublayer through models/mlp_int8.py, and
    `MultiHeadAttention(use_int8_proj)` the fused QKV and out
    projections through models/linear_int8.py. Parameters are the same
    either way; the int8 weight cache is a set of non-persistent buffers;
  - the opt-in block lane (`attn_pallas_block`): on unmasked
    self-attention, `MultiHeadAttention(use_pallas_block)` runs the whole
    pre-LN sublayer x + out_proj(MHA(LN1(x))) through
    `fused_attention_block` (JAX layers.py:127-145, 294-304). It takes
    precedence over `use_int8_proj`, as in JAX; masked calls keep the
    per-op path. Parameters and state_dict keys are unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bayesvlm_tpu_torch.models.attention import (
    fused_attention,
    fused_attention_block,
)
from bayesvlm_tpu_torch.models.linear_int8 import linear_int8
from bayesvlm_tpu_torch.models.mlp_int8 import mlp_int8, quantize_mlp_weights


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
    """MHA with separate q/k/v/out projections (HF layout).

    `use_kernel`: unmasked self-attention runs in the fused attention
    kernel; elsewhere, and for cross-attention (`keys_values`), the plain
    path (JAX layers.py:170-175 guards its kernel the same way: the
    kernel tiles from q's length).

    `use_int8_proj`: on unmasked self-attention, the q/k/v weights are
    concatenated to [3D, D] so each input row is quantized once, one
    W8A8 product writes contiguous q, k, v, and the out-projection is a
    second W8A8 product (JAX layers.py:147-163). Masked calls keep the
    float projections.

    `use_pallas_block`: called on unmasked self-attention with `pre_ln`
    = (LN weight, LN bias, eps) and the PRE-LN x, returns the whole
    sublayer x + out_proj(MHA(LN(x))), residual included, from
    `fused_attention_block` (JAX layers.py:127-145)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 use_int8_proj: bool = False, use_pallas_block: bool = False,
                 use_kernel: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.use_int8_proj = use_int8_proj
        self.use_pallas_block = use_pallas_block
        self.use_kernel = use_kernel
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pre_ln: Optional[tuple] = None,
                keys_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, Tq, D] (the queries) in the compute dtype; keys_values
        [B, Tk, D] (None: self-attention); mask [Tq, Tk] additive."""
        self_attention = keys_values is None
        unmasked_self = mask is None and self_attention
        if self.use_pallas_block and unmasked_self and pre_ln is not None:
            ln_weight, ln_bias, ln_eps = pre_ln
            params = []
            for proj in (self.q_proj, self.k_proj, self.v_proj, self.out_proj):
                params += [proj.weight.to(x.dtype), proj.bias.to(x.dtype)]
            return fused_attention_block(x, ln_weight, ln_bias, *params,
                                         num_heads=self.num_heads, ln_eps=ln_eps)
        if unmasked_self and self.use_int8_proj:
            projs = (self.q_proj, self.k_proj, self.v_proj)
            q, k, v = linear_int8(x, torch.cat([p.weight for p in projs]),
                                  torch.cat([p.bias for p in projs]), chunks=3)
            o = fused_attention(q, k, v, self.num_heads)
            return linear_int8(o, self.out_proj.weight, self.out_proj.bias)
        kv = x if self_attention else keys_values
        q, k, v = self.q_proj(x), self.k_proj(kv), self.v_proj(kv)
        if unmasked_self and self.use_kernel:
            return self.out_proj(fused_attention(q, k, v, self.num_heads))
        B, Tq, D = q.shape
        Tk = k.shape[1]
        H = self.num_heads
        Dh = D // H
        q = q.reshape(B, Tq, H, Dh).transpose(1, 2)
        k, v = (t.reshape(B, Tk, H, Dh).transpose(1, 2) for t in (k, v))
        # scores in the compute dtype, divided there, then fp32 — the
        # order of the JAX einsum path (layers.py:193-198); the divisor is
        # filled on the device (no host copy, so a CUDA graph can capture
        # the SigLIP probe)
        scores = (q @ k.transpose(-1, -2)) / torch.full(
            (), math.sqrt(Dh), dtype=q.dtype, device=q.device)
        scores = scores.float()
        if mask is not None:
            scores = scores + mask.float()
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (probs @ v).transpose(1, 2).reshape(B, Tq, D)
        return self.out_proj(out)


class MLP(nn.Module):
    """fc2(act(fc1(x))). With `use_int8`, the W8A8 kernel, which with
    `pre_ln` runs the whole sublayer x + fc2(act(fc1(LN(x)))) and returns
    straight from the kernel (JAX layers.py:209-246)."""

    _CACHE = ("w1q", "s1", "w2q", "s2")

    def __init__(self, hidden_size: int, mlp_dim: int, hidden_act: str,
                 use_int8: bool = False, weight_bits: int = 8):
        super().__init__()
        self.hidden_act = hidden_act
        self.use_int8 = use_int8
        self.weight_bits = weight_bits
        self.fc1 = nn.Linear(hidden_size, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden_size)
        # the prequantized W8A8 weights (prequantize); not in state_dict
        for name in self._CACHE:
            self.register_buffer(name, None, persistent=False)

    def prequantize(self) -> None:
        """Quantize fc1/fc2 once into the cache buffers, so forwards skip
        the per-call weight quantization."""
        quant = quantize_mlp_weights(self.fc1.weight, self.fc2.weight,
                                     self.weight_bits)
        for name in self._CACHE:
            setattr(self, name, quant[name])

    def forward(self, x: torch.Tensor, pre_ln: Optional[tuple] = None) -> torch.Tensor:
        if self.use_int8:
            quant = (None if self.w1q is None
                     else {name: getattr(self, name) for name in self._CACHE})
            ln = {}
            if pre_ln is not None:
                ln = dict(zip(("ln_weight", "ln_bias", "ln_eps"), pre_ln))
            return mlp_int8(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                            self.fc2.bias, act_name=self.hidden_act,
                            quant=quant, weight_bits=self.weight_bits, **ln)
        if pre_ln is not None:
            raise ValueError("MLP(pre_ln=...) requires use_int8=True")
        act = self.hidden_act
        if act == "gelu" and x.dtype == torch.bfloat16:
            act = "gelu_tanh"
        return self.fc2(get_activation(act)(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHA(LN1(x)); x + MLP(LN2(x)). With
    `attn_pallas_block`, an unmasked call runs the first sublayer, LN1
    and residual included, in the block kernel."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 hidden_act: str, layer_norm_eps: float, mlp_int8: bool = False,
                 attn_int8: bool = False, mlp_weight_bits: int = 8,
                 attn_pallas_block: bool = False, attn_kernel: bool = True):
        super().__init__()
        self.layer_norm1 = LayerNormFP32(hidden_size, layer_norm_eps)
        self.self_attn = MultiHeadAttention(hidden_size, num_heads, attn_int8,
                                            attn_pallas_block, attn_kernel)
        self.layer_norm2 = LayerNormFP32(hidden_size, layer_norm_eps)
        self.mlp = MLP(hidden_size, mlp_dim, hidden_act, mlp_int8,
                       mlp_weight_bits)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.self_attn.use_pallas_block and mask is None:
            ln = self.layer_norm1
            x = self.self_attn(x, pre_ln=(ln.weight, ln.bias, ln.eps))
        else:
            x = x + self.self_attn(self.layer_norm1(x), mask)
        if self.mlp.use_int8:
            # LN2 + MLP + residual in the kernel, the residual added in
            # fp32 (the default path adds in the compute dtype)
            ln = self.layer_norm2
            return self.mlp(x, pre_ln=(ln.weight, ln.bias, ln.eps))
        return x + self.mlp(self.layer_norm2(x))


class TransformerEncoder(nn.Module):
    """Stack of pre-LN blocks, run as a loop over `layers` (the JAX
    package scans one block over [L, ...]-stacked parameters; the weight
    bridge unstacks them).

    `remat` (JAX layers.py:398-414, `nn.remat` of the scanned block):
    with grad mode on, each block runs under non-reentrant
    `torch.utils.checkpoint`, keeping its input and recomputing its
    forward in the backward (activation memory for compute, in
    fine-tuning). Under `no_grad` / `inference_mode` it changes nothing."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 mlp_dim: int, hidden_act: str, layer_norm_eps: float,
                 mlp_int8: bool = False, attn_int8: bool = False,
                 mlp_weight_bits: int = 8, attn_pallas_block: bool = False,
                 attn_kernel: bool = True, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerBlock(hidden_size, num_heads, mlp_dim, hidden_act,
                             layer_norm_eps, mlp_int8, attn_int8,
                             mlp_weight_bits, attn_pallas_block, attn_kernel)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, mask, use_reentrant=False)
            else:
                x = layer(x, mask)
        return x


def build_encoder(cfg, attn_kernel: bool, remat: bool = False,
                  **int8) -> TransformerEncoder:
    """A tower's encoder from its Vision- or TextConfig; `attn_kernel`
    for the vision towers, `remat` for fine-tuning, `int8`: the vision
    towers' W8A8 lane switches."""
    return TransformerEncoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                              cfg.mlp_dim, cfg.hidden_act, cfg.layer_norm_eps,
                              attn_pallas_block=cfg.attn_pallas_block,
                              attn_kernel=attn_kernel, remat=remat, **int8)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Additive causal mask [T, T]: 0 on/below the diagonal, the fp32
    minimum above (as `bayesvlm_tpu.models.layers.causal_mask`)."""
    i = torch.arange(seq_len, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0,
                       torch.finfo(torch.float32).min).to(torch.float32)
