"""SigLIP vision and text towers, counterparts of `bayesvlm_tpu.models.siglip`,
with the attention-pool "head surgery" the Laplace layer requires.

The reference splits the SigLIP vision attention-pool head mid-MLP
(ref:bayesvlm/vlm.py:460-486,552-565):

    attn_out  = MHA(probe, tokens, tokens)            # pre-layernorm
    residual  = attn_out[:, 0]                        # the skip connection
    h         = layernorm(attn_out)
    act       = gelu_tanh(fc1(h))[:, 0]               # -> `activations`
    embeds    = fc2(act) + residual                   # Laplace layer = fc2

so the Bayesian projection layer is `head_fc2` (Linear with a bias: a
ones column in the K-FAC A factor) and the skip is re-added after any
projection update, hence `EncoderResult.residuals`. The head's LN, fc1
and fc2 run in fp32; the probe attention in the compute dtype, on the
plain path (one query over the patch tokens).

Text tower: bidirectional, pooled at the LAST token of the max-length
padded sequence (ref:bayesvlm/vlm.py:447-451); projection `head`
(Linear with a bias). It takes the plain attention path, as the JAX
package's text towers do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bayesvlm_tpu_torch.models.clip import patchify
from bayesvlm_tpu_torch.models.configs import TextConfig, VisionConfig
from bayesvlm_tpu_torch.models.layers import (
    LayerNormFP32,
    MultiHeadAttention,
    build_encoder,
    get_activation,
)


class SiglipVisionTower(nn.Module):
    def __init__(self, config: VisionConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        D, p = config.hidden_size, config.patch_size
        # OIHW conv weight with a bias, applied as a matmul over flattened
        # patches (no cuDNN TF32 convolution for fp32 towers)
        self.patch_embedding = nn.Conv2d(3, D, p, stride=p, bias=True)
        self.position_embedding = nn.Parameter(torch.zeros(config.num_patches, D))
        self.encoder = build_encoder(config, attn_kernel=True, remat=remat,
                                     mlp_int8=config.mlp_int8,
                                     attn_int8=config.attn_int8,
                                     mlp_weight_bits=config.mlp_weight_bits)
        self.post_layernorm = LayerNormFP32(D, config.layer_norm_eps)
        self.probe = nn.Parameter(torch.zeros(1, 1, D))
        self.head_attention = MultiHeadAttention(D, config.num_heads)
        self.head_layernorm = LayerNormFP32(D, config.layer_norm_eps)
        self.head_fc1 = nn.Linear(D, config.mlp_dim)
        self.head_fc2 = nn.Linear(config.mlp_dim, D)

    def forward(self, pixel_values: torch.Tensor):
        """pixel_values [B, H, W, 3] (NHWC, normalized).

        Returns (embeds [B, D], activations [B, mlp_dim], residuals [B, D]),
        fp32; embeds = head_fc2(activations) + residuals."""
        B = pixel_values.shape[0]
        patches = patchify(pixel_values.to(self.dtype), self.config.patch_size)
        w = self.patch_embedding.weight.to(self.dtype).flatten(1)
        h = F.linear(patches, w, self.patch_embedding.bias.to(self.dtype))
        h = h + self.position_embedding.to(self.dtype)[None]
        h = self.encoder(h)
        h = self.post_layernorm(h)
        probe = self.probe.to(self.dtype).expand(B, 1, -1)
        attn_out = self.head_attention(probe, keys_values=h)     # [B, 1, D]
        residuals = attn_out[:, 0, :].float()
        hn = self.head_layernorm(attn_out.float())
        act = get_activation(self.config.hidden_act)
        activations = act(self.head_fc1(hn))[:, 0, :]
        embeds = self.head_fc2(activations) + residuals
        return embeds, activations, residuals


class SiglipTextTower(nn.Module):
    def __init__(self, config: TextConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        D = config.hidden_size
        self.token_embedding = nn.Embedding(config.vocab_size, D)
        self.position_embedding = nn.Parameter(torch.zeros(config.max_length, D))
        self.encoder = build_encoder(config, attn_kernel=False, remat=remat)
        self.final_layer_norm = LayerNormFP32(D, config.layer_norm_eps)
        self.head = nn.Linear(D, config.projection_dim)

    def forward(self, input_ids: torch.Tensor):
        """input_ids [B, T] integer, padded to max_length (the SigLIP
        convention). Returns (embeds [B, proj], activations [B, D]), fp32."""
        T = input_ids.shape[1]
        h = self.token_embedding(input_ids).to(self.dtype)
        h = h + self.position_embedding[:T].to(self.dtype)[None]
        h = self.encoder(h)  # bidirectional
        h = self.final_layer_norm(h.float())
        activations = h[:, -1, :]
        return self.head(activations), activations
