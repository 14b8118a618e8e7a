"""CLIP vision and text towers, counterparts of `bayesvlm_tpu.models.clip`.

Behavioural contract (what the Laplace layer needs, ref:bayesvlm/vlm.py):
  - vision: activations = post_layernorm(CLS hidden)   (pooled output)
            embeds      = visual_projection(activations), Linear, no bias
  - text:   activations = final_layer_norm hidden at the EOS position
            embeds      = text_projection(activations), Linear, no bias
Post-LN and projection run in fp32 whatever the compute dtype
(`dtype`); parameter names follow the HF checkpoints.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bayesvlm_tpu_torch.models.configs import TextConfig, VisionConfig
from bayesvlm_tpu_torch.models.layers import (
    LayerNormFP32,
    build_encoder,
    causal_mask,
)


def patchify(pixels: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)(W/p), C p p] row-major patches, laid out
    as a flattened OIHW conv weight's input dims. Rows and columns past
    the last whole patch are dropped, as a VALID conv drops them (the
    SigLIP transform's 265 px images)."""
    B, Hi, Wi, C = pixels.shape
    Hi, Wi = Hi // p * p, Wi // p * p
    pixels = pixels[:, :Hi, :Wi]
    return (pixels.reshape(B, Hi // p, p, Wi // p, p, C)
            .permute(0, 1, 3, 5, 2, 4)            # [B, gh, gw, C, p, p]
            .reshape(B, (Hi // p) * (Wi // p), C * p * p))


class CLIPVisionTower(nn.Module):
    def __init__(self, config: VisionConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        D, p = config.hidden_size, config.patch_size
        # OIHW conv weight; applied as a matmul over flattened patches so
        # that fp32 towers never meet cuDNN's default TF32 convolutions
        self.patch_embedding = nn.Conv2d(3, D, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.position_embedding = nn.Parameter(torch.zeros(config.seq_len, D))
        self.pre_layernorm = LayerNormFP32(D, config.layer_norm_eps)
        # the int8 lanes reach the vision encoder only, as in the JAX
        # package (its load_model replaces config.vision alone)
        self.encoder = build_encoder(config, attn_kernel=True, remat=remat,
                                     mlp_int8=config.mlp_int8,
                                     attn_int8=config.attn_int8,
                                     mlp_weight_bits=config.mlp_weight_bits)
        self.post_layernorm = LayerNormFP32(D, config.layer_norm_eps)
        self.visual_projection = nn.Linear(D, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor):
        """pixel_values [B, H, W, 3] (NHWC, normalized).

        Returns (embeds [B, proj] fp32, activations [B, D] fp32)."""
        B = pixel_values.shape[0]
        patches = patchify(pixel_values.to(self.dtype), self.config.patch_size)
        w = self.patch_embedding.weight.to(self.dtype).flatten(1)
        patches = F.linear(patches, w)
        cls = self.class_embedding.to(self.dtype).expand(B, 1, -1)
        h = torch.cat([cls, patches], dim=1)
        h = h + self.position_embedding.to(self.dtype)[None]
        h = self.pre_layernorm(h)
        h = self.encoder(h)
        activations = self.post_layernorm(h[:, 0, :].float())
        embeds = self.visual_projection(activations)
        return embeds, activations


class CLIPTextTower(nn.Module):
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
        self.text_projection = nn.Linear(D, config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor):
        """input_ids [B, T] integer; pools at the first EOS token of each
        row (HF: argmax(input_ids == eos_token_id)).

        Returns (embeds [B, proj] fp32, activations [B, D] fp32)."""
        cfg = self.config
        B, T = input_ids.shape
        h = self.token_embedding(input_ids).to(self.dtype)
        h = h + self.position_embedding[:T].to(self.dtype)[None]
        mask = causal_mask(T, h.device) if cfg.causal else None
        h = self.encoder(h, mask)
        h = self.final_layer_norm(h.float())
        eos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        activations = h[torch.arange(B, device=h.device), eos]
        embeds = self.text_projection(activations)
        return embeds, activations
