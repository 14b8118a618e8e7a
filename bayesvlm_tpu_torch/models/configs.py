"""Model configurations for the supported CLIP / SigLIP families.

Sizes mirror the checkpoints the reference supports
(ref:bayesvlm/constants.py:1-6, ref:bayesvlm/vlm.py:21-25), and are the
same as `bayesvlm_tpu.models.configs`:

  clip-base   laion/CLIP-ViT-B-32-laion2B-s34B-b79K   proj 512, img 224
  clip-large  laion/CLIP-ViT-L-14-laion2B-s32B-b82K   proj 768, img 224
  clip-huge   laion/CLIP-ViT-H-14-laion2B-s32B-b79K   proj 1024, img 224
  siglip-base google/siglip-base-patch16-256          proj 768, img 256
  siglip-large google/siglip-large-patch16-256        proj 1024, img 256

TINY_* configs are CPU-runnable shapes for tests.

Of the JAX package's per-kernel switches, the W8A8 int8 lanes are
carried over (`mlp_int8`, `attn_int8`, `mlp_weight_bits`; vision towers
only, off by default), and so is `attn_pallas_block`, the whole-sublayer
attention kernel (off by default; on a causal tower it changes nothing,
as in JAX). `attn_pallas` is not: the port routes non-causal attention
to its kernel from the tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int
    patch_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    mlp_dim: int
    projection_dim: int
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    use_class_token: bool = True       # CLIP: CLS token; SigLIP: none
    # W8A8 int8 MLP sublayers (models/mlp_int8.py, fused pre-LN variant);
    # approximate, opt-in
    mlp_int8: bool = False
    # weight width of the int8 MLP kernel: 8 (W8A8) or 4 (W4A8, +-7)
    mlp_weight_bits: int = 8
    # W8A8 int8 attention projections (models/linear_int8.py, fused QKV);
    # non-causal self-attention only; approximate, opt-in
    attn_int8: bool = False
    # the whole pre-LN attention sublayer x + out_proj(MHA(LN(x))) in one
    # kernel chain (models/attention.py fused_attention_block); opt-in,
    # and it takes precedence over attn_int8
    attn_pallas_block: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_class_token else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int
    max_length: int
    hidden_size: int
    num_layers: int
    num_heads: int
    mlp_dim: int
    projection_dim: int
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    causal: bool = True                # CLIP: causal; SigLIP: bidirectional
    eos_token_id: int = 49407
    attn_pallas_block: bool = False    # see VisionConfig (no effect when causal)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    family: Literal["clip", "siglip"]
    vision: VisionConfig
    text: TextConfig
    # hf ids for weight conversion (provider/model, ref:bayesvlm/constants.py)
    hf_id: Optional[str] = None
    name: Optional[str] = None

    @property
    def projection_has_bias(self) -> bool:
        return self.family == "siglip"


CLIP_B32_CONFIG = VLMConfig(
    family="clip",
    name="clip-base",
    hf_id="laion/CLIP-ViT-B-32-laion2B-s34B-b79K",
    vision=VisionConfig(
        image_size=224, patch_size=32, hidden_size=768, num_layers=12,
        num_heads=12, mlp_dim=3072, projection_dim=512,
    ),
    text=TextConfig(
        vocab_size=49408, max_length=77, hidden_size=512, num_layers=12,
        num_heads=8, mlp_dim=2048, projection_dim=512,
    ),
)

CLIP_L14_CONFIG = VLMConfig(
    family="clip",
    name="clip-large",
    hf_id="laion/CLIP-ViT-L-14-laion2B-s32B-b82K",
    vision=VisionConfig(
        image_size=224, patch_size=14, hidden_size=1024, num_layers=24,
        num_heads=16, mlp_dim=4096, projection_dim=768,
    ),
    text=TextConfig(
        vocab_size=49408, max_length=77, hidden_size=768, num_layers=12,
        num_heads=12, mlp_dim=3072, projection_dim=768,
    ),
)

CLIP_H14_CONFIG = VLMConfig(
    family="clip",
    name="clip-huge",
    hf_id="laion/CLIP-ViT-H-14-laion2B-s32B-b79K",
    vision=VisionConfig(
        image_size=224, patch_size=14, hidden_size=1280, num_layers=32,
        num_heads=16, mlp_dim=5120, projection_dim=1024,
    ),
    text=TextConfig(
        vocab_size=49408, max_length=77, hidden_size=1024, num_layers=24,
        num_heads=16, mlp_dim=4096, projection_dim=1024,
    ),
)

SIGLIP_BASE_CONFIG = VLMConfig(
    family="siglip",
    name="siglip-base",
    hf_id="google/siglip-base-patch16-256",
    vision=VisionConfig(
        image_size=256, patch_size=16, hidden_size=768, num_layers=12,
        num_heads=12, mlp_dim=3072, projection_dim=768,
        hidden_act="gelu_tanh", layer_norm_eps=1e-6, use_class_token=False,
    ),
    text=TextConfig(
        vocab_size=32000, max_length=64, hidden_size=768, num_layers=12,
        num_heads=12, mlp_dim=3072, projection_dim=768,
        hidden_act="gelu_tanh", layer_norm_eps=1e-6, causal=False,
        eos_token_id=1,
    ),
)

SIGLIP_LARGE_CONFIG = VLMConfig(
    family="siglip",
    name="siglip-large",
    hf_id="google/siglip-large-patch16-256",
    vision=VisionConfig(
        image_size=256, patch_size=16, hidden_size=1024, num_layers=24,
        num_heads=16, mlp_dim=4096, projection_dim=1024,
        hidden_act="gelu_tanh", layer_norm_eps=1e-6, use_class_token=False,
    ),
    text=TextConfig(
        vocab_size=32000, max_length=64, hidden_size=1024, num_layers=24,
        num_heads=16, mlp_dim=4096, projection_dim=1024,
        hidden_act="gelu_tanh", layer_norm_eps=1e-6, causal=False,
        eos_token_id=1,
    ),
)

TINY_CLIP_CONFIG = VLMConfig(
    family="clip",
    name="tiny-clip",
    vision=VisionConfig(
        image_size=32, patch_size=8, hidden_size=32, num_layers=2,
        num_heads=2, mlp_dim=64, projection_dim=16,
    ),
    text=TextConfig(
        vocab_size=64, max_length=16, hidden_size=24, num_layers=2,
        num_heads=2, mlp_dim=48, projection_dim=16, eos_token_id=63,
    ),
)

TINY_SIGLIP_CONFIG = VLMConfig(
    family="siglip",
    name="tiny-siglip",
    vision=VisionConfig(
        image_size=32, patch_size=8, hidden_size=32, num_layers=2,
        num_heads=2, mlp_dim=64, projection_dim=32,
        hidden_act="gelu_tanh", layer_norm_eps=1e-6, use_class_token=False,
    ),
    text=TextConfig(
        vocab_size=64, max_length=16, hidden_size=32, num_layers=2,
        num_heads=2, mlp_dim=64, projection_dim=32,
        hidden_act="gelu_tanh", layer_norm_eps=1e-6, causal=False,
        eos_token_id=1,
    ),
)

CONFIGS_BY_NAME = {
    c.name: c
    for c in [
        CLIP_B32_CONFIG,
        CLIP_L14_CONFIG,
        CLIP_H14_CONFIG,
        SIGLIP_BASE_CONFIG,
        SIGLIP_LARGE_CONFIG,
        TINY_CLIP_CONFIG,
        TINY_SIGLIP_CONFIG,
    ]
}
