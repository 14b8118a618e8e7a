"""Glue helpers mirroring ref:bayesvlm/utils.py (and bayesvlm_tpu.utils)."""

from __future__ import annotations

# name -> (provider, hf model id, image size), identical to
# bayesvlm_tpu.constants.MODEL_NAME_MAP (ref:bayesvlm/constants.py:1-6),
# including the reference's 265 for SigLIP: it is the size its
# transform resizes to before the center crop.
MODEL_NAME_MAP = {
    "clip-base": ("laion", "CLIP-ViT-B-32-laion2B-s34B-b79K", 224),
    "clip-large": ("laion", "CLIP-ViT-L-14-laion2B-s32B-b82K", 224),
    "clip-huge": ("laion", "CLIP-ViT-H-14-laion2B-s32B-b79K", 224),
    "siglip-base": ("google", "siglip-base-patch16-256", 265),
    "siglip-large": ("google", "siglip-large-patch16-256", 265),
    # test-only tiny configs (no HF counterpart)
    "tiny-clip": (None, None, 32),
    "tiny-siglip": (None, None, 32),
}


def get_image_size(model_str: str) -> int:
    _, _, size = MODEL_NAME_MAP[model_str]
    return size
