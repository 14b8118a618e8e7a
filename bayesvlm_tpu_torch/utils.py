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


def get_likelihood(model_type: str) -> str:
    """'clip' -> info_nce, anything else -> siglip
    (ref:bayesvlm/utils.py:23-26). A full model name ('tiny-siglip',
    'clip-base') resolves through its family; a bare 'tiny' is ambiguous
    (tiny-clip vs tiny-siglip) and raises."""
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    if model_type in CONFIGS_BY_NAME:
        return get_likelihood_for_model(model_type)
    if model_type == "tiny":
        raise ValueError(
            "'tiny' is ambiguous (tiny-clip vs tiny-siglip); pass the full "
            "model name or use get_likelihood_for_model()"
        )
    return "info_nce" if model_type == "clip" else "siglip"


def get_likelihood_for_model(model_str: str) -> str:
    """The contrastive likelihood of a model name's family."""
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    family = CONFIGS_BY_NAME[model_str].family
    return "info_nce" if family == "clip" else "siglip"
