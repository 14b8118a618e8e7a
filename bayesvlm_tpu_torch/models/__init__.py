"""CLIP towers, the attention kernel and model loading."""

from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from bayesvlm_tpu_torch.models.encoders import (
    ImageEncoder,
    TextEncoder,
    load_model,
)

__all__ = ["CONFIGS_BY_NAME", "ImageEncoder", "TextEncoder", "load_model"]
