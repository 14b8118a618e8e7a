"""Image transforms in PIL + NumPy (no torchvision dependency), the port's
copy of the float lanes of `bayesvlm_tpu.data.transforms`.

Numerics mirror ref:bayesvlm/data/common.py:
  - CLIP ("default") transform: Resize(shorter side, bicubic) -> CenterCrop
    -> RGB -> scale to [0,1] -> Normalize(CLIP mean/std)
    (ref:data/common.py:68-76)
  - SigLIP transform: square Resize (bicubic) -> RGB -> Normalize with
    IMAGENET_STANDARD (0.5, 0.5) (ref:data/common.py:88-94)

Output layout is NHWC float32, as in the JAX package; the collate layer
stacks to [B, H, W, 3] and the image encoder takes it as it is. PIL is
imported inside each transform, so the package imports on a machine
without it. The uint8 lanes (`*_uint8`, normalisation on the device)
are not ported.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

DEFAULT_MEAN = (0.48145466, 0.4578275, 0.40821073)
DEFAULT_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_STANDARD_MEAN = (0.5, 0.5, 0.5)
IMAGENET_STANDARD_STD = (0.5, 0.5, 0.5)

NORMALIZATION_BY_FAMILY = {
    "clip": (DEFAULT_MEAN, DEFAULT_STD),
    "siglip": (IMAGENET_STANDARD_MEAN, IMAGENET_STANDARD_STD),
}


def _resize_shorter(img, size: int):
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def _center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _to_float_array(img) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def default_transform(image_size: int) -> Callable:
    """CLIP transform (ref:data/common.py:68-76). PIL -> [H, W, 3] fp32."""

    def _apply(img) -> np.ndarray:
        img = _resize_shorter(img, image_size)
        img = _center_crop(img, image_size)
        img = img.convert("RGB")
        return _normalize(_to_float_array(img), *NORMALIZATION_BY_FAMILY["clip"])

    return _apply


def siglip_transform(image_size: int) -> Callable:
    """SigLIP transform (ref:data/common.py:88-94)."""

    def _apply(img) -> np.ndarray:
        from PIL import Image

        img = img.resize((image_size, image_size), Image.BICUBIC)
        img = img.convert("RGB")
        return _normalize(_to_float_array(img), *NORMALIZATION_BY_FAMILY["siglip"])

    return _apply


def get_transform(model_type: str, image_size: int) -> Callable:
    """ref:bayesvlm/utils.py:18-21."""
    if model_type == "siglip":
        return siglip_transform(image_size)
    return default_transform(image_size)
