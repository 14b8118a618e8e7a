"""Image transforms in PIL + NumPy (no torchvision dependency), the port's
copy of `bayesvlm_tpu.data.transforms`: the float lanes and the uint8
ingest lane.

Numerics mirror ref:bayesvlm/data/common.py:
  - CLIP ("default") transform: Resize(shorter side, bicubic) -> CenterCrop
    -> RGB -> scale to [0,1] -> Normalize(CLIP mean/std)
    (ref:data/common.py:68-76)
  - SigLIP transform: square Resize (bicubic) -> RGB -> Normalize with
    IMAGENET_STANDARD (0.5, 0.5) (ref:data/common.py:88-94)

Output layout is NHWC float32, as in the JAX package; the collate layer
stacks to [B, H, W, 3] and the image encoder takes it as it is. The
`*_uint8` transforms do the geometry only and return [H, W, 3] uint8:
the encoder normalises those on the device (models/encoders.py), so a
batch crosses to the card in a quarter of the bytes. PIL is
imported inside each transform, so the package imports on a machine
without it.
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


def corruption_transform(image_size: int, std: float, seed: int = 0) -> Callable:
    """CLIP chain + clamped Gaussian noise (ref:data/common.py:78-86).

    The noise is keyed on (seed, image content), not drawn from a shared
    generator, so identical seeds give identical corrupted inputs whatever
    the decode order or thread count (the reference seeds a global torch
    RNG, so only its statistics are matched)."""
    import zlib

    def _apply(img) -> np.ndarray:
        img = _resize_shorter(img, image_size)
        img = _center_crop(img, image_size)
        img = img.convert("RGB")
        arr = _to_float_array(img)
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, zlib.crc32(arr.tobytes())]))
        arr = np.clip(arr + rng.normal(0.0, std, arr.shape).astype(np.float32), 0.0, 1.0)
        return _normalize(arr, *NORMALIZATION_BY_FAMILY["clip"])

    return _apply


def revert_normalization(arr: np.ndarray) -> np.ndarray:
    """ref:data/common.py:48-56 (NHWC layout)."""
    return arr * np.asarray(DEFAULT_STD, np.float32) + np.asarray(DEFAULT_MEAN, np.float32)


def revert_siglip_normalization(arr: np.ndarray) -> np.ndarray:
    """The reference uses MEAN where STD belongs (ref:data/common.py:58-66);
    MEAN == STD == 0.5 for IMAGENET_STANDARD, so the correct formula here
    gives the same output."""
    return arr * np.asarray(IMAGENET_STANDARD_STD, np.float32) + np.asarray(
        IMAGENET_STANDARD_MEAN, np.float32)


def default_transform_uint8(image_size: int) -> Callable:
    """CLIP geometry only: resize -> crop -> RGB -> [H, W, 3] uint8. The
    /255 and mean / std run on the device (ImageEncoder takes uint8)."""

    def _apply(img) -> np.ndarray:
        img = _resize_shorter(img, image_size)
        img = _center_crop(img, image_size)
        img = img.convert("RGB")
        return np.asarray(img, dtype=np.uint8)

    return _apply


def siglip_transform_uint8(image_size: int) -> Callable:
    """SigLIP geometry only (square resize); normalised on the device."""

    def _apply(img) -> np.ndarray:
        from PIL import Image

        img = img.resize((image_size, image_size), Image.BICUBIC)
        img = img.convert("RGB")
        return np.asarray(img, dtype=np.uint8)

    return _apply


def get_transform(model_type: str, image_size: int) -> Callable:
    """ref:bayesvlm/utils.py:18-21."""
    if model_type == "siglip":
        return siglip_transform(image_size)
    return default_transform(image_size)


def get_transform_uint8(model_type: str, image_size: int) -> Callable:
    """The uint8 (device-normalised) variant of get_transform."""
    if model_type == "siglip":
        return siglip_transform_uint8(image_size)
    return default_transform_uint8(image_size)
