"""High-level encoder objects: tower module + forward -> `EncoderResult`.

Counterparts of `bayesvlm_tpu.models.encoders` (and of the reference's
`CLIPImageEncoder` / `CLIPTextEncoder`, ref:bayesvlm/vlm.py). The
projection layer (the Laplace layer) enters the Bayesian chain through
`projection_l2` / `projection_num_params`.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from bayesvlm_tpu_torch.models.clip import CLIPTextTower, CLIPVisionTower
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME, VLMConfig
from bayesvlm_tpu_torch.models.layers import MLP
from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
from bayesvlm_tpu_torch.types import EncoderResult

# logit scale of the pretrained laion CLIP checkpoints (ln 100), used
# with random-init towers, as in the JAX package
DEFAULT_LOGIT_SCALE = {"clip": 4.6052}

_GEMM_MODULES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


class _EncoderBase:
    projection_name: str

    def __init__(self, config: VLMConfig, module: nn.Module):
        self.config = config
        self.module = module

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def projection_weight(self) -> torch.Tensor:
        return getattr(self.module, self.projection_name).weight

    def projection_l2(self) -> float:
        """Squared L2 norm of the projection parameters."""
        return float(self.projection_weight().float().square().sum())

    def projection_num_params(self) -> int:
        return self.projection_weight().numel()


class ImageEncoder(_EncoderBase):
    """Vision tower wrapper. Call with NHWC (or NCHW) float images."""

    projection_name = "visual_projection"

    def __init__(self, config: VLMConfig, module: nn.Module):
        super().__init__(config, module)
        # what the W8A8 weight cache was quantized from (_weight_key)
        self._quant_src = None

    def _int8_mlps(self):
        return [m for m in self.module.modules()
                if isinstance(m, MLP) and m.use_int8]

    def _weight_key(self) -> tuple:
        """Identity, storage and in-place version of every weight the
        cache derives from: a load_state_dict, a `.data` swap or a new
        Parameter each change it."""
        return tuple((id(p), p.data_ptr(), p._version)
                     for m in self._int8_mlps() for p in (m.fc1.weight, m.fc2.weight))

    def prequantize_int8(self) -> "ImageEncoder":
        """Quantize the int8 MLPs' weights once into their per-layer cache
        buffers (in place), so forwards skip the per-call weight
        quantization. A no-op unless the tower has `mlp_int8`; the
        attention projections stay quantized per call, as in the JAX
        package. Replacing the weights afterwards is caught per call
        (_validate_quant_cache)."""
        mlps = self._int8_mlps()
        if mlps:
            with torch.no_grad():
                for m in mlps:
                    m.prequantize()
            self._quant_src = self._weight_key()
        return self

    def _validate_quant_cache(self) -> None:
        """Never run on a stale cache: if the MLP weights changed since
        prequantize_int8, recompute the cache with a warning (the JAX
        package's `_validate_quant_cache`)."""
        if self._quant_src is None or self._quant_src == self._weight_key():
            return
        warnings.warn(
            "ImageEncoder weights were replaced after prequantize_int8(); "
            "recomputing the W8A8 weight cache from the new weights.",
            RuntimeWarning, stacklevel=3)
        self.prequantize_int8()

    @torch.inference_mode()
    def __call__(self, images) -> EncoderResult:
        self._validate_quant_cache()
        x = torch.as_tensor(images, device=self.device)
        if not torch.is_floating_point(x):
            raise ValueError("pixels must be normalized floats (the uint8 "
                             "ingest lane is not ported yet)")
        if x.dim() == 4 and x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        embeds, activations = self.module(x.float())
        return EncoderResult.create(embeds=embeds, activations=activations)


class TextEncoder(_EncoderBase):
    """Text tower wrapper. Call with integer token ids [B, T]."""

    projection_name = "text_projection"

    def __init__(self, config: VLMConfig, module: nn.Module,
                 tokenizer: Optional[Callable] = None):
        super().__init__(config, module)
        self.tokenizer = tokenizer

    @torch.inference_mode()
    def __call__(self, input_ids) -> EncoderResult:
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
        embeds, activations = self.module(ids)
        return EncoderResult.create(embeds=embeds, activations=activations)

    def encode_texts(self, texts) -> EncoderResult:
        if self.tokenizer is None:
            raise ValueError("no tokenizer attached; pass token ids directly "
                             "or attach one (data/tokenizer.py)")
        return self(self.tokenizer(list(texts)))


def cast_gemm_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Put the big GEMM weights (attention projections + MLP, weights and
    biases) in the compute dtype, in place. LayerNorm, embedding and
    projection parameters stay fp32 (the fp32-LN numerics contract)."""
    for name, sub in module.named_modules():
        if name.rsplit(".", 1)[-1] in _GEMM_MODULES:
            sub.to(dtype)
    return module


def rebuild_image_encoder(encoder: ImageEncoder, **vision_fields) -> ImageEncoder:
    """An ImageEncoder whose tower is built from `encoder`'s VisionConfig
    with `vision_fields` replaced, holding the same weights in the same
    dtypes on the same device. This is how a lane that `load_model` has
    no keyword for is reached, as the JAX package reaches it: a tower
    built from `dataclasses.replace(cfg.vision, attn_pallas_block=True)`
    with the parameters it already has."""
    config = dataclasses.replace(encoder.config, vision=dataclasses.replace(
        encoder.config.vision, **vision_fields))
    old = encoder.module
    tower = CLIPVisionTower(config.vision, dtype=old.dtype).to(encoder.device)
    tower.load_state_dict(old.state_dict())
    cast_gemm_params(tower, old.dtype).eval().requires_grad_(False)
    return ImageEncoder(config, tower).prequantize_int8()


def _init_tower(module: nn.Module, gen: torch.Generator) -> None:
    """Random init with the JAX package's initializer scales: lecun-normal
    dense and conv kernels (std 1/sqrt(fan_in)) with zero biases,
    normal(0.02) class/position embeddings, normal 1/sqrt(vocab) token
    embeddings (flax's default embed init). LayerNorms keep their
    unit/zero construction values."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                            dtype=t.dtype) * std)

    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (nn.Linear, nn.Conv2d)):
                normal_(sub.weight, 1.0 / math.sqrt(sub.weight[0].numel()))
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, nn.Embedding):
                normal_(sub.weight, 1.0 / math.sqrt(sub.weight.shape[0]))
        normal_(module.position_embedding, 0.02)
        if hasattr(module, "class_embedding"):
            normal_(module.class_embedding, 0.02)


def load_model(
    model_str: str,
    weights_dir: Optional[Union[str, Path]] = None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    mlp_int8: bool = False,
    attn_int8: bool = False,
    mlp_weight_bits: int = 8,
) -> Tuple[ImageEncoder, TextEncoder, ProbabilisticHead]:
    """Build (image_encoder, text_encoder, similarity head) for a model
    name (ref:bayesvlm/utils.py:28-46) on `device` (the card unless the
    caller asks for another).

    `mlp_int8` / `attn_int8`: run the vision tower's MLP sublayers /
    attention projections through the W8A8 int8 kernels
    (models/mlp_int8.py, models/linear_int8.py), with `mlp_weight_bits`
    8 or 4 for the MLP weights. Approximate and opt-in; the parameters
    are the same, so weight files are unaffected. The weight cache is
    not filled here (ImageEncoder.prequantize_int8).

    `weights_dir`: a directory holding `vision.pt` and `text.pt`, the
    towers' state dicts (models/bridge.py writes them from the JAX
    package's parameter trees). When None, parameters are drawn from a
    `torch.Generator` on `device` seeded with `seed`; the draws differ
    between devices and from the JAX package's.
    """
    config = CONFIGS_BY_NAME[model_str]
    if config.family != "clip":
        raise NotImplementedError(f"{config.family} towers are not ported yet")
    if mlp_int8 or attn_int8:
        config = dataclasses.replace(config, vision=dataclasses.replace(
            config.vision, mlp_int8=mlp_int8, attn_int8=attn_int8,
            mlp_weight_bits=mlp_weight_bits))
    device = torch.device(device)
    vision = CLIPVisionTower(config.vision, dtype=dtype).to(device)
    text = CLIPTextTower(config.text, dtype=dtype).to(device)
    if weights_dir is not None:
        wd = Path(weights_dir)
        for tower, name in ((vision, "vision.pt"), (text, "text.pt")):
            tower.load_state_dict(torch.load(wd / name, map_location=device,
                                             weights_only=True))
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        _init_tower(vision, gen)
        _init_tower(text, gen)
    for tower in (vision, text):
        cast_gemm_params(tower, dtype).eval().requires_grad_(False)
    head = ProbabilisticHead.create(
        logit_scale=DEFAULT_LOGIT_SCALE[config.family], device=device,
        has_bias=config.projection_has_bias,
    )
    return ImageEncoder(config, vision), TextEncoder(config, text), head
