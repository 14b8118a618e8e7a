"""High-level encoder objects: tower module + forward -> `EncoderResult`.

Counterparts of `bayesvlm_tpu.models.encoders` (and of the reference's
`CLIPImageEncoder` / `CLIPTextEncoder` / `SiglipImageEncoder` /
`SiglipTextEncoder`, ref:bayesvlm/vlm.py). The projection layer (the
Laplace layer: CLIP's `visual_projection` / `text_projection`, SigLIP's
`head_fc2` / `head`, both with a bias) enters the Bayesian chain through
`projection_l2` / `projection_num_params`, which count every parameter
of it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import warnings
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from bayesvlm_tpu_torch.models.clip import CLIPTextTower, CLIPVisionTower
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME, VLMConfig
from bayesvlm_tpu_torch.models.layers import MLP, LayerNormFP32
from bayesvlm_tpu_torch.models.siglip import SiglipTextTower, SiglipVisionTower
from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
from bayesvlm_tpu_torch.types import EncoderResult

# logit scale and bias of the pretrained checkpoints, used with
# random-init towers, as in the JAX package: CLIP ln(100) = 4.6052 (laion
# CLIP); SigLIP base ships scale 4.765, bias -16.5 (HF configs)
DEFAULT_LOGIT_SCALE = {"clip": 4.6052, "siglip": 4.7651}
DEFAULT_LOGIT_BIAS = {"clip": 0.0, "siglip": -16.5}

# (vision, text) tower classes of each family
TOWERS = {"clip": (CLIPVisionTower, CLIPTextTower),
          "siglip": (SiglipVisionTower, SiglipTextTower)}

_GEMM_MODULES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def _projection_path(family: str, tower: str) -> str:
    """The projection (Laplace) layer's module name in a tower."""
    if family == "clip":
        return "visual_projection" if tower == "vision" else "text_projection"
    return "head_fc2" if tower == "vision" else "head"


class _EncoderBase:
    tower: str  # "vision" | "text"

    def __init__(self, config: VLMConfig, module: nn.Module):
        self.config = config
        self.module = module

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def projection(self) -> nn.Linear:
        return getattr(self.module, _projection_path(self.config.family, self.tower))

    def projection_weight(self) -> torch.Tensor:
        return self.projection().weight

    def projection_l2(self) -> float:
        """Squared L2 norm of the projection parameters (bias included)."""
        return float(sum(p.float().square().sum() for p in self.projection().parameters()))

    def projection_num_params(self) -> int:
        return sum(p.numel() for p in self.projection().parameters())

    def projection_tree(self) -> dict:
        """The projection's parameters in the JAX package's layout, as fp32
        copies: {"kernel": [P, D]}, plus "bias" [D] where the projection
        has one (SigLIP)."""
        proj = self.projection()
        tree = {"kernel": proj.weight.detach().float().T.contiguous()}
        if proj.bias is not None:
            tree["bias"] = proj.bias.detach().float().clone()
        return tree

    def with_projection(self, new_projection: dict) -> "_EncoderBase":
        """Write `new_projection` (projection_tree's layout) into the
        projection layer in place, and return the encoder. Keys and shapes
        are strict: "bias" exactly where the projection has one."""
        proj = self.projection()
        expected = {"kernel"} | ({"bias"} if proj.bias is not None else set())
        if set(new_projection) != expected:
            raise ValueError(f"projection keys {sorted(new_projection)} do not match "
                             f"this projection's {sorted(expected)}")
        kernel = torch.as_tensor(new_projection["kernel"]).T
        if tuple(kernel.shape) != tuple(proj.weight.shape):
            raise ValueError(f"projection kernel {tuple(kernel.shape[::-1])} does not "
                             f"match this projection's {tuple(proj.weight.shape[::-1])}")
        with torch.no_grad():
            proj.weight.copy_(kernel)
            if proj.bias is not None:
                bias = torch.as_tensor(new_projection["bias"])
                if tuple(bias.shape) != tuple(proj.bias.shape):
                    raise ValueError(f"projection bias {tuple(bias.shape)} does not "
                                     f"match this projection's {tuple(proj.bias.shape)}")
                proj.bias.copy_(bias)
        return self

    def save_projection_weights(self, path) -> None:
        """Write the projection as a torch state dict `.pt`, the
        reference's `torch.save(projection.state_dict())` contract
        (ref:bayesvlm/vlm.py:236-253): {"weight": [out, in]}, plus "bias"
        where the projection has one (SigLIP's head_fc2)."""
        proj = self.projection()
        state = {"weight": proj.weight.detach().float().cpu().contiguous()}
        if proj.bias is not None:
            state["bias"] = proj.bias.detach().float().cpu().contiguous()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(state, path)

    def load_projection_weights(self, path) -> "_EncoderBase":
        """Read a projection checkpoint (this package's, the JAX package's
        or the reference's state dict `.pt`) into the projection, in
        place, and return the encoder. Keys are strict, as torch's
        `load_state_dict(strict=True)`, which the reference relies on: a
        missing or unexpected "bias", or an unknown key, raises. A bare
        tensor is taken as the weight of a projection without a bias."""
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        has_bias = self.projection().bias is not None
        if isinstance(loaded, dict):
            expected = {"weight"} | ({"bias"} if has_bias else set())
            got = set(loaded)
            if got != expected:
                raise ValueError(
                    f"projection checkpoint {path} keys {sorted(got)} do not match "
                    f"this projection's state_dict keys {sorted(expected)} (missing: "
                    f"{sorted(expected - got)}, unexpected: {sorted(got - expected)})")
            tree = {"kernel": loaded["weight"].float().T}
            if has_bias:
                tree["bias"] = loaded["bias"].float()
        else:
            if has_bias:
                raise ValueError(
                    f"projection checkpoint {path} is a bare kernel tensor but this "
                    "projection has a bias; a full state_dict {'weight', 'bias'} is "
                    "required (SigLIP head_fc2)")
            tree = {"kernel": torch.as_tensor(loaded).float().T}
        return self.with_projection(tree)


class ImageEncoder(_EncoderBase):
    """Vision tower wrapper. Call with NHWC (or NCHW) normalised float
    images or uint8 crops."""

    tower = "vision"

    def __init__(self, config: VLMConfig, module: nn.Module):
        super().__init__(config, module)
        # what the W8A8 weight cache was quantized from (_weight_key)
        self._quant_src = None
        self._u8_constants = None

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

    def _uint8_constants(self, device: torch.device) -> tuple:
        """(255, mean, std) as fp32 tensors on `device`, made once: a
        division by a tensor is a true division on the card too (a Python
        scalar would become a multiplication by its reciprocal), so the
        device normalises a uint8 image to the host float transform's bits."""
        if self._u8_constants is None or self._u8_constants[0].device != device:
            from bayesvlm_tpu_torch.data.transforms import NORMALIZATION_BY_FAMILY

            mean, std = NORMALIZATION_BY_FAMILY[self.config.family]
            self._u8_constants = tuple(torch.tensor(v, dtype=torch.float32, device=device)
                                       for v in (255.0, mean, std))
        return self._u8_constants

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC pixels -> fp32 normalised with the family's mean and
        std, in the JAX package's order (`x / 255`, then `(x - mean) /
        std`; its `_image_forward_graph`); floats are returned as they are."""
        if x.dtype == torch.uint8:
            scale, mean, std = self._uint8_constants(x.device)
            return (x.float() / scale - mean) / std
        if not torch.is_floating_point(x):
            raise ValueError(f"pixels must be uint8 or normalized floats, not {x.dtype}")
        return x

    def forward_pixels(self, x: torch.Tensor) -> EncoderResult:
        """The tower on NHWC pixels already on its device, uint8 ones
        normalised first (before the tower's own cast). Shared by
        `__call__` and the serving programs (pipeline.compile_serving)."""
        # (embeds, activations) for CLIP, SigLIP adds its residuals
        return EncoderResult.create(*self.module(self.normalize(x).float()))

    @torch.inference_mode()
    def __call__(self, images) -> EncoderResult:
        """NHWC (or NCHW) images: normalised floats, or uint8 crops (the
        `*_uint8` transforms), which cross to the device as uint8."""
        self._validate_quant_cache()
        x = torch.as_tensor(images, device=self.device)
        if x.dim() == 4 and x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        return self.forward_pixels(x)


class TextEncoder(_EncoderBase):
    """Text tower wrapper. Call with integer token ids [B, T]."""

    tower = "text"

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
    biases) in the compute dtype, in place, chosen by module name as the
    JAX package chooses by key: q/k/v/out_proj (the SigLIP probe
    attention's too) and fc1/fc2. LayerNorm, embedding, projection and
    SigLIP head_fc1/head_fc2 parameters stay fp32 (the fp32-LN numerics
    contract)."""
    for name, sub in module.named_modules():
        if name.rsplit(".", 1)[-1] in _GEMM_MODULES:
            sub.to(dtype)
    return module


def rebuild_image_encoder(encoder: ImageEncoder, remat: Optional[bool] = None,
                          **vision_fields) -> ImageEncoder:
    """An ImageEncoder whose tower is built from `encoder`'s VisionConfig
    with `vision_fields` replaced, holding the same weights in the same
    dtypes on the same device. This is how a lane that `load_model` has
    no keyword for is reached, as the JAX package reaches it: a tower
    built from `dataclasses.replace(cfg.vision, attn_pallas_block=True)`
    with the parameters it already has. `remat` (None: `encoder`'s) as
    in `load_model`."""
    config = dataclasses.replace(encoder.config, vision=dataclasses.replace(
        encoder.config.vision, **vision_fields))
    old = encoder.module
    if remat is None:
        remat = old.encoder.remat
    tower = TOWERS[config.family][0](config.vision, dtype=old.dtype,
                                     remat=remat).to(encoder.device)
    tower.load_state_dict(old.state_dict())
    cast_gemm_params(tower, old.dtype).eval().requires_grad_(False)
    return ImageEncoder(config, tower).prequantize_int8()


def _init_tower(module: nn.Module, gen: torch.Generator) -> None:
    """Random init with the JAX package's initializer scales: lecun-normal
    dense and conv kernels (std 1/sqrt(fan_in)) with zero biases,
    normal(0.02) class/position embeddings and SigLIP probe, normal
    1/sqrt(vocab) token embeddings (flax's default embed init), unit
    LayerNorm scales with zero biases. Every parameter is written."""

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
            elif isinstance(sub, LayerNormFP32):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
        normal_(module.position_embedding, 0.02)
        for name in ("class_embedding", "probe"):
            if hasattr(module, name):
                normal_(getattr(module, name), 0.02)


def load_model(
    model_str: str,
    weights_dir: Optional[Union[str, Path]] = None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    mlp_int8: bool = False,
    attn_int8: bool = False,
    mlp_weight_bits: int = 8,
    remat: bool = False,
) -> Tuple[ImageEncoder, TextEncoder, ProbabilisticHead]:
    """Build (image_encoder, text_encoder, similarity head) for a model
    name (ref:bayesvlm/utils.py:28-46) on `device` (the card unless the
    caller asks for another).

    `remat`: both towers' blocks recompute their forward in the backward
    when a gradient is taken through them (layers.TransformerEncoder;
    the partial-backbone fine-tune, train/backbone.py). Off by default,
    as in JAX; nothing changes under `no_grad` / `inference_mode`.

    `mlp_int8` / `attn_int8`: run the vision tower's MLP sublayers /
    attention projections through the W8A8 int8 kernels
    (models/mlp_int8.py, models/linear_int8.py), with `mlp_weight_bits`
    8 or 4 for the MLP weights. Approximate and opt-in; the parameters
    are the same, so weight files are unaffected. The weight cache is
    not filled here (ImageEncoder.prequantize_int8).

    `weights_dir` takes either of two layouts, checked in this order:
      - the port's own `vision.pt` and `text.pt`, the towers' state dicts
        (`convert_weights` writes them from an HF snapshot,
        models/bridge.py from the JAX package's parameter trees), and
        optionally `head.json`, the trained logit scale and bias: a null
        scale takes the family's default, an absent (or null) bias 0.0.
        A directory without `head.json` gets the family's default head;
      - an HF snapshot directory (`*.safetensors` or `pytorch_model*.bin`,
        models/convert.py), read as the JAX package reads it: a snapshot
        without `logit_scale` takes the family's default scale, one
        without `logit_bias` the bias 0.0 (not SigLIP's default -16.5).
    CLIP keeps no bias. Parameters are read as fp32, then the GEMM
    weights are cast to `dtype`. When None, parameters are drawn from a
    `torch.Generator` on `device` seeded with `seed`; the draws differ
    between devices and from the JAX package's.
    """
    config = CONFIGS_BY_NAME[model_str]
    if mlp_int8 or attn_int8:
        config = dataclasses.replace(config, vision=dataclasses.replace(
            config.vision, mlp_int8=mlp_int8, attn_int8=attn_int8,
            mlp_weight_bits=mlp_weight_bits))
    device = torch.device(device)
    vision_cls, text_cls = TOWERS[config.family]
    # built without an init pass (every tensor is read or drawn below) and
    # allocated where they run
    with torch.device("meta"):
        vision = vision_cls(config.vision, dtype=dtype, remat=remat)
        text = text_cls(config.text, dtype=dtype, remat=remat)
    vision.to_empty(device=device)
    text.to_empty(device=device)
    scale = DEFAULT_LOGIT_SCALE[config.family]
    bias = DEFAULT_LOGIT_BIAS[config.family]
    if weights_dir is not None:
        wd = Path(weights_dir)
        if (wd / "vision.pt").exists():
            for tower, name in ((vision, "vision.pt"), (text, "text.pt")):
                tower.load_state_dict(torch.load(wd / name, map_location=device,
                                                 weights_only=True))
            head_info = (json.loads((wd / "head.json").read_text())
                         if (wd / "head.json").exists() else None)
        else:
            from bayesvlm_tpu_torch.models.convert import (
                CONVERTERS,
                _load_state_dict,
                load_logit_scale_bias,
            )

            sd = _load_state_dict(wd, device=device)
            for tower, name in ((vision, "vision"), (text, "text")):
                tower.load_state_dict(CONVERTERS[(config.family, name)](
                    sd, getattr(config, name).num_layers))
            head_info = dict(zip(("logit_scale", "logit_bias"), load_logit_scale_bias(sd)))
            del sd
        if head_info is not None:
            # bayesvlm_tpu/models/encoders.py:455-459 and :474-477
            if head_info.get("logit_scale") is not None:
                scale = head_info["logit_scale"]
            bias = head_info.get("logit_bias")
            bias = 0.0 if bias is None or config.family != "siglip" else bias
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        _init_tower(vision, gen)
        _init_tower(text, gen)
    for tower in (vision, text):
        cast_gemm_params(tower, dtype).eval().requires_grad_(False)
    head = ProbabilisticHead.create(
        logit_scale=scale, logit_bias=bias, device=device,
        has_bias=config.projection_has_bias,
    )
    return ImageEncoder(config, vision), TextEncoder(config, text), head
