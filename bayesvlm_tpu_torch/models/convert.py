"""HF checkpoint -> the port's state dicts (offline), the counterpart of
`bayesvlm_tpu.models.convert`.

Reads a local HF snapshot directory (no network) of the models the
reference wraps (`CLIPModel`, `SiglipModel`, ref:bayesvlm/vlm.py:8-16):
sorted `*.safetensors` first, else sorted `pytorch_model*.bin`. Float
tensors are upcast to fp32, the parameter store's dtype (the compute
dtype is applied at load, `encoders.cast_gemm_params`).

`.safetensors` goes through this module's own reader (`read_safetensors`):
an 8-byte little-endian header length, a JSON header, then the raw
little-endian tensors. Real CLIP and SigLIP snapshots ship fp16 or bf16
files. `.bin` goes through `torch.load(weights_only=True)`.

The HF names map straight onto the port's state-dict names, the ones
`models/bridge.py` writes: the `vision_model.` / `text_model.` prefix
drops, Linear and conv weights keep torch's layout (no transpose), CLIP's
`pre_layrnorm` typo is read as `pre_layernorm`, and SigLIP's packed
`head.attention.in_proj_{weight,bias}` is split into q/k/v. A missing
key raises `KeyError` naming it.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch

StateDict = Dict[str, torch.Tensor]

# safetensors dtype tags -> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}

_LAYER_MODULES = ("layer_norm1", "layer_norm2", "self_attn.q_proj", "self_attn.k_proj",
                  "self_attn.v_proj", "self_attn.out_proj", "mlp.fc1", "mlp.fc2")


def read_safetensors(path: Union[str, Path]) -> StateDict:
    """All tensors of one `.safetensors` file, in their stored dtype, as
    views of one buffer read from the file (a tensor at an offset that is
    no multiple of its element size gets its own copy)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - header_len)
        f.readinto(data)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        if end > len(data):
            raise ValueError(f"{path}: truncated safetensors file ({name} ends at "
                             f"{end} of {len(data)} bytes)")
        raw = memoryview(data)[start:end]
        if start % dtype.itemsize:
            raw = bytearray(raw)
        t = torch.frombuffer(raw, dtype=dtype) if end > start else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(meta["shape"])
    return out


def _load_state_dict(model_dir: Union[str, Path],
                     device: Union[str, torch.device] = "cpu") -> StateDict:
    """The snapshot's tensors on `device`, float ones as fp32 (JAX
    `_load_state_dict`). Each tensor is moved in its stored dtype and
    upcast there: an fp16 file crosses to the card at half the bytes."""
    model_dir = Path(model_dir)
    st_files = sorted(model_dir.glob("*.safetensors"))
    if st_files:
        out = {}
        for f in st_files:
            for k, t in read_safetensors(f).items():
                t = t.to(device)
                out[k] = t.float() if t.is_floating_point() else t
        return out
    bin_files = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bin_files:
        raise FileNotFoundError(f"no checkpoint files in {model_dir}")
    out = {}
    for f in bin_files:
        sd = torch.load(f, map_location=device, weights_only=True)
        for k, v in sd.items():
            out[k] = v.float()
    return out


def _encoder_keys(hf_prefix: str, num_layers: int) -> Iterator[Tuple[str, str]]:
    for i in range(num_layers):
        for module in _LAYER_MODULES:
            for p in ("weight", "bias"):
                yield (f"{hf_prefix}.layers.{i}.{module}.{p}",
                       f"encoder.layers.{i}.{module}.{p}")


def _module_keys(hf: str, port: str, bias: bool = True) -> List[Tuple[str, str]]:
    return [(f"{hf}.{p}", f"{port}.{p}") for p in (("weight", "bias") if bias else ("weight",))]


def _key_map(family: str, tower: str, num_layers: int,
            clip_pre_ln: str = "vision_model.pre_layrnorm") -> List[Tuple[str, str]]:
    """(HF name, port name) of every tensor of one tower, SigLIP's packed
    probe-attention q/k/v excepted (`_split_in_proj`). `clip_pre_ln`: the
    HF prefix of CLIP's pre-LN, which carries HF's historical typo in most
    snapshots."""
    if tower == "vision":
        v = "vision_model"
        keys = [(f"{v}.embeddings.patch_embedding.weight", "patch_embedding.weight")]
        if family == "clip":
            keys += [(f"{v}.embeddings.class_embedding", "class_embedding"),
                     (f"{v}.embeddings.position_embedding.weight", "position_embedding"),
                     *_module_keys(clip_pre_ln, "pre_layernorm")]
        else:
            keys += [(f"{v}.embeddings.patch_embedding.bias", "patch_embedding.bias"),
                     (f"{v}.embeddings.position_embedding.weight", "position_embedding")]
        keys += [*_encoder_keys(f"{v}.encoder", num_layers),
                 *_module_keys(f"{v}.post_layernorm", "post_layernorm")]
        if family == "clip":
            return keys + [("visual_projection.weight", "visual_projection.weight")]
        return keys + [(f"{v}.head.probe", "probe"),
                       *_module_keys(f"{v}.head.attention.out_proj",
                                     "head_attention.out_proj"),
                       *_module_keys(f"{v}.head.layernorm", "head_layernorm"),
                       *_module_keys(f"{v}.head.mlp.fc1", "head_fc1"),
                       *_module_keys(f"{v}.head.mlp.fc2", "head_fc2")]
    t = "text_model"
    keys = [(f"{t}.embeddings.token_embedding.weight", "token_embedding.weight"),
            (f"{t}.embeddings.position_embedding.weight", "position_embedding"),
            *_encoder_keys(f"{t}.encoder", num_layers),
            *_module_keys(f"{t}.final_layer_norm", "final_layer_norm")]
    if family == "clip":
        return keys + [("text_projection.weight", "text_projection.weight")]
    return keys + _module_keys(f"{t}.head", "head")


def _convert(sd: StateDict, keys) -> StateDict:
    return {port: sd[hf] for hf, port in keys}


def _split_in_proj(sd: StateDict, out: StateDict) -> None:
    # packed torch MultiheadAttention in_proj -> q/k/v (JAX :127-133)
    for p in ("weight", "bias"):
        packed = sd[f"vision_model.head.attention.in_proj_{p}"]
        for name, part in zip(("q_proj", "k_proj", "v_proj"), packed.chunk(3, dim=0)):
            out[f"head_attention.{name}.{p}"] = part


def convert_clip_vision(sd: StateDict, num_layers: int) -> StateDict:
    pre_ln = ("vision_model.pre_layrnorm"  # HF's historical typo
              if "vision_model.pre_layrnorm.weight" in sd
              else "vision_model.pre_layernorm")
    return _convert(sd, _key_map("clip", "vision", num_layers, clip_pre_ln=pre_ln))


def convert_clip_text(sd: StateDict, num_layers: int) -> StateDict:
    return _convert(sd, _key_map("clip", "text", num_layers))


def convert_siglip_vision(sd: StateDict, num_layers: int) -> StateDict:
    out = _convert(sd, _key_map("siglip", "vision", num_layers))
    _split_in_proj(sd, out)
    return out


def convert_siglip_text(sd: StateDict, num_layers: int) -> StateDict:
    return _convert(sd, _key_map("siglip", "text", num_layers))


CONVERTERS = {
    ("clip", "vision"): convert_clip_vision,
    ("clip", "text"): convert_clip_text,
    ("siglip", "vision"): convert_siglip_vision,
    ("siglip", "text"): convert_siglip_text,
}


def load_logit_scale_bias(sd: StateDict) -> Tuple[Optional[float], float]:
    """The snapshot's trained (logit_scale, logit_bias): a missing scale
    is None (the caller takes the family's default), a missing bias 0.0."""
    scale = float(sd["logit_scale"]) if "logit_scale" in sd else None
    bias = float(sd["logit_bias"]) if "logit_bias" in sd else 0.0
    return scale, bias


def convert_from_snapshot(model_dir, family: str, tower: str, num_layers: int) -> StateDict:
    """Convert one tower from a local HF snapshot directory."""
    return CONVERTERS[(family, tower)](_load_state_dict(Path(model_dir)), num_layers)

