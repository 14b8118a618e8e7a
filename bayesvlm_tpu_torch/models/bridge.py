"""Weight bridge: the JAX package's CLIP and SigLIP parameter trees -> the
port's state dicts (the tests' way to give both packages the same
weights; HF snapshots go through `models/convert.py`).

Input: the flax parameter trees of `bayesvlm_tpu.models.clip` or
`bayesvlm_tpu.models.siglip` towers, with every leaf as a numpy array
(`jax.tree_util.tree_map(np.asarray, params)`); this module imports
neither JAX nor the JAX package.
  - the encoder's layers are stacked along a leading [L, ...] axis
    (flax `nn.scan`): they are unstacked into `encoder.layers.<i>`;
  - dense kernels are [in, out]: transposed to torch's [out, in];
  - the patch conv kernel is flax HWIO: permuted to torch OIHW (SigLIP's
    bias carried as it is);
  - LayerNorm `ln/{scale,bias}` becomes `{weight,bias}`;
  - SigLIP's probe [1, 1, D] and head (probe attention, LN, fc1, fc2;
    the text `head`) keep their names.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _ln(tree, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["ln"]["scale"])
    out[f"{prefix}.bias"] = _t(tree["ln"]["bias"])


def _dense(tree, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _encoder(tree, out: dict) -> None:
    block = tree["layers"]["block"]
    num_layers = np.asarray(block["layer_norm1"]["ln"]["scale"]).shape[0]
    for i in range(num_layers):
        layer = _index(block, i)
        p = f"encoder.layers.{i}"
        _ln(layer["layer_norm1"], f"{p}.layer_norm1", out)
        _ln(layer["layer_norm2"], f"{p}.layer_norm2", out)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(layer["self_attn"][name], f"{p}.self_attn.{name}", out)
        for name in ("fc1", "fc2"):
            _dense(layer["mlp"][name], f"{p}.mlp.{name}", out)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _patch_embedding(tree, out: dict) -> None:
    # HWIO -> OIHW
    out["patch_embedding.weight"] = _t(np.transpose(np.asarray(tree["kernel"]),
                                                    (3, 2, 0, 1)))
    if "bias" in tree:
        out["patch_embedding.bias"] = _t(tree["bias"])


def clip_vision_state_dict(params) -> Dict[str, torch.Tensor]:
    """`CLIPVisionTower` params (flax tree of numpy arrays) -> state dict."""
    out = {}
    _patch_embedding(params["patch_embedding"], out)
    out.update({
        "class_embedding": _t(params["class_embedding"]),
        "position_embedding": _t(params["position_embedding"]),
    })
    _ln(params["pre_layernorm"], "pre_layernorm", out)
    _encoder(params["encoder"], out)
    _ln(params["post_layernorm"], "post_layernorm", out)
    _dense(params["visual_projection"], "visual_projection", out)
    return out


def clip_text_state_dict(params) -> Dict[str, torch.Tensor]:
    """`CLIPTextTower` params (flax tree of numpy arrays) -> state dict."""
    out = {
        "token_embedding.weight": _t(params["token_embedding"]["embedding"]),
        "position_embedding": _t(params["position_embedding"]),
    }
    _encoder(params["encoder"], out)
    _ln(params["final_layer_norm"], "final_layer_norm", out)
    _dense(params["text_projection"], "text_projection", out)
    return out


def siglip_vision_state_dict(params) -> Dict[str, torch.Tensor]:
    """`SiglipVisionTower` params (flax tree of numpy arrays) -> state dict."""
    out = {}
    _patch_embedding(params["patch_embedding"], out)
    out["position_embedding"] = _t(params["position_embedding"])
    _encoder(params["encoder"], out)
    _ln(params["post_layernorm"], "post_layernorm", out)
    out["probe"] = _t(params["probe"])
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(params["head_attention"][name], f"head_attention.{name}", out)
    _ln(params["head_layernorm"], "head_layernorm", out)
    _dense(params["head_fc1"], "head_fc1", out)
    _dense(params["head_fc2"], "head_fc2", out)
    return out


def siglip_text_state_dict(params) -> Dict[str, torch.Tensor]:
    """`SiglipTextTower` params (flax tree of numpy arrays) -> state dict."""
    out = {
        "token_embedding.weight": _t(params["token_embedding"]["embedding"]),
        "position_embedding": _t(params["position_embedding"]),
    }
    _encoder(params["encoder"], out)
    _ln(params["final_layer_norm"], "final_layer_norm", out)
    _dense(params["head"], "head", out)
    return out


def vision_state_dict(params) -> Dict[str, torch.Tensor]:
    """Either family's vision tower params -> state dict (SigLIP told apart
    by its probe): how a tree the JAX package trained (train/backbone.py)
    is held against the port's trained tower, name for name."""
    if "probe" in params:
        return siglip_vision_state_dict(params)
    return clip_vision_state_dict(params)


def save_weights(weights_dir: Union[str, Path], vision_params, text_params,
                 logit_scale: Optional[float] = None,
                 logit_bias: Optional[float] = None) -> Path:
    """Write `vision.pt` / `text.pt`, the layout `load_model(weights_dir=...)`
    reads, for either family (told apart by the vision tree's probe).

    With a `logit_scale` or `logit_bias` (the checkpoint's trained head),
    also `head.json` as `{"logit_scale": ..., "logit_bias": ...}`, the
    file `scripts/convert_weights.py` writes beside the JAX package's
    trees; `load_model` reads it with the JAX package's fallbacks. With
    neither, no `head.json` is written and `load_model` builds the
    family's default head."""
    wd = Path(weights_dir)
    wd.mkdir(parents=True, exist_ok=True)
    text = siglip_text_state_dict if "probe" in vision_params else clip_text_state_dict
    torch.save(vision_state_dict(vision_params), wd / "vision.pt")
    torch.save(text(text_params), wd / "text.pt")
    if logit_scale is not None or logit_bias is not None:
        (wd / "head.json").write_text(json.dumps(
            {"logit_scale": logit_scale, "logit_bias": logit_bias}))
    return wd
