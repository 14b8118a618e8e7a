"""Weight bridge: the JAX package's CLIP parameter trees -> the port's
state dicts (counterpart of `bayesvlm_tpu.models.convert`, run the other
way).

Input: the flax parameter trees of `bayesvlm_tpu.models.clip` towers,
with every leaf as a numpy array (`jax.tree_util.tree_map(np.asarray,
params)`); this module imports neither JAX nor the JAX package.
  - the encoder's layers are stacked along a leading [L, ...] axis
    (flax `nn.scan`): they are unstacked into `encoder.layers.<i>`;
  - dense kernels are [in, out]: transposed to torch's [out, in];
  - the patch conv kernel is flax HWIO: permuted to torch OIHW;
  - LayerNorm `ln/{scale,bias}` becomes `{weight,bias}`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

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


def clip_vision_state_dict(params) -> Dict[str, torch.Tensor]:
    """`CLIPVisionTower` params (flax tree of numpy arrays) -> state dict."""
    out = {
        # HWIO -> OIHW
        "patch_embedding.weight": _t(np.transpose(
            np.asarray(params["patch_embedding"]["kernel"]), (3, 2, 0, 1))),
        "class_embedding": _t(params["class_embedding"]),
        "position_embedding": _t(params["position_embedding"]),
    }
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


def save_weights(weights_dir: Union[str, Path], vision_params,
                 text_params) -> Path:
    """Write `vision.pt` / `text.pt`, the layout `load_model(weights_dir=...)`
    reads."""
    wd = Path(weights_dir)
    wd.mkdir(parents=True, exist_ok=True)
    torch.save(clip_vision_state_dict(vision_params), wd / "vision.pt")
    torch.save(clip_text_state_dict(text_params), wd / "text.pt")
    return wd
