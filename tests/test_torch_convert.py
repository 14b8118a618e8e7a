"""The port's HF checkpoint path against the JAX package's and the HF towers.

Tiny HF `CLIPModel` and `SiglipModel` are built offline from config
objects (the widths of tiny-clip and tiny-siglip, as
tests/test_hf_parity.py builds them), their parameters perturbed from a
seed so that no bias or LayerNorm is left at its construction value, and
saved as HF snapshots: `model.safetensors` (through the `safetensors`
package) in F32, F16 and BF16, and `pytorch_model.bin`. On them:

- the port's reader gives exactly the JAX `_load_state_dict` arrays;
- the port's `convert_*` gives exactly `bridge.*_state_dict(jax convert_*)`;
- the port's `load_model(dtype=fp32, device="cpu")` towers match the HF
  towers and the JAX `load_model` on the same directory, at
  test_hf_parity's ATOL 2e-4 / RTOL 2e-3;
- the head's scale and bias equal JAX's (SigLIP without `logit_bias`:
  0.0); a missing key raises; `convert_weights` output loads to the same
  tensors.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import save_file

from bayesvlm_tpu.models import load_model as jax_load_model
from bayesvlm_tpu.models import convert as jax_convert
from bayesvlm_tpu_torch import convert_weights
from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
from bayesvlm_tpu_torch.models import bridge, convert
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from bayesvlm_tpu_torch.models.encoders import DEFAULT_LOGIT_SCALE, load_model

ATOL = 2e-4
RTOL = 2e-3
FORMATS = ("f32", "f16", "bf16", "bin")
ST_DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
MODEL = {"clip": "tiny-clip", "siglip": "tiny-siglip"}
BRIDGE = {("clip", "vision"): bridge.clip_vision_state_dict,
          ("clip", "text"): bridge.clip_text_state_dict,
          ("siglip", "vision"): bridge.siglip_vision_state_dict,
          ("siglip", "text"): bridge.siglip_text_state_dict}


def hf_model(family: str):
    """A tiny HF model of the family at tiny-clip / tiny-siglip widths,
    every parameter moved by seeded noise (biases and LNs included)."""
    torch.manual_seed(0)
    if family == "clip":
        cfg = transformers.CLIPConfig(
            text_config=dict(vocab_size=64, hidden_size=24, intermediate_size=48,
                             num_hidden_layers=2, num_attention_heads=2,
                             max_position_embeddings=16, hidden_act="gelu",
                             eos_token_id=63, bos_token_id=0, pad_token_id=1),
            vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=2, image_size=32, patch_size=8,
                               hidden_act="gelu"),
            projection_dim=16)
        model = transformers.CLIPModel(cfg)
    else:
        common = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=2, hidden_act="gelu_pytorch_tanh",
                      layer_norm_eps=1e-6)
        cfg = transformers.SiglipConfig(
            text_config=dict(vocab_size=64, max_position_embeddings=16,
                             projection_size=32, **common),
            vision_config=dict(image_size=32, patch_size=8, **common))
        model = transformers.SiglipModel(cfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name not in ("logit_scale", "logit_bias"):
                p.add_(torch.randn(p.shape, generator=gen) * 0.02)
        if family == "siglip":
            model.logit_scale.fill_(2.25)
            model.logit_bias.fill_(-3.5)
        else:
            model.logit_scale.fill_(3.75)
    return model.eval()


def save_snapshot(sd: dict, path, fmt: str):
    """An HF snapshot directory of `sd` in one of FORMATS."""
    path.mkdir(parents=True, exist_ok=True)
    if fmt == "bin":
        torch.save(sd, path / "pytorch_model.bin")
    else:
        save_file({k: v.to(ST_DTYPES[fmt]).contiguous() for k, v in sd.items()},
                  str(path / "model.safetensors"), metadata={"format": "pt"})
    return path


@pytest.fixture(scope="module")
def models():
    return {family: hf_model(family) for family in MODEL}


@pytest.fixture(scope="module")
def snapshots(models, tmp_path_factory):
    root = tmp_path_factory.mktemp("snapshots")
    return {(family, fmt): save_snapshot(models[family].state_dict(),
                                         root / f"{family}-{fmt}", fmt)
            for family in MODEL for fmt in FORMATS}


def _rounded(model, fmt: str):
    """The HF model with its parameters as the snapshot stores them."""
    if fmt in ("f32", "bin"):
        return model
    import copy

    m = copy.deepcopy(model)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(p.to(ST_DTYPES[fmt]).float())
    return m


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", list(MODEL))
def test_reader_matches_jax(family, fmt, snapshots, models):
    ours = convert._load_state_dict(snapshots[(family, fmt)])
    theirs = jax_convert._load_state_dict(snapshots[(family, fmt)])
    assert set(ours) == set(theirs)
    for k, v in ours.items():
        assert v.dtype == torch.float32 and theirs[k].dtype == np.float32, k
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    sd = models[family].state_dict()
    for k in sd:  # the stored values, rounded as the format rounds them
        want = sd[k].to(ST_DTYPES.get(fmt, torch.float32)).float()
        assert torch.equal(ours[k], want), k


@pytest.mark.parametrize("family", list(MODEL))
def test_convert_matches_jax_through_bridge(family, snapshots):
    sd = convert._load_state_dict(snapshots[(family, "f32")])
    np_sd = jax_convert._load_state_dict(snapshots[(family, "f32")])
    cfg = CONFIGS_BY_NAME[MODEL[family]]
    for tower in ("vision", "text"):
        n = getattr(cfg, tower).num_layers
        ours = convert.CONVERTERS[(family, tower)](sd, n)
        jax_params = getattr(jax_convert, f"convert_{family}_{tower}")(np_sd, n)
        theirs = BRIDGE[(family, tower)](jax_params)
        assert set(ours) == set(theirs)
        for k in ours:
            assert torch.equal(ours[k], theirs[k]), (tower, k)


def _hf_outputs(model, family: str, pixels: np.ndarray, ids: np.ndarray) -> dict:
    """The reference's vision and text outputs of an HF model (SigLIP's
    head surgery as in ref:bayesvlm/vlm.py:460-486, 444-458)."""
    x, t = torch.tensor(pixels).permute(0, 3, 1, 2), torch.tensor(ids)
    with torch.no_grad():
        if family == "clip":
            vm = model.vision_model(pixel_values=x)
            text = model.text_model(input_ids=t)
            return {"img_embeds": model.visual_projection(vm.pooler_output),
                    "img_act": vm.pooler_output,
                    "txt_embeds": model.text_projection(text.pooler_output),
                    "txt_act": text.pooler_output}
        vm = model.vision_model
        hs = vm.post_layernorm(vm.encoder(inputs_embeds=vm.embeddings(x))[0])
        attn = vm.head.attention(vm.head.probe.repeat(len(x), 1, 1), hs, hs)[0]
        act = vm.head.mlp.activation_fn(vm.head.mlp.fc1(vm.head.layernorm(attn)))[:, 0]
        tm = model.text_model
        th = tm.final_layer_norm(tm.encoder(inputs_embeds=tm.embeddings(input_ids=t))[0])
        return {"img_embeds": vm.head.mlp.fc2(act) + attn[:, 0], "img_act": act,
                "img_res": attn[:, 0], "txt_embeds": tm.head(th[:, -1]),
                "txt_act": th[:, -1]}


def _inputs(family: str):
    cfg = CONFIGS_BY_NAME[MODEL[family]]
    rng = np.random.default_rng(7)
    pixels = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(2, 60, size=(3, cfg.text.max_length)).astype(np.int64)
    ids[:, 0] = 0
    for row, pos in enumerate((5, 11, 15)):
        ids[row, pos] = cfg.text.eos_token_id
    return pixels, ids


def _outputs(img, txt, pixels, ids) -> dict:
    i, t = img(pixels), txt(ids)
    out = {"img_embeds": i.embeds, "img_act": i.activations,
           "txt_embeds": t.embeds, "txt_act": t.activations}
    if img.config.family == "siglip":
        out["img_res"] = i.residuals
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", list(MODEL))
def test_load_model_matches_hf_and_jax(family, fmt, snapshots, models):
    wd = snapshots[(family, fmt)]
    img, txt, head = load_model(MODEL[family], weights_dir=wd, dtype=torch.float32,
                                device="cpu")
    # every tensor is the converted snapshot's, bit for bit
    sd = convert._load_state_dict(wd)
    cfg = CONFIGS_BY_NAME[MODEL[family]]
    for enc, tower in ((img, "vision"), (txt, "text")):
        want = convert.CONVERTERS[(family, tower)](sd, getattr(cfg, tower).num_layers)
        got = enc.module.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (tower, k)

    pixels, ids = _inputs(family)
    ours = _outputs(img, txt, pixels, ids)
    hf = {k: v.numpy() for k, v in _hf_outputs(_rounded(models[family], fmt), family,
                                               pixels, ids).items()}
    j_img, j_txt, j_head = jax_load_model(MODEL[family], weights_dir=str(wd),
                                          dtype=jnp.float32)
    theirs = _outputs(j_img, j_txt, jnp.asarray(pixels), jnp.asarray(ids, jnp.int32))
    assert set(ours) == set(hf) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], hf[k], rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(head.logit_scale) == float(j_head.logit_scale)
    assert float(head.logit_bias) == float(j_head.logit_bias)


@pytest.mark.parametrize("family,drop", [
    ("clip", ()), ("clip", ("logit_scale",)), ("siglip", ()), ("siglip", ("logit_bias",)),
    ("siglip", ("logit_scale", "logit_bias"))])
def test_head_follows_jax(family, drop, models, tmp_path):
    """The snapshot's scale and bias; a missing scale takes the family's
    default, a missing bias 0.0 (not SigLIP's -16.5); CLIP keeps none."""
    sd = {k: v for k, v in models[family].state_dict().items() if k not in drop}
    wd = save_snapshot(sd, tmp_path / "snap", "f32")
    _, _, head = load_model(MODEL[family], weights_dir=wd, dtype=torch.float32,
                            device="cpu")
    _, _, j_head = jax_load_model(MODEL[family], weights_dir=str(wd), dtype=jnp.float32)
    scale, bias = float(head.logit_scale), float(head.logit_bias)
    assert (scale, bias) == (float(j_head.logit_scale), float(j_head.logit_bias))
    expected_scale = (DEFAULT_LOGIT_SCALE[family] if "logit_scale" in drop
                      else float(sd["logit_scale"]))
    assert scale == float(np.float32(expected_scale))
    assert bias == (-3.5 if family == "siglip" and "logit_bias" not in drop else 0.0)


@pytest.mark.parametrize("family", list(MODEL))
def test_missing_key_raises_naming_it(family, models, tmp_path):
    sd = dict(models[family].state_dict())
    missing = "vision_model.encoder.layers.1.mlp.fc2.bias"
    del sd[missing]
    wd = save_snapshot(sd, tmp_path / "snap", "bin")
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        load_model(MODEL[family], weights_dir=wd, dtype=torch.float32, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint files"):
        load_model(MODEL[family], weights_dir=tmp_path / "empty", device="cpu")


@pytest.mark.parametrize("family", list(MODEL))
def test_convert_weights_output_loads_to_same_tensors(family, snapshots, tmp_path,
                                                      capsys):
    wd = snapshots[(family, "bf16")]
    out = convert_weights.main(MODEL[family], str(wd), str(tmp_path / "conv"))
    printed = capsys.readouterr().out.splitlines()
    assert sorted(p.name for p in out.iterdir()) == ["head.json", "text.pt", "vision.pt"]
    assert printed[0].startswith("vision: ") and " params -> " in printed[0]
    assert printed[2].startswith("head: scale=")
    a = load_model(MODEL[family], weights_dir=wd, dtype=torch.float32, device="cpu")
    b = load_model(MODEL[family], weights_dir=out, dtype=torch.float32, device="cpu")
    for x, y in zip(a[:2], b[:2]):
        sx, sy = x.module.state_dict(), y.module.state_dict()
        assert set(sx) == set(sy) and all(torch.equal(sx[k], sy[k]) for k in sx)
    assert float(a[2].logit_scale) == float(b[2].logit_scale)
    assert float(a[2].logit_bias) == float(b[2].logit_bias)
    head = json.loads((out / "head.json").read_text())
    assert head == dict(zip(("logit_scale", "logit_bias"), convert.load_logit_scale_bias(
        convert._load_state_dict(wd))))
    # the JAX package's load_model reads the same head from it
    _, _, j_head = jax_load_model(MODEL[family], weights_dir=str(wd), dtype=jnp.float32)
    assert float(j_head.logit_bias) == float(b[2].logit_bias)


@pytest.mark.parametrize("family", list(MODEL))
def test_to_hf_state_dict_inverts_convert(family, models):
    """The port's towers written under HF's names by chip_smoke.py's
    `to_hf_state_dict` (what its snapshot writer saves) give back HF's own
    state dict, from which `convert_*` made them."""
    import chip_smoke

    hf_sd = models[family].state_dict()
    cfg = CONFIGS_BY_NAME[MODEL[family]]
    towers = {t: convert.CONVERTERS[(family, t)](hf_sd, getattr(cfg, t).num_layers)
              for t in ("vision", "text")}
    scale = float(hf_sd["logit_scale"])
    bias = float(hf_sd["logit_bias"]) if family == "siglip" else None
    back = chip_smoke.to_hf_state_dict(family, towers["vision"], towers["text"],
                                       cfg.vision.num_layers, cfg.text.num_layers,
                                       logit_scale=scale, logit_bias=bias)
    extra = {k for k in hf_sd if k.endswith("position_ids")}
    assert set(back) == set(hf_sd) - extra
    for k, v in back.items():
        assert torch.equal(v.reshape(hf_sd[k].shape), hf_sd[k]), k


def test_smoke_writer_is_read_by_safetensors(tmp_path):
    """chip_smoke.py's fp16 snapshot writer makes files the `safetensors`
    package reads, and the port's reader reads them to the same tensors;
    a truncated file is refused."""
    import chip_smoke
    from safetensors.torch import load_file

    gen = torch.Generator().manual_seed(2)
    sd = {"a.weight": torch.randn(5, 3, generator=gen), "b": torch.randn(7, generator=gen),
          "scale": torch.tensor(4.5), "probe": torch.randn(1, 1, 6, generator=gen)}
    path = tmp_path / "model.safetensors"
    assert chip_smoke.write_safetensors_f16(path, sd) == path.stat().st_size
    theirs, ours = load_file(str(path)), convert.read_safetensors(path)
    for k, v in sd.items():
        assert theirs[k].dtype == ours[k].dtype == torch.float16
        assert torch.equal(theirs[k], v.half()) and torch.equal(ours[k], v.half()), k
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError, match="truncated"):
        convert.read_safetensors(path)


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-siglip"])
def test_smoke_snapshot_case_on_the_cpu(model, tmp_path):
    """chip_smoke.py phase 8c's steps at tiny width on the CPU: seeded
    towers written as fp32 `.bin` and fp16 safetensors snapshots read back
    bit for bit, convert_weights, and from_pretrained -> predict from both
    directories equal bit for bit (the card run adds the launch counts)."""
    import chip_smoke

    hd = save_synthetic_hessians(tmp_path / "hessians", CONFIGS_BY_NAME[model], seed=0)
    (tmp_path / "work").mkdir()
    pixels = np.random.default_rng(4).normal(size=(5, 32, 32, 3)).astype(np.float32)
    out = chip_smoke.snapshot_case(torch, model, str(hd), pixels, ["a cat", "a dog", "a bird"],
                                   tmp_path / "work", torch.device("cpu"))
    img, txt, _ = load_model(model, dtype=torch.float32, device="cpu")
    n = sum(p.numel() for enc in (img, txt) for p in enc.module.parameters())
    assert out["params"] == n + 1 + (CONFIGS_BY_NAME[model].family == "siglip")
    assert 2 * out["params"] / 1e6 < out["st_mb"] < 2 * out["params"] / 1e6 + 0.1
    assert not (tmp_path / "work" / "bin" / "pytorch_model.bin").exists()
