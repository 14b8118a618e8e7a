"""The port's SigLIP towers and pipeline against the JAX package's, at
tiny-siglip size in fp32 with the JAX weights carried over by
`models/bridge.py`. Tolerances: the towers' (rtol 2e-3 / atol 2e-4, as
tests/test_torch_towers.py) and the pipeline's (rtol 1e-4 / atol 1e-5,
as tests/test_torch_pipeline.py). The attention kernel at SigLIP's
T = 256 is held on the card in tests/test_torch_attention.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesvlm_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from bayesvlm_tpu.io.artifacts import load_hessians as jax_load_hessians
from bayesvlm_tpu.models import load_model as jax_load_model
from bayesvlm_tpu.models.encoders import cast_gemm_params as jax_cast_gemm_params
from bayesvlm_tpu.pipeline import ProbabilisticVLM as JaxProbabilisticVLM
from bayesvlm_tpu_torch.io.artifacts import kfac_dims, save_synthetic_hessians
from bayesvlm_tpu_torch.models import load_model
from bayesvlm_tpu_torch.models.attention import fused_attention
from bayesvlm_tpu_torch.models.bridge import (
    save_weights,
    siglip_text_state_dict,
    siglip_vision_state_dict,
)
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME, TINY_SIGLIP_CONFIG
from bayesvlm_tpu_torch.models.encoders import cast_gemm_params
from bayesvlm_tpu_torch.models.layers import MultiHeadAttention
from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

RTOL, ATOL = 2e-3, 2e-4
PROMPTS = [f"An image of a thing {i}" for i in range(5)]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _pixels(n=3, seed=0, size=32):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    j_img, j_txt, j_head = jax_load_model("tiny-siglip", dtype=jnp.float32, seed=0)
    wd = save_weights(tmp_path_factory.mktemp("siglip_bridged"),
                      _np_tree(j_img.params), _np_tree(j_txt.params))
    t_img, t_txt, t_head = load_model("tiny-siglip", weights_dir=wd,
                                      dtype=torch.float32, device="cpu")
    return j_img, j_txt, j_head, t_img, t_txt, t_head


def test_image_tower_matches_jax(towers):
    j_img, _, _, t_img, _, _ = towers
    x = _pixels()
    ref = j_img(jnp.asarray(x))
    out = t_img(x)
    for name in ("embeds", "activations", "residuals"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    # the attention-pool skip is real, and embeds = head_fc2(act) + residuals
    assert float(out.residuals.abs().sum()) > 0
    fc2 = t_img.module.head_fc2
    torch.testing.assert_close(out.embeds, fc2(out.activations) + out.residuals)


def test_text_tower_matches_jax(towers):
    _, j_txt, _, _, t_txt, _ = towers
    cfg = TINY_SIGLIP_CONFIG.text
    prompts = ["a photo of a cat", "a dog", "one two three four five six "
               "seven eight nine ten eleven twelve thirteen fourteen"]
    ids = JaxHashTokenizer(cfg.vocab_size, cfg.max_length,
                           eos_id=cfg.eos_token_id)(prompts)
    ref = j_txt(jnp.asarray(ids))
    out = t_txt(ids)
    np.testing.assert_allclose(out.activations.numpy(), np.asarray(ref.activations),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.embeds.numpy(), np.asarray(ref.embeds),
                               rtol=RTOL, atol=ATOL)


def test_bridge_covers_every_parameter(towers):
    j_img, j_txt, _, t_img, t_txt, _ = towers
    vsd = siglip_vision_state_dict(_np_tree(j_img.params))
    tsd = siglip_text_state_dict(_np_tree(j_txt.params))
    assert vsd.keys() == t_img.module.state_dict().keys()
    assert tsd.keys() == t_txt.module.state_dict().keys()
    n_jax = sum(leaf.size for leaf in jax.tree_util.tree_leaves(j_img.params))
    assert sum(v.numel() for v in vsd.values()) == n_jax
    np.testing.assert_array_equal(t_img.module.probe.detach().numpy(),
                                  np.asarray(j_img.params["probe"]))
    np.testing.assert_array_equal(t_img.module.head_fc2.weight.detach().numpy(),
                                  np.asarray(j_img.params["head_fc2"]["kernel"]).T)
    np.testing.assert_array_equal(
        t_img.module.head_attention.k_proj.weight.detach().numpy(),
        np.asarray(j_img.params["head_attention"]["k_proj"]["kernel"]).T)
    np.testing.assert_array_equal(t_img.module.patch_embedding.bias.detach().numpy(),
                                  np.asarray(j_img.params["patch_embedding"]["bias"]))
    np.testing.assert_array_equal(t_txt.module.head.bias.detach().numpy(),
                                  np.asarray(j_txt.params["head"]["bias"]))


@pytest.mark.parametrize("tower", ["image", "text"])
def test_projection_l2_and_num_params_match_jax(towers, tower):
    """The projection the lambda re-optimisation reads: head_fc2 / head,
    weight and bias."""
    j_img, j_txt, _, t_img, t_txt, _ = towers
    j, t = (j_img, t_img) if tower == "image" else (j_txt, t_txt)
    assert t.projection_num_params() == j.projection_num_params()
    cfg = TINY_SIGLIP_CONFIG
    d_in = cfg.vision.mlp_dim if tower == "image" else cfg.text.hidden_size
    assert t.projection_num_params() == (d_in + 1) * cfg.vision.projection_dim
    assert t.projection_l2() == pytest.approx(j.projection_l2(), rel=1e-6)


def test_head_constants_match_jax(towers):
    _, _, j_head, _, _, t_head = towers
    assert float(t_head.logit_scale) == pytest.approx(float(j_head.logit_scale))
    assert float(t_head.logit_bias) == pytest.approx(float(j_head.logit_bias))
    assert t_head.source_projection_has_bias and t_head.target_projection_has_bias


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_cast_gemm_params_matches_jax_split(towers, tower):
    """The probe attention's q/k/v/out_proj go to the compute dtype with the
    encoder's GEMMs; head_fc1 / head_fc2, LN, embeddings and the text head
    stay fp32, as the JAX package's key-name rule casts them."""
    j_img, j_txt, _, _, _, _ = towers
    jax_cast = jax_cast_gemm_params((j_img if tower == "vision" else j_txt).params,
                                    jnp.bfloat16)
    jax_bf16 = sum(int(leaf.dtype == jnp.bfloat16) * leaf.size
                   for leaf in jax.tree_util.tree_leaves(jax_cast))
    img, txt, _ = load_model("tiny-siglip", dtype=torch.float32, device="cpu")
    module = cast_gemm_params((img if tower == "vision" else txt).module,
                              torch.bfloat16)
    assert sum(p.numel() for p in module.parameters()
               if p.dtype == torch.bfloat16) == jax_bf16
    if tower == "vision":
        assert module.head_attention.q_proj.weight.dtype == torch.bfloat16
        assert module.head_fc1.weight.dtype == torch.float32
        assert module.head_fc2.bias.dtype == torch.float32


def test_attention_routes(towers, monkeypatch):
    """Only the vision encoder's self-attention reaches the kernel: the
    probe's cross-attention and the bidirectional text tower take the plain
    path (as the JAX towers do)."""
    import bayesvlm_tpu_torch.models.layers as layers_mod

    _, _, _, t_img, t_txt, _ = towers
    assert all(layer.self_attn.use_kernel for layer in t_img.module.encoder.layers)
    assert not any(layer.self_attn.use_kernel for layer in t_txt.module.encoder.layers)
    query_lengths = []

    def counting(q, k, v, num_heads):
        query_lengths.append(q.shape[1])
        return fused_attention(q, k, v, num_heads)

    monkeypatch.setattr(layers_mod, "fused_attention", counting)
    t_img(_pixels(n=2))
    cfg = TINY_SIGLIP_CONFIG.text
    t_txt(JaxHashTokenizer(cfg.vocab_size, cfg.max_length,
                           eos_id=cfg.eos_token_id)(["a", "b"]))
    vision = TINY_SIGLIP_CONFIG.vision
    assert query_lengths == [vision.num_patches] * vision.num_layers


def test_cross_attention_matches_plain_math():
    torch.manual_seed(0)
    mha = MultiHeadAttention(16, 2, use_kernel=False)
    q_in, kv = torch.randn(3, 1, 16), torch.randn(3, 9, 16)
    out = mha(q_in, keys_values=kv)
    q = mha.q_proj(q_in).reshape(3, 1, 2, 8).transpose(1, 2)
    k = mha.k_proj(kv).reshape(3, 9, 2, 8).transpose(1, 2)
    v = mha.v_proj(kv).reshape(3, 9, 2, 8).transpose(1, 2)
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(8), dim=-1)
    ref = mha.out_proj((p @ v).transpose(1, 2).reshape(3, 1, 16))
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)


def test_fused_attention_refuses_unequal_query_and_key_lengths():
    q, kv = torch.randn(2, 1, 16), torch.randn(2, 9, 16)
    with pytest.raises(ValueError, match="Tq"):
        fused_attention(q, kv, kv, 2)


@pytest.mark.parametrize("model", sorted(CONFIGS_BY_NAME))
def test_synthetic_hessian_dims(model):
    """A factors: the projection's input dim, plus SigLIP's ones column
    (the JAX bench recipe, bench.py:968-971); B factors: the projection
    dim."""
    cfg = CONFIGS_BY_NAME[model]
    bias = int(cfg.family == "siglip")
    a_img = (cfg.vision.mlp_dim if bias else cfg.vision.hidden_size) + bias
    D = cfg.vision.projection_dim
    assert kfac_dims(cfg) == {"img": (a_img, D), "txt": (cfg.text.hidden_size + bias, D)}


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-siglip"])
def test_synthetic_hessians_load_in_both_packages(model, tmp_path):
    from bayesvlm_tpu_torch.io.artifacts import load_hessians

    cfg = CONFIGS_BY_NAME[model]
    save_synthetic_hessians(tmp_path, cfg, seed=0)
    for tag, (a_dim, b_dim) in kfac_dims(cfg).items():
        A, B = jax_load_hessians(tmp_path, tag)
        assert A.shape == (a_dim, a_dim) and B.shape == (b_dim, b_dim)
        A_t, B_t = load_hessians(tmp_path, tag)
        np.testing.assert_array_equal(A_t.numpy(), np.asarray(A))
        assert float(torch.linalg.eigvalsh(A_t).min()) > 0


# -- the pipeline ---------------------------------------------------------------


@pytest.fixture(scope="module")
def hessian_dir(tmp_path_factory):
    return save_synthetic_hessians(tmp_path_factory.mktemp("siglip_hessians"),
                                   TINY_SIGLIP_CONFIG, seed=0)


def _vlms(hessian_dir, wd_root, **lanes):
    jvlm = JaxProbabilisticVLM.from_pretrained(
        "tiny-siglip", str(hessian_dir), dtype="fp32", mesh=None, **lanes)
    wd = save_weights(wd_root, _np_tree(jvlm.image_encoder.params),
                      _np_tree(jvlm.text_encoder.params))
    tvlm = ProbabilisticVLM.from_pretrained(
        "tiny-siglip", str(hessian_dir), weights_dir=str(wd), dtype="fp32",
        device="cpu", **lanes)
    return jvlm.set_class_prompts(PROMPTS), tvlm.set_class_prompts(PROMPTS)


@pytest.fixture(scope="module")
def vlms(hessian_dir, tmp_path_factory):
    return _vlms(hessian_dir, tmp_path_factory.mktemp("siglip_weights"))


def test_lambdas_match_jax(vlms):
    jvlm, tvlm = vlms
    for key in ("lambda_img", "lambda_txt"):
        assert tvlm.info[key] == pytest.approx(jvlm.info[key], rel=1e-4)
        assert tvlm.info[key] != pytest.approx(300.0, rel=1e-2)


def test_predict_matches_jax(vlms):
    jvlm, tvlm = vlms
    imgs = _pixels(n=6, seed=1)
    ref = np.asarray(jvlm.predict(imgs))
    probs = tvlm.predict(imgs)
    assert probs.shape == (6, len(PROMPTS))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_predict_takes_pil_images_through_the_family_transform(vlms):
    from PIL import Image

    jvlm, tvlm = vlms
    rng = np.random.default_rng(5)
    images = [Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
              for _ in range(3)]
    ref = np.asarray(jvlm.predict(images))
    np.testing.assert_allclose(tvlm.predict(images).numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def int8_vlms(hessian_dir, tmp_path_factory):
    return _vlms(hessian_dir, tmp_path_factory.mktemp("siglip_int8_weights"),
                 mlp_int8=True, attn_int8=True, prior_num_steps=100)


def test_int8_predict_matches_jax(int8_vlms, vlms):
    """The W8A8 lanes reach SigLIP's vision encoder (not its probe
    attention): the tolerance of test_torch_pipeline.py's int8 test, for
    the same reason. Both packages quantize the same fp32 weights bit for
    bit; on these inputs no activation lands within an ulp of an int8
    rounding boundary, so only fp32 summation order differs (measured
    max |dp| 2e-6). Inputs that do (one image of seed 2 here) flip one
    int8 step and move that image's embedding by ~5e-3; the kernel tests
    bound flips on their own."""
    jvlm, tvlm = int8_vlms
    mlp = tvlm.image_encoder.module.encoder.layers[0].mlp
    assert mlp.use_int8 and mlp.w1q is not None
    assert not tvlm.image_encoder.module.head_attention.use_int8_proj
    imgs = _pixels(n=6, seed=3)
    ref = np.asarray(jvlm.predict(imgs))
    probs = tvlm.predict(imgs)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), ref, rtol=1e-4, atol=1e-5)
    _, float_vlm = vlms
    assert not torch.allclose(float_vlm.encode_images(imgs).embeds,
                              tvlm.encode_images(imgs).embeds, atol=1e-5)


# -- the trained head (head.json) -------------------------------------------------


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-siglip"])
def test_head_json_gives_jax_head_and_probs(model, tmp_path):
    """One tree written both ways with a trained head (scale 2.5, bias
    -3.0) away from the defaults: the JAX layout as
    scripts/convert_weights.py writes it (flax msgpack + head.json), the
    port's through bridge.save_weights. Both packages' loaders give the
    same head (CLIP keeps no bias) and the same probabilities; without
    head.json the port keeps the family's default head."""
    import json

    from flax import serialization

    from bayesvlm_tpu_torch.models.encoders import DEFAULT_LOGIT_BIAS, DEFAULT_LOGIT_SCALE

    cfg = CONFIGS_BY_NAME[model]
    j_img, j_txt, _ = jax_load_model(model, dtype=jnp.float32, seed=3)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    for name, tower in (("vision", j_img), ("text", j_txt)):
        (jax_dir / f"{name}.msgpack").write_bytes(
            serialization.msgpack_serialize(_np_tree(tower.params)))
    (jax_dir / "head.json").write_text(json.dumps({"logit_scale": 2.5,
                                                   "logit_bias": -3.0}))
    save_weights(port_dir, _np_tree(j_img.params), _np_tree(j_txt.params),
                 logit_scale=2.5, logit_bias=-3.0)
    assert json.loads((port_dir / "head.json").read_text()) == {
        "logit_scale": 2.5, "logit_bias": -3.0}

    bias = -3.0 if cfg.family == "siglip" else 0.0
    _, _, j_head = jax_load_model(model, weights_dir=str(jax_dir), dtype=jnp.float32)
    _, _, t_head = load_model(model, weights_dir=port_dir, dtype=torch.float32,
                              device="cpu")
    assert float(j_head.logit_scale) == float(t_head.logit_scale) == 2.5
    assert float(j_head.logit_bias) == float(t_head.logit_bias) == bias

    hdir = save_synthetic_hessians(tmp_path / "hessians", cfg, seed=0)
    jvlm = JaxProbabilisticVLM.from_pretrained(
        model, str(hdir), weights_dir=str(jax_dir), dtype="fp32", mesh=None,
        prior_num_steps=50).set_class_prompts(PROMPTS)
    tvlm = ProbabilisticVLM.from_pretrained(
        model, str(hdir), weights_dir=str(port_dir), dtype="fp32", device="cpu",
        prior_num_steps=50).set_class_prompts(PROMPTS)
    imgs = _pixels(n=4, seed=2, size=cfg.vision.image_size)
    np.testing.assert_allclose(tvlm.predict(imgs).numpy(), np.asarray(jvlm.predict(imgs)),
                               rtol=1e-4, atol=1e-5)

    # a directory without head.json (as written before the file was added)
    bare = save_weights(tmp_path / "bare", _np_tree(j_img.params), _np_tree(j_txt.params))
    assert not (bare / "head.json").exists()
    _, _, d_head = load_model(model, weights_dir=bare, dtype=torch.float32, device="cpu")
    assert float(d_head.logit_scale) == pytest.approx(DEFAULT_LOGIT_SCALE[cfg.family])
    assert float(d_head.logit_bias) == pytest.approx(DEFAULT_LOGIT_BIAS[cfg.family])
