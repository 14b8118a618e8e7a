"""Port's CLIP towers (`bayesvlm_tpu_torch.models`) against the JAX
package's, at tiny-clip size in fp32, with the JAX weights carried over
by `models/bridge.py`. Tolerance: the JAX towers' own HF-parity
tolerance (tests/test_hf_parity.py, rtol 2e-3 / atol 2e-4) — the same
contract, another framework's kernels and summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesvlm_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from bayesvlm_tpu.models import load_model as jax_load_model
from bayesvlm_tpu.models.encoders import cast_gemm_params as jax_cast_gemm_params
from bayesvlm_tpu_torch.data.tokenizer import HashTokenizer
from bayesvlm_tpu_torch.models import load_model
from bayesvlm_tpu_torch.models.bridge import (
    clip_text_state_dict,
    clip_vision_state_dict,
    save_weights,
)
from bayesvlm_tpu_torch.models.configs import TINY_CLIP_CONFIG
from bayesvlm_tpu_torch.models.encoders import cast_gemm_params

RTOL = 2e-3
ATOL = 2e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """JAX tiny-clip encoders (fp32, seed 0) and the port's, loaded from
    the bridged weights."""
    j_img, j_txt, _ = jax_load_model("tiny-clip", dtype=jnp.float32, seed=0)
    wd = save_weights(tmp_path_factory.mktemp("bridged"),
                      _np_tree(j_img.params), _np_tree(j_txt.params))
    t_img, t_txt, _ = load_model("tiny-clip", weights_dir=wd,
                                 dtype=torch.float32, device="cpu")
    return j_img, j_txt, t_img, t_txt


def _pixels(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 32, 32, 3)).astype(np.float32)


def test_image_tower_matches_jax(towers):
    j_img, _, t_img, _ = towers
    x = _pixels()
    ref = j_img(jnp.asarray(x))
    out = t_img(x)
    np.testing.assert_allclose(out.activations.numpy(),
                               np.asarray(ref.activations), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.embeds.numpy(), np.asarray(ref.embeds),
                               rtol=RTOL, atol=ATOL)
    assert not out.residuals.any()


def test_image_tower_takes_nchw(towers):
    _, _, t_img, _ = towers
    x = _pixels(seed=1)
    nhwc = t_img(x)
    nchw = t_img(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    torch.testing.assert_close(nchw.embeds, nhwc.embeds, rtol=0, atol=0)


def test_text_tower_matches_jax(towers):
    _, j_txt, _, t_txt = towers
    cfg = TINY_CLIP_CONFIG.text
    prompts = ["a photo of a cat", "a dog", "one two three four five six "
               "seven eight nine ten eleven twelve thirteen fourteen"]
    ids = JaxHashTokenizer(cfg.vocab_size, cfg.max_length,
                           eos_id=cfg.eos_token_id)(prompts)
    ref = j_txt(jnp.asarray(ids))
    out = t_txt(ids)
    np.testing.assert_allclose(out.activations.numpy(),
                               np.asarray(ref.activations), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.embeds.numpy(), np.asarray(ref.embeds),
                               rtol=RTOL, atol=ATOL)


def test_hash_tokenizer_ids_match_jax():
    cfg = TINY_CLIP_CONFIG.text
    prompts = ["An image of a Cat", "", "x " * 40, "a photo of a dog"]
    ours = HashTokenizer(cfg.vocab_size, cfg.max_length,
                         eos_id=cfg.eos_token_id)(prompts)
    theirs = JaxHashTokenizer(cfg.vocab_size, cfg.max_length,
                              eos_id=cfg.eos_token_id)(prompts)
    np.testing.assert_array_equal(ours, theirs)


def test_bridge_covers_every_parameter(towers):
    # strict load_state_dict already refused missing/unexpected keys in
    # the fixture; here: the projection and per-layer weights landed
    # transposed, and the bridged state dicts are exactly the modules'
    j_img, j_txt, t_img, t_txt = towers
    vsd = clip_vision_state_dict(_np_tree(j_img.params))
    tsd = clip_text_state_dict(_np_tree(j_txt.params))
    assert vsd.keys() == t_img.module.state_dict().keys()
    assert tsd.keys() == t_txt.module.state_dict().keys()
    np.testing.assert_array_equal(
        t_img.module.visual_projection.weight.numpy(),
        np.asarray(j_img.params["visual_projection"]["kernel"]).T)
    np.testing.assert_array_equal(
        t_txt.module.encoder.layers[1].mlp.fc1.weight.numpy(),
        np.asarray(j_txt.params["encoder"]["layers"]["block"]["mlp"]["fc1"]
                   ["kernel"][1]).T)
    assert t_img.projection_num_params() == j_img.projection_num_params()
    assert t_img.projection_l2() == pytest.approx(j_img.projection_l2(),
                                                  rel=1e-6)


def test_cast_gemm_params_matches_jax_split(towers):
    """The same parameters go to the compute dtype in both packages: the
    q/k/v/out/fc1/fc2 weights and biases; LN, embeddings and the
    projection stay fp32."""
    j_img, _, _, _ = towers
    jax_cast = jax_cast_gemm_params(j_img.params, jnp.bfloat16)
    jax_bf16 = sum(int(leaf.dtype == jnp.bfloat16) * leaf.size
                   for leaf in jax.tree_util.tree_leaves(jax_cast))
    t_img, _, _ = load_model("tiny-clip", dtype=torch.bfloat16, device="cpu")
    cast_gemm_params(t_img.module, torch.bfloat16)
    ours_bf16 = sum(p.numel() for p in t_img.module.parameters()
                    if p.dtype == torch.bfloat16)
    assert ours_bf16 == jax_bf16
    assert t_img.module.visual_projection.weight.dtype == torch.float32
    assert t_img.module.encoder.layers[0].layer_norm1.weight.dtype == torch.float32


def test_bf16_tower_stays_close_to_fp32(towers):
    """bf16 compute with fp32 LN/softmax/projection tracks the fp32 tower
    (tanh-GELU in bf16, as in the JAX package)."""
    _, _, t_img, _ = towers
    wd_img, _, _ = load_model("tiny-clip", dtype=torch.bfloat16, device="cpu")
    wd_img.module.load_state_dict(
        {k: v.to(wd_img.module.state_dict()[k].dtype)
         for k, v in t_img.module.state_dict().items()})
    x = _pixels(seed=2)
    ref = t_img(x).embeds
    out = wd_img(x).embeds
    assert out.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(out, ref, dim=-1)
    assert float(cos.min()) > 0.99
