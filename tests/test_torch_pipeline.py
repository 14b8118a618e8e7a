"""The whole Stage-2 slice: the port's `ProbabilisticVLM` against the JAX
package's, tiny-clip in fp32, the same bridged weights and the same
Hessian directory; and the port's independence from JAX."""

import ast
import inspect
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bayesvlm_tpu.io.artifacts import save_hessians, save_prior_precision
from bayesvlm_tpu.models.configs import TINY_CLIP_CONFIG
from bayesvlm_tpu.pipeline import ProbabilisticVLM as JaxProbabilisticVLM
from bayesvlm_tpu_torch.models.bridge import save_weights
from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

REPO = Path(__file__).resolve().parent.parent
PROMPTS = [f"An image of a thing {i}" for i in range(4)]


@pytest.fixture(scope="module")
def hessian_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipeline_hessians")
    rng = np.random.default_rng(0)

    def spd(d, s=0.5):
        M = rng.normal(size=(d, d)).astype(np.float32)
        return M @ M.T / d * s + np.eye(d, dtype=np.float32)

    P, D, Pt = (TINY_CLIP_CONFIG.vision.hidden_size,
                TINY_CLIP_CONFIG.vision.projection_dim,
                TINY_CLIP_CONFIG.text.hidden_size)
    save_hessians(tmp, spd(P), spd(D), "img")
    save_hessians(tmp, spd(Pt), spd(D), "txt")
    save_prior_precision(tmp, 5.0, 1.0, 5.0, 1.0)
    return tmp


@pytest.fixture(scope="module")
def vlms(hessian_dir, tmp_path_factory):
    """JAX and port VLMs through from_pretrained with the defaults of the
    Stage-2 chain (1000 lambda steps), the port's towers carrying the JAX
    towers' weights."""
    jvlm = JaxProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), dtype="fp32", mesh=None)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    wd = save_weights(tmp_path_factory.mktemp("torch_pipeline_weights"),
                      to_np(jvlm.image_encoder.params),
                      to_np(jvlm.text_encoder.params))
    tvlm = ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), weights_dir=str(wd), dtype="fp32",
        device="cpu")
    return jvlm.set_class_prompts(PROMPTS), tvlm.set_class_prompts(PROMPTS)


def _images(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 32, 32, 3)).astype(np.float32)


def test_lambdas_match_jax(vlms):
    jvlm, tvlm = vlms
    for key in ("lambda_img", "lambda_txt"):
        assert tvlm.info[key] == pytest.approx(jvlm.info[key], rel=1e-4)
        assert tvlm.info[key] != pytest.approx(300.0, rel=1e-2)


def test_predict_matches_jax(vlms):
    # fp32 throughout: towers, lambda, inverses and head each differ from
    # the JAX package by summation order only
    jvlm, tvlm = vlms
    imgs = _images()
    ref = np.asarray(jvlm.predict(imgs))
    probs = tvlm.predict(imgs)
    assert probs.shape == (6, 4)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), ref, rtol=1e-4, atol=1e-5)
    # class prompts passed per call give the same answer as cached ones
    np.testing.assert_allclose(tvlm.predict(imgs, class_prompts=PROMPTS).numpy(),
                               probs.numpy(), rtol=0, atol=0)


def test_logits_match_jax_in_batches(vlms):
    jvlm, tvlm = vlms
    imgs = _images(n=7, seed=2)
    ref = jvlm.logits(imgs, batch_size=3)
    out = tvlm.logits(imgs, batch_size=3)
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(ref.mean),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.var.numpy(), np.asarray(ref.var),
                               rtol=1e-4, atol=1e-5)


def test_mc_predict_matches_jax_in_distribution(vlms):
    # different generators: each entry's MC std is at most 0.5/sqrt(S),
    # S = 20000 -> the difference of two estimates has std < 0.005
    jvlm, tvlm = vlms
    imgs = _images(n=3, seed=3)
    S = 20000
    ref = np.asarray(jvlm.predict(imgs, num_samples=S, seed=3))
    mc = tvlm.predict(imgs, num_samples=S, seed=3).numpy()
    np.testing.assert_allclose(mc, ref, atol=0.03)
    assert not np.allclose(mc, tvlm.predict(imgs).numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def int8_vlms(hessian_dir, tmp_path_factory):
    """Both packages' VLMs with the vision tower's W8A8 lanes (mlp_int8 +
    attn_int8), fp32, the port carrying the JAX towers' weights. 100
    lambda steps: the lambdas do not depend on the lanes."""
    jvlm = JaxProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), dtype="fp32", mesh=None,
        mlp_int8=True, attn_int8=True, prior_num_steps=100)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    wd = save_weights(tmp_path_factory.mktemp("torch_pipeline_int8_weights"),
                      to_np(jvlm.image_encoder.params),
                      to_np(jvlm.text_encoder.params))
    tvlm = ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), weights_dir=str(wd), dtype="fp32",
        mlp_int8=True, attn_int8=True, prior_num_steps=100, device="cpu")
    return jvlm.set_class_prompts(PROMPTS), tvlm.set_class_prompts(PROMPTS)


def test_int8_predict_matches_jax(int8_vlms, vlms):
    """The int8 lane end to end. Tolerance: the fp32 one of
    test_predict_matches_jax. Both packages quantize the same fp32
    weights bit for bit (test_torch_mlp_int8.py), and on these inputs no
    activation lands within an ulp of an int8 rounding boundary, so every
    int8 step agrees and only fp32 summation order differs (measured
    max |dp| 4.5e-7). A flipped step would show here; the kernel tests
    bound flips on their own."""
    jvlm, tvlm = int8_vlms
    mlp = tvlm.image_encoder.module.encoder.layers[0].mlp
    assert mlp.use_int8 and mlp.w1q is not None  # prequantized
    imgs = _images()
    ref = np.asarray(jvlm.predict(imgs))
    probs = tvlm.predict(imgs)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), ref, rtol=1e-4, atol=1e-5)
    # the lane was taken: the float lane (the same seed-0 weights) embeds
    # the images otherwise
    _, float_vlm = vlms
    assert not torch.allclose(float_vlm.encode_images(imgs).embeds,
                              tvlm.encode_images(imgs).embeds, atol=1e-5)


def test_entry_points_default_to_the_card():
    """The port runs on the card unless the caller asks for another
    device; the CPU tests all pass device="cpu"."""
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead

    for fn in (ProbabilisticVLM.from_pretrained, load_model,
               ProbabilisticHead.create):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_package_source_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "bayesvlm_tpu")
    for path in (REPO / "bayesvlm_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {name}"


def test_slice_runs_without_jax(hessian_dir):
    """A fresh interpreter imports the package and runs the whole slice
    without ever loading JAX, flax, optax or the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import bayesvlm_tpu_torch
        from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
        vlm = ProbabilisticVLM.from_pretrained(
            "tiny-clip", {str(hessian_dir)!r}, dtype="fp32",
            prior_num_steps=5, device="cpu")
        vlm.set_class_prompts(["a cat", "a dog"])
        probs = vlm.predict(np.zeros((2, 32, 32, 3), np.float32))
        assert probs.shape == (2, 2)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                         "bayesvlm_tpu")]
        assert not loaded, loaded
        print("NO_JAX_OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
