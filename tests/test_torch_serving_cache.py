"""The port's persisted serving state (`ProbabilisticVLM.save_serving`,
`load_serving`, `from_serving_cache`), mirroring tests/test_aot_cache.py:
tiny-clip in fp32 on the CPU, the port carrying the JAX towers' weights
(through models/bridge.save_weights) and both packages reading one Hessian
directory. A restored ladder serves what the saved one served (bit for
bit here: the CPU ladder runs the same eager forward) and agrees with the
JAX package's predict at test_torch_pipeline.py's rtol 1e-4 / atol 1e-5;
every signature mismatch is refused with the JAX package's message; a
JAX `.aotserv` pickle and a torn file are refused with a ValueError (the
JAX file's mesh cases: the port has no mesh). The serve_cli --aot_cache
flow is in tests/test_torch_serve_cli.py.

The `cuda` test (restored ladders replaying bit-equal to the saved VLM's
on the card, tiny-clip and tiny-siglip) skips without a GPU; JAX is
imported inside the fixtures that need it, so it runs where JAX is not
installed:
    python -m pytest --noconftest -m cuda tests/test_torch_serving_cache.py
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.io.artifacts import save_hessians, save_prior_precision
from bayesvlm_tpu_torch.models.configs import TINY_CLIP_CONFIG, TINY_SIGLIP_CONFIG
from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
from bayesvlm_tpu_torch.serve import BatchingServer

PROMPTS = [f"An image of a thing {i}" for i in range(4)]
RTOL, ATOL = 1e-4, 1e-5
WAIT = 120


@pytest.fixture(scope="module")
def hessian_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cache_hessians")
    rng = np.random.default_rng(0)

    def spd(d, s=0.5):
        M = rng.normal(size=(d, d)).astype(np.float32)
        return torch.from_numpy(M @ M.T / d * s + np.eye(d, dtype=np.float32))

    P, D, Pt = (TINY_CLIP_CONFIG.vision.hidden_size,
                TINY_CLIP_CONFIG.vision.projection_dim,
                TINY_CLIP_CONFIG.text.hidden_size)
    save_hessians(tmp, spd(P), spd(D), "img")
    save_hessians(tmp, spd(Pt), spd(D), "txt")
    save_prior_precision(tmp, 5.0, 1.0, 5.0, 1.0)
    return tmp


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """The JAX package's seed-0 tiny-clip towers as the port's files."""
    import jax

    from bayesvlm_tpu.models import load_model as jax_load_model
    from bayesvlm_tpu_torch.models.bridge import save_weights

    j_img, j_txt, _ = jax_load_model("tiny-clip", dtype=np.float32, seed=0)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return save_weights(tmp_path_factory.mktemp("torch_cache_weights"),
                        to_np(j_img.params), to_np(j_txt.params))


@pytest.fixture(scope="module")
def jax_predict(hessian_dir):
    """The JAX package's VLM on its general path: what every restored
    ladder is held to."""
    from bayesvlm_tpu.pipeline import ProbabilisticVLM as JaxProbabilisticVLM

    jvlm = JaxProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), dtype="fp32", prior_num_steps=30,
        mesh=None).set_class_prompts(PROMPTS)
    return lambda imgs: np.asarray(jvlm.predict(imgs))


def _make_vlm(hessian_dir, weights_dir, prompts=PROMPTS, **kw):
    return ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), weights_dir=str(weights_dir), dtype="fp32",
        prior_num_steps=30, device="cpu", **kw).set_class_prompts(prompts)


@pytest.fixture(scope="module")
def saved(hessian_dir, weights_dir, tmp_path_factory):
    """A VLM with a float32 ladder [2, 4] and its file."""
    src = _make_vlm(hessian_dir, weights_dir).compile_serving([2, 4])
    path = src.save_serving(tmp_path_factory.mktemp("torch_cache") / "ladder.aotserv")
    return src, path


def _images(n, size=32, seed=1):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def test_roundtrip_matches_saved_ladder_and_jax(saved, hessian_dir, weights_dir,
                                                 jax_predict):
    src, path = saved
    imgs = _images(4)
    expected = src.predict(imgs)
    assert Path(path).exists()
    assert not list(Path(path).parent.glob("*.tmp.*")), "atomic write left a tmp file"
    dst = _make_vlm(hessian_dir, weights_dir)
    assert dst._serving is None
    assert dst.load_serving(path) is dst
    assert sorted(dst._serving["programs"]) == [2, 4]
    assert dst._serving["dtype"] == torch.float32
    replays = dst.replays
    assert torch.equal(dst.predict(imgs), expected)
    assert torch.equal(dst.predict(imgs[:2]), expected[:2])  # the smaller size too
    assert dst.replays == replays + 2 and dst.eager_calls == 0
    np.testing.assert_allclose(expected.numpy(), jax_predict(imgs), rtol=RTOL, atol=ATOL)


def test_file_is_plain_data_with_the_ladders_signature(saved):
    """weights_only=True reads it: tensors, numbers, strings, lists and
    dicts; the signature names every tensor the ladder reads."""
    src, path = saved
    payload = torch.load(path, weights_only=True)
    assert payload["version"] == 2 and payload["mesh"] is None
    assert (payload["platform"], payload["device_kind"], payload["num_devices"]) == (
        "cpu", "cpu", 1)
    assert payload["image_shape"] == [32, 32, 3] and payload["dtype"] == "float32"
    assert payload["batch_sizes"] == [2, 4]
    assert payload["arg_avals"] == [[list(t.shape), str(t.dtype).removeprefix("torch.")]
                                    for t in src._ladder_tensors()]
    runtime = payload["runtime"]
    assert runtime["class_prompts"] == PROMPTS and runtime["info"] == src.info
    assert torch.equal(runtime["label_features"]["embeds"], src._label_features.embeds)
    assert torch.equal(runtime["head"]["source_covariance"]["A_inv"],
                       src.head.source_covariance.A_inv)


def test_batching_server_skips_recapture_after_load(saved, hessian_dir, weights_dir,
                                                    jax_predict):
    _, path = saved
    vlm = _make_vlm(hessian_dir, weights_dir).load_serving(path)
    restored = vlm._serving
    with BatchingServer(vlm, batch_size=4, buckets=[2, 4], max_wait_ms=5.0) as srv:
        assert vlm._serving is restored, "BatchingServer captured the ladder again"
        imgs = _images(3, seed=7)
        got = np.stack([srv.predict(im, timeout=WAIT) for im in imgs])
    np.testing.assert_allclose(got, jax_predict(imgs), rtol=RTOL, atol=ATOL)
    assert vlm.eager_calls == 0


def test_load_requires_class_prompts(saved, hessian_dir, weights_dir):
    _, path = saved
    bare = ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), weights_dir=str(weights_dir), dtype="fp32",
        prior_num_steps=30, device="cpu")
    with pytest.raises(ValueError, match="set_class_prompts"):
        bare.load_serving(path)


def test_save_requires_compiled_ladder(hessian_dir, weights_dir, tmp_path):
    with pytest.raises(ValueError, match="compile_serving"):
        _make_vlm(hessian_dir, weights_dir).save_serving(tmp_path / "l.aotserv")
    assert not list(tmp_path.iterdir())


def test_class_count_mismatch_refused(saved, hessian_dir, weights_dir):
    _, path = saved
    other = _make_vlm(hessian_dir, weights_dir, prompts=PROMPTS + ["An image of a thing 4"])
    with pytest.raises(ValueError, match="shape/dtype mismatch"):
        other.load_serving(path)
    assert other._serving is None


@pytest.mark.parametrize("key, value, match", [
    ("version", 999, "version"),
    ("device_kind", "NVIDIA H100 80GB HBM3", "device_kind"),
    ("platform", "cuda", "platform"),
    ("num_devices", 8, "num_devices"),
    ("image_shape", [224, 224, 3], "image shape"),
    ("arg_avals", [[[3], "float32"]], "structure mismatch"),
], ids=["version", "device_kind", "platform", "num_devices", "image_shape", "structure"])
def test_signature_mismatch_refused(saved, hessian_dir, weights_dir, tmp_path, key,
                                    value, match):
    """Each field of the signature that differs is refused, with the JAX
    package's message (bayesvlm_tpu/pipeline.py:539-596)."""
    _, path = saved
    payload = torch.load(path, weights_only=True)
    torch.save(dict(payload, **{key: value}), tmp_path / "stale.aotserv")
    vlm = _make_vlm(hessian_dir, weights_dir)
    with pytest.raises(ValueError, match=match):
        vlm.load_serving(tmp_path / "stale.aotserv")
    assert vlm._serving is None


def _jax_layout_pickle(path):
    """A pickle in the layout of the JAX package's save_serving (its
    compiled programs as opaque blobs, its treedefs as JAX objects)."""
    import jax

    tree = jax.tree_util.tree_structure(({"w": 0}, None, [0, 0], (0, 0)))
    payload = {"version": 1, "platform": "cpu", "device_kind": "cpu", "num_devices": 1,
               "mesh": None, "image_shape": (32, 32, 3), "dtype": "float32",
               "arg_treedef": tree, "arg_avals": [((4, 8), "float32")],
               "programs": {2: (b"\x00" * 64, tree, tree)}}
    Path(path).write_bytes(pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))


@pytest.mark.parametrize("kind", ["jax-aotserv", "torn", "not-a-dict"])
def test_foreign_and_torn_files_refused(saved, hessian_dir, weights_dir, tmp_path, kind):
    """A JAX .aotserv pickle (by name), a torn file and a file of other
    content raise ValueError, never an unpickling error: serve_cli
    --aot_cache reads a ValueError as "stale" and builds in full."""
    _, path = saved
    bad = tmp_path / "bad.aotserv"
    if kind == "jax-aotserv":
        _jax_layout_pickle(bad)
    elif kind == "torn":
        data = Path(path).read_bytes()
        bad.write_bytes(data[:len(data) // 2])
    else:
        torch.save([1, 2, 3], bad)
    vlm = _make_vlm(hessian_dir, weights_dir)
    for load in (vlm.load_serving,
                 lambda p: ProbabilisticVLM.from_serving_cache(
                     "tiny-clip", p, weights_dir=str(weights_dir), dtype="fp32",
                     device="cpu")):
        with pytest.raises(ValueError, match="JAX package" if kind == "jax-aotserv"
                           else "save_serving file") as refused:
            load(bad)
        assert not isinstance(refused.value, pickle.UnpicklingError)
    with pytest.raises(FileNotFoundError):
        vlm.load_serving(tmp_path / "missing.aotserv")


def test_from_serving_cache_restores_the_serving_state(saved, weights_dir, jax_predict,
                                                        monkeypatch):
    """Labels, prompts, lambdas, the covariance-finalised head and the
    ladder come back from the file, with no Hessian directory, no lambda
    re-opt and no text tower; a label swap works afterwards."""
    from bayesvlm_tpu_torch.bayes import prior
    from bayesvlm_tpu_torch.io import artifacts
    from bayesvlm_tpu_torch.models.encoders import TextEncoder

    src, path = saved
    imgs = _images(4, seed=11)
    expected = src.predict(imgs)

    def refuse(*a, **k):
        raise AssertionError("the restart must not run this")

    with monkeypatch.context() as mp:
        for mod, name in ((artifacts, "load_hessians"), (prior, "optimize_prior_precision"),
                          (TextEncoder, "__call__")):
            mp.setattr(mod, name, refuse)
        vlm = ProbabilisticVLM.from_serving_cache(
            "tiny-clip", path, weights_dir=str(weights_dir), dtype="fp32", device="cpu")
    assert vlm._class_prompts == PROMPTS
    assert vlm.info == src.info
    assert sorted(vlm._serving["programs"]) == [2, 4]
    for f in ("embeds", "activations", "residuals"):
        assert torch.equal(getattr(vlm._label_features, f), getattr(src._label_features, f))
    assert torch.equal(vlm.head.target_covariance.B_inv, src.head.target_covariance.B_inv)
    assert vlm.head.source_projection_has_bias == src.head.source_projection_has_bias
    assert torch.equal(vlm.predict(imgs), expected) and vlm.eager_calls == 0
    np.testing.assert_allclose(expected.numpy(), jax_predict(imgs), rtol=RTOL, atol=ATOL)
    vlm.set_class_prompts(PROMPTS[:3])  # the text tower runs from here on
    assert vlm.predict(imgs).shape == (4, 3) and vlm._class_prompts == PROMPTS[:3]


def test_from_serving_cache_requires_runtime_block(hessian_dir, weights_dir, tmp_path):
    path = _make_vlm(hessian_dir, weights_dir).compile_serving(2).save_serving(
        tmp_path / "bare.aotserv", include_runtime=False)
    assert "runtime" not in torch.load(path, weights_only=True)
    with pytest.raises(ValueError, match="include_runtime"):
        ProbabilisticVLM.from_serving_cache("tiny-clip", path, weights_dir=str(weights_dir),
                                            dtype="fp32", device="cpu")


def test_from_serving_cache_refuses_another_configuration(saved, weights_dir):
    """A file of another dtype or int8 setting (other tensors on the
    ladder) is refused after the towers are built: shapes and dtypes are
    checked, as in JAX."""
    _, path = saved
    with pytest.raises(ValueError, match="mismatch"):
        ProbabilisticVLM.from_serving_cache("tiny-clip", path, weights_dir=str(weights_dir),
                                            dtype="bf16", device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        ProbabilisticVLM.from_serving_cache("tiny-clip", path, weights_dir=str(weights_dir),
                                            dtype="fp32", mlp_int8=True, device="cpu")


def test_build_towers_is_from_pretrained_without_the_posterior(hessian_dir, weights_dir):
    """from_pretrained = _build_towers + the Stage-2 preamble: the same
    tower weights, tokenizer and transform, the head before covariances."""
    vlm = _make_vlm(hessian_dir, weights_dir)
    enc, txt, head, transform = ProbabilisticVLM._build_towers(
        "tiny-clip", str(weights_dir), None, "fp32", False, False, 0, "cpu")
    for a, b in zip(enc.module.state_dict().values(),
                    vlm.image_encoder.module.state_dict().values()):
        assert torch.equal(a, b)
    assert head.source_covariance is None and vlm.head.source_covariance is not None
    assert torch.equal(head.logit_scale, vlm.head.logit_scale)
    np.testing.assert_array_equal(np.asarray(txt.tokenizer(PROMPTS)),
                                  np.asarray(vlm.text_encoder.tokenizer(PROMPTS)))
    from PIL import Image

    image = Image.fromarray(np.random.default_rng(2).integers(0, 256, (40, 48, 3),
                                                              dtype=np.uint8))
    np.testing.assert_array_equal(np.asarray(transform(image)),
                                  np.asarray(vlm.transform(image)))


# -- the restored ladder on the card --------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("model, cfg", [("tiny-clip", TINY_CLIP_CONFIG),
                                        ("tiny-siglip", TINY_SIGLIP_CONFIG)])
def test_restored_ladder_replays_bit_equal_on_card(tmp_path, model, cfg):
    """from_serving_cache and load_serving on the card capture ladders that
    read the same weights, labels and head, so each replay equals the
    saved VLM's replay bit for bit (uint8 ladder [1, 4])."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have no CPU mode)")
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians

    hdir = save_synthetic_hessians(tmp_path / "h", cfg, 0)
    src = ProbabilisticVLM.from_pretrained(model, str(hdir), dtype="fp32",
                                           prior_num_steps=20, device="cuda")
    src.set_class_prompts(PROMPTS).compile_serving([1, 4], input_dtype=torch.uint8)
    u8 = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    want = {b: src.predict(u8[:b]) for b in (1, 4)}
    path = src.save_serving(tmp_path / "s.aotserv")
    payload = torch.load(path, weights_only=True)
    assert payload["platform"] == "cuda"
    assert payload["device_kind"] == torch.cuda.get_device_name(0)
    restored = ProbabilisticVLM.from_serving_cache(model, path, dtype="fp32", device="cuda")
    loaded = ProbabilisticVLM.from_pretrained(model, str(hdir), dtype="fp32",
                                              prior_num_steps=20, device="cuda")
    loaded.set_class_prompts(PROMPTS).load_serving(path)
    for vlm in (restored, loaded):
        for b in (1, 4):
            assert torch.equal(vlm.predict(u8[:b]), want[b]), b
        assert vlm.replays == 2 and vlm.eager_calls == 0
