"""The port's serving mesh (`serving_mesh.ServingMesh`, the mesh paths of
`pipeline.ProbabilisticVLM` and `serve.BatchingServer`) against the JAX
package's batch-sharded serving, tiny-clip in fp32 on the CPU: the port
on a two-replica mesh ["cpu", "cpu"], JAX on a 2-device virtual CPU mesh,
both with the JAX towers' weights (models/bridge.save_weights) and one
Hessian directory. Probabilities agree at test_torch_pipeline.py's rtol
1e-4 / atol 1e-5 (fp32; the packages differ by summation order). Within
the port the sharded output equals its own row-block forwards, and the
ladder equals the sharded general path, bit for bit (the same ops on
the same rows)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.io.artifacts import save_hessians, save_prior_precision
from bayesvlm_tpu_torch.models.configs import TINY_CLIP_CONFIG
from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
from bayesvlm_tpu_torch.serve import BatchingServer
from bayesvlm_tpu_torch.serving_mesh import ServingMesh, resolve_serving_mesh

PROMPTS = [f"An image of a thing {i}" for i in range(4)]
RTOL, ATOL = 1e-4, 1e-5
MESH = ["cpu", "cpu"]
WAIT = 120


@pytest.fixture(scope="module")
def hessian_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mesh_hessians")
    rng = np.random.default_rng(0)

    def spd(d, s=0.5):
        M = rng.normal(size=(d, d)).astype(np.float32)
        return M @ M.T / d * s + np.eye(d, dtype=np.float32)

    P, D, Pt = (TINY_CLIP_CONFIG.vision.hidden_size,
                TINY_CLIP_CONFIG.vision.projection_dim,
                TINY_CLIP_CONFIG.text.hidden_size)
    save_hessians(tmp, torch.from_numpy(spd(P)), torch.from_numpy(spd(D)), "img")
    save_hessians(tmp, torch.from_numpy(spd(Pt)), torch.from_numpy(spd(D)), "txt")
    save_prior_precision(tmp, 5.0, 1.0, 5.0, 1.0)
    return tmp


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    import jax

    from bayesvlm_tpu.models import load_model as jax_load_model
    from bayesvlm_tpu_torch.models.bridge import save_weights

    j_img, j_txt, _ = jax_load_model("tiny-clip", dtype=np.float32, seed=0)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    return save_weights(tmp_path_factory.mktemp("torch_mesh_weights"),
                        to_np(j_img.params), to_np(j_txt.params))


def _port_vlm(hessian_dir, weights_dir, mesh=MESH):
    return ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), weights_dir=str(weights_dir), dtype="fp32",
        prior_num_steps=30, device="cpu", mesh=mesh).set_class_prompts(PROMPTS)


@pytest.fixture(scope="module")
def jax_mesh_vlm(hessian_dir):
    import jax

    from bayesvlm_tpu.dist.mesh import make_mesh
    from bayesvlm_tpu.pipeline import ProbabilisticVLM as JaxProbabilisticVLM

    return JaxProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), dtype="fp32", prior_num_steps=30,
        mesh=make_mesh(jax.devices()[:2])).set_class_prompts(PROMPTS)


@pytest.fixture(scope="module")
def vlm(hessian_dir, weights_dir):
    return _port_vlm(hessian_dir, weights_dir)


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _row_blocks(vlm, x, n=2):
    """The serving forward a row block a replica, concatenated."""
    reps = vlm._replicas()
    rows = x.shape[0] // n
    return torch.cat([vlm._serve_forward(
        torch.as_tensor(x[i * rows:(i + 1) * rows]).to(rep.device), rep)
        for i, rep in enumerate(reps)])


def test_mesh_ladder_matches_jax_and_its_row_blocks(vlm, jax_mesh_vlm):
    assert vlm.mesh.devices == (torch.device("cpu"),) * 2
    assert len(vlm._replicas()) == 2
    imgs = _images(4, seed=2)
    vlm._serving = None
    eager = vlm.predict(imgs)  # the sharded general path
    calls = vlm.eager_calls
    vlm.compile_serving([2, 4])
    served = {b: vlm.predict(imgs[:b]) for b in (2, 4)}
    assert vlm.eager_calls == calls and sorted(vlm._serving["programs"]) == [2, 4]
    assert torch.equal(served[4], eager)
    for b in (2, 4):
        assert torch.equal(served[b], _row_blocks(vlm, imgs[:b]))
    jax_mesh_vlm.compile_serving([2, 4])
    for b in (2, 4):
        np.testing.assert_allclose(served[b].numpy(), np.asarray(
            jax_mesh_vlm.predict(imgs[:b])), rtol=RTOL, atol=ATOL)


def test_mesh_general_path_matches_unsharded(vlm, hessian_dir, weights_dir):
    """An odd batch (padded to the mesh's size, the padding cut), in
    chunks of max(batch_size, n), against the same VLM without a mesh."""
    imgs = _images(5, seed=3)
    plain = _port_vlm(hessian_dir, weights_dir, mesh=None)
    assert plain.mesh is None
    got = vlm.predict(imgs, batch_size=3)
    np.testing.assert_allclose(got.numpy(), plain.predict(imgs).numpy(),
                               rtol=RTOL, atol=ATOL)
    feats = vlm.encode_images(imgs, batch_size=2)
    want = plain.encode_images(imgs)
    np.testing.assert_allclose(feats.embeds.numpy(), want.embeds.numpy(),
                               rtol=RTOL, atol=ATOL)
    other = [f"another thing {i}" for i in range(3)]
    np.testing.assert_allclose(vlm.logits(imgs, other).mean.numpy(),
                               plain.logits(imgs, other).mean.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_mesh_refusals_match_jax(vlm, jax_mesh_vlm):
    with pytest.raises(ValueError) as ours:
        vlm.compile_serving([2, 3])
    with pytest.raises(ValueError) as theirs:
        jax_mesh_vlm.compile_serving([2, 3])
    assert str(ours.value) == str(theirs.value) == (
        "compile_serving on a 2-way 'data' mesh needs batch sizes divisible by 2, got [3]")
    with pytest.raises(ValueError, match="first device"):
        resolve_serving_mesh(["cpu", "cpu"], "meta")
    with pytest.raises(ValueError, match="one type"):
        ServingMesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="'auto', None"):
        resolve_serving_mesh("all", "cpu")


def test_auto_mesh_takes_every_card(monkeypatch):
    assert resolve_serving_mesh("auto", "cpu") is None
    assert resolve_serving_mesh(None, "cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_serving_mesh("auto", "cuda:0") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = resolve_serving_mesh("auto", "cuda:1")
    assert [str(d) for d in mesh.devices] == ["cuda:1", "cuda:0", "cuda:2"]
    assert mesh.shape == {"data": 3} and mesh.axis_names == ("data",)


_FAKE_JAX_MESH = SimpleNamespace(devices=np.zeros(2), axis_names=("data",),
                                 shape={"data": 2})


@pytest.mark.parametrize("batch_size, buckets", [
    (8, None), (8, "pow2"), (6, "pow2"), (2, "pow2"), (8, [2, 4]), (8, [3]),
    (7, None), (8, [0, 4])])
def test_ladder_step_matches_jax(batch_size, buckets):
    """The ladder in steps of the mesh's size, as JAX's _build_ladder
    gives it on a 2-way data mesh."""
    from bayesvlm_tpu.serve import BatchingServer as JaxBatchingServer

    def build(cls, *args):
        srv = cls.__new__(cls)
        srv.batch_size = batch_size
        try:
            return srv._build_ladder(*args)
        except ValueError as exc:
            return ("ValueError", str(exc))

    ours = build(BatchingServer, buckets, 2)
    theirs = build(JaxBatchingServer, SimpleNamespace(mesh=_FAKE_JAX_MESH), buckets)
    assert ours == theirs


def test_batching_server_on_the_mesh(vlm):
    imgs = _images(6, seed=4)
    want = vlm.predict(imgs[:4])  # replays the size-4 program
    with BatchingServer(vlm, batch_size=4, max_wait_ms=1.0, buckets="pow2") as srv:
        assert srv._buckets == [2, 4]
        futs = [srv.submit(im) for im in imgs]
        rows = np.stack([f.result(timeout=WAIT) for f in futs])
    assert rows.shape == (6, len(PROMPTS))
    # the first four went out in one size-4 batch or in two size-2 ones:
    # either way each row is its mesh program's output for that image
    np.testing.assert_allclose(rows[:4], want.numpy(), rtol=RTOL, atol=ATOL)


def test_replicas_follow_in_place_updates(vlm, hessian_dir, weights_dir):
    """An in-place projection change reaches the second replica at
    compile_serving; a label set of the same class count is written into
    every replica's label tensors in place, so the ladder keeps replaying
    (no eager call). Both agree with a VLM without a mesh that has the
    same state."""
    imgs = _images(4, seed=5)
    vlm.set_class_prompts(PROMPTS).compile_serving([4])
    old_proj = vlm.image_encoder.projection_tree()
    new_proj = {"kernel": old_proj["kernel"] * 0.5}
    swapped = [p + " again" for p in PROMPTS]
    try:
        vlm.image_encoder.with_projection(new_proj)
        vlm.compile_serving([4])
        assert torch.equal(vlm._replicas()[1].encoder.projection_weight(),
                           vlm.image_encoder.projection_weight())
        mirror_labels = vlm._replicas()[1].labels
        label_ptrs = [t.data_ptr() for t in (mirror_labels.embeds, mirror_labels.activations)]
        vlm.set_class_prompts(swapped)
        calls = vlm.eager_calls
        served = vlm.predict(imgs)
        assert vlm.eager_calls == calls
        mirror = vlm._replicas()[1].labels
        assert mirror is mirror_labels and label_ptrs == [
            t.data_ptr() for t in (mirror.embeds, mirror.activations)]
        assert torch.equal(mirror.embeds, vlm._label_features.embeds)
        plain = _port_vlm(hessian_dir, weights_dir, mesh=None)
        plain.image_encoder.with_projection(new_proj)
        plain.set_class_prompts(swapped)
        np.testing.assert_allclose(served.numpy(), plain.predict(imgs).numpy(),
                                   rtol=RTOL, atol=ATOL)
    finally:
        vlm.image_encoder.with_projection(old_proj)
        vlm.set_class_prompts(PROMPTS)
        vlm.compile_serving([4])


def test_no_mesh_is_the_one_device_path_bit_for_bit(hessian_dir, weights_dir):
    """Without a mesh the sharded general path is one device's: the tower
    in batches (`encode_images_batched`) and the head in chunks
    (`make_predictions`), bit for bit, with the cached labels and with
    class_prompts passed."""
    from bayesvlm_tpu_torch.inference.precompute import encode_images_batched
    from bayesvlm_tpu_torch.inference.predictions import make_predictions

    plain = _port_vlm(hessian_dir, weights_dir, mesh=None)
    imgs = _images(5, seed=10)
    feats = plain.encode_images(imgs, batch_size=2)
    want = encode_images_batched(plain.image_encoder, imgs, 2)
    for f in ("embeds", "activations", "residuals"):
        assert torch.equal(getattr(feats, f), getattr(want, f))
    other = [f"another thing {i}" for i in range(3)]
    for prompts, labels in ((None, plain._label_features), (other, plain.encode_texts(other))):
        got = plain.logits(imgs, prompts, batch_size=2)
        ref = make_predictions(plain.head, want, labels, batch_size=2)
        assert torch.equal(got.mean, ref.mean) and torch.equal(got.var, ref.var)


def test_replicas_follow_a_replaced_encoder(hessian_dir, weights_dir):
    """A tower rebuilt in another lane on the same weights (the block lane
    has the same tensors) replaces the other replicas' towers too."""
    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder

    vlm = _port_vlm(hessian_dir, weights_dir)
    imgs = _images(4, seed=7)
    vlm.predict(imgs)
    vlm.image_encoder = rebuild_image_encoder(vlm.image_encoder, attn_pallas_block=True)
    got = vlm.predict(imgs)
    assert all(r.encoder.config.vision.attn_pallas_block for r in vlm._replicas())
    plain = _port_vlm(hessian_dir, weights_dir, mesh=None)
    plain.image_encoder = rebuild_image_encoder(plain.image_encoder, attn_pallas_block=True)
    np.testing.assert_allclose(got.numpy(), plain.predict(imgs).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_save_serving_records_and_checks_the_mesh(vlm, hessian_dir, weights_dir,
                                                  tmp_path):
    imgs = _images(4, seed=6)
    vlm.compile_serving([2, 4])
    path = vlm.save_serving(tmp_path / "mesh.aotserv")
    payload = torch.load(path, weights_only=True)
    assert payload["mesh"] == {"axis": "data", "size": 2}
    restored = ProbabilisticVLM.from_serving_cache(
        "tiny-clip", path, weights_dir=str(weights_dir), dtype="fp32", device="cpu",
        mesh=MESH)
    assert torch.equal(restored.predict(imgs), vlm.predict(imgs))
    assert restored.replays == 1
    with pytest.raises(ValueError) as err:
        ProbabilisticVLM.from_serving_cache(
            "tiny-clip", path, weights_dir=str(weights_dir), dtype="fp32",
            device="cpu", mesh=None)
    assert str(err.value) == ("AOT cache mesh layout mismatch: saved "
                              "{'axis': 'data', 'size': 2}, runtime single-device")
    with pytest.raises(ValueError) as err:
        ProbabilisticVLM.from_serving_cache(
            "tiny-clip", path, weights_dir=str(weights_dir), dtype="fp32",
            device="cpu", mesh=["cpu"] * 4)
    assert str(err.value) == ("AOT cache mesh mismatch: saved "
                              "{'axis': 'data', 'size': 2}, runtime axes {'data': 4}")
    plain = _port_vlm(hessian_dir, weights_dir, mesh=None).compile_serving([4])
    single = plain.save_serving(tmp_path / "single.aotserv")
    assert torch.load(single, weights_only=True)["mesh"] is None
    with pytest.raises(ValueError, match="runtime sharded"):
        vlm.load_serving(single)


def test_serve_cli_no_mesh(monkeypatch, capsys):
    from bayesvlm_tpu_torch import serve_cli

    seen = []

    def fake(cls, *args, **kwargs):
        seen.append(kwargs["mesh"])
        raise RuntimeError("stop")

    monkeypatch.setattr(ProbabilisticVLM, "from_pretrained", classmethod(fake))
    monkeypatch.setattr(ProbabilisticVLM, "from_serving_cache", classmethod(fake))
    for argv, want in (([], "auto"), (["--no_mesh"], None)):
        args = serve_cli.parse_args(argv)
        assert args.use_mesh is (want == "auto")
        with pytest.raises(RuntimeError, match="stop"):
            serve_cli._load_vlm(args, "tiny-clip", "h", None, None, "fp32", False,
                                "c", "{class_name}")
        serve_cli._aot_full_restore("x", False, model_str="tiny-clip", weights_dir=None,
                                    tokenizer_dir=None, dtype="fp32", mlp_int8=False,
                                    device="cpu", use_mesh=args.use_mesh, prompts=[])
        assert seen[-2:] == [want, want]
    with pytest.raises(SystemExit):
        serve_cli.parse_args(["--help"])
    assert "serving mesh" in " ".join(capsys.readouterr().out.split())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_mesh_graphs_on_card(cuda, tmp_path):
    """Two replicas on one card, each size a graph a replica on its own
    stream: each replay equals the eager sharded predict and the row-block
    forwards bit for bit, float and uint8; an in-place projection change
    (then compile_serving) and a same-count prompt swap reach the second
    replica's graph."""
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians

    hdir = save_synthetic_hessians(tmp_path, TINY_CLIP_CONFIG, 0)
    vlm = ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hdir), dtype="fp32", prior_num_steps=20, device=cuda,
        mesh=[cuda, cuda]).set_class_prompts(PROMPTS)
    u8 = np.random.default_rng(8).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    for dtype, x in ((torch.float32, _images(4, seed=9)), (torch.uint8, u8)):
        vlm._serving = None
        eager = {b: vlm.predict(x[:b]) for b in (2, 4)}
        vlm.compile_serving([2, 4], input_dtype=dtype)
        parts = vlm._serving["programs"][4].parts
        assert len(parts) == 2 and parts[0].stream is not parts[1].stream
        for b in (2, 4):
            replays = vlm.replays
            out = vlm.predict(x[:b])
            assert vlm.replays == replays + 1
            assert torch.equal(out, eager[b]) and torch.equal(out, _row_blocks(vlm, x[:b]))
        assert torch.equal(vlm.predict(torch.as_tensor(x).to(cuda)), eager[4])
    calls = vlm.eager_calls
    vlm.image_encoder.with_projection({"kernel": vlm.image_encoder.projection_tree()[
        "kernel"] * 0.5})
    vlm.compile_serving([2, 4], input_dtype=torch.uint8)
    vlm.set_class_prompts([p + " again" for p in PROMPTS])
    out = vlm.predict(u8)
    assert vlm.eager_calls == calls
    vlm._serving = None
    assert torch.equal(out, vlm.predict(u8))
