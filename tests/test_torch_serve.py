"""The port's serving ladder (`ProbabilisticVLM.compile_serving` and the
fast path of `predict`) and `serve.BatchingServer` against the JAX
package's, tiny-clip in fp32 on the CPU, the port carrying the JAX
towers' weights (models/bridge.save_weights) and both reading one Hessian
directory. Probabilities agree at test_torch_pipeline.py's rtol 1e-4 /
atol 1e-5 (fp32 throughout; the packages differ by summation order).
The lifecycle tests mirror tests/test_serve.py. Every wait has a
timeout and every server is stopped in a `finally` or a `with`.

JAX is imported inside the fixtures and tests that compare with it, so
the `cuda` tests (the CUDA-graph ladders of tiny-clip and tiny-siglip
against the eager path, skipped without a GPU) also run where JAX is not
installed:
    python -m pytest --noconftest -m cuda tests/test_torch_serve.py
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch import serve as serve_mod
from bayesvlm_tpu_torch.io.artifacts import save_hessians, save_prior_precision
from bayesvlm_tpu_torch.models.configs import TINY_CLIP_CONFIG
from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
from bayesvlm_tpu_torch.serve import BatchingServer, ServerStats

PROMPTS = [f"An image of a thing {i}" for i in range(4)]
RTOL, ATOL = 1e-4, 1e-5
WAIT = 120  # seconds: every future, join and request is bounded by it


@pytest.fixture(scope="module")
def hessian_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve_hessians")
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
def weights_dir(hessian_dir, tmp_path_factory):
    """The JAX package's seed-0 tiny-clip towers as the port's files."""
    import jax

    from bayesvlm_tpu.models import load_model as jax_load_model
    from bayesvlm_tpu_torch.models.bridge import save_weights

    j_img, j_txt, _ = jax_load_model("tiny-clip", dtype=np.float32, seed=0)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    return save_weights(tmp_path_factory.mktemp("torch_serve_weights"),
                        to_np(j_img.params), to_np(j_txt.params))


def _port_vlm(hessian_dir, weights_dir):
    return ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), weights_dir=str(weights_dir), dtype="fp32",
        prior_num_steps=30, device="cpu").set_class_prompts(PROMPTS)


def _jax_vlm(hessian_dir):
    from bayesvlm_tpu.pipeline import ProbabilisticVLM as JaxProbabilisticVLM

    return JaxProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), dtype="fp32", prior_num_steps=30,
        mesh=None).set_class_prompts(PROMPTS)


@pytest.fixture(scope="module")
def vlm(hessian_dir, weights_dir):
    return _port_vlm(hessian_dir, weights_dir)


@pytest.fixture(scope="module")
def jax_vlm(hessian_dir):
    return _jax_vlm(hessian_dir)


@pytest.fixture(scope="module")
def reference_predict(hessian_dir):
    """An independent JAX VLM on its general path (no AOT program): the
    ground truth every served result is held to."""
    plain = _jax_vlm(hessian_dir)
    return lambda imgs: np.asarray(plain.predict(imgs))


def _images(n=6, size=32, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, 3)).astype(np.float32)


def _u8(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


# -- compile_serving and predict's fast path (the CPU ladder) -----------------


def test_ladder_predict_equals_eager(vlm, reference_predict):
    imgs = _images(n=4, seed=2)
    vlm._serving = None
    eager = {b: vlm.predict(imgs[:b]) for b in (1, 2, 4)}
    vlm.compile_serving([1, 2, 4])
    assert sorted(vlm._serving["programs"]) == [1, 2, 4]
    assert vlm._serving["image_shape"] == (32, 32, 3)
    assert vlm._serving["dtype"] == torch.float32
    replays = vlm.replays
    for b in (1, 2, 4):
        # the general path's forward and head, in the same order
        assert torch.equal(vlm.predict(imgs[:b]), eager[b])
    assert vlm.replays == replays + 3
    np.testing.assert_allclose(eager[4].numpy(), reference_predict(imgs), rtol=RTOL,
                               atol=ATOL)
    # float64 pixels are cast to the ladder's float32
    assert torch.equal(vlm.predict(imgs.astype(np.float64)), eager[4])
    assert vlm.replays == replays + 4


def test_off_ladder_and_dtype_mismatch_take_eager_path(vlm):
    vlm.compile_serving([2, 4])
    imgs = _images(n=3, seed=3)
    before = (vlm.replays, vlm.eager_calls)
    vlm.predict(imgs)                                   # 3 is off the ladder
    vlm.predict(_u8(2, 4))                              # uint8 on a float ladder
    vlm.predict(imgs[:2], num_samples=10)               # Monte Carlo
    vlm.predict(imgs[:2], class_prompts=PROMPTS[:3])    # prompts per call
    assert (vlm.replays, vlm.eager_calls) == (before[0], before[1] + 4)
    # another image size is no match either (the tower takes 32 px only)
    assert vlm._predict_fast(np.zeros((2, 16, 16, 3), np.float32), 0, None) is None
    vlm.compile_serving(2, input_dtype=torch.uint8)
    with torch.no_grad():
        eager_u8 = vlm.logits(_u8(2, 5)).softmax(num_samples=0)
    assert torch.equal(vlm.predict(_u8(2, 5)), eager_u8)
    vlm.predict(imgs[:2])                               # float on a uint8 ladder
    assert (vlm.replays, vlm.eager_calls) == (before[0] + 1, before[1] + 5)


def test_same_count_prompt_swap_serves_new_labels(hessian_dir, weights_dir,
                                                   reference_predict):
    vlm = _port_vlm(hessian_dir, weights_dir).compile_serving([2])
    labels = vlm._label_features
    swapped = [f"A photo of item {i}" for i in range(4)]
    vlm.set_class_prompts(swapped)
    # copied into the tensors the ladder reads; the ladder stays
    assert vlm._label_features is labels and vlm._serving is not None
    imgs = _images(n=2, seed=6)
    replays = vlm.replays
    out = vlm.predict(imgs)
    assert vlm.replays == replays + 1
    assert torch.equal(out, vlm.predict(imgs, class_prompts=swapped))
    assert not torch.allclose(out, vlm.predict(imgs, class_prompts=PROMPTS))


def test_new_class_count_drops_ladder(hessian_dir, weights_dir):
    vlm = _port_vlm(hessian_dir, weights_dir).compile_serving([2])
    vlm.set_class_prompts(PROMPTS + ["An image of a thing 4"])
    assert vlm._serving is None
    out = vlm.predict(_images(n=2, seed=7))
    assert out.shape == (2, 5) and vlm.replays == 0 and vlm.eager_calls == 1


def test_moved_tensors_take_eager_path_and_in_place_updates_are_served(
        hessian_dir, weights_dir):
    vlm = _port_vlm(hessian_dir, weights_dir).compile_serving([2])
    imgs = _images(n=2, seed=8)
    proj = vlm.image_encoder.projection()
    with torch.no_grad():
        proj.weight.mul_(1.5)                     # in place: the ladder serves it
    replays, eager = vlm.replays, vlm.eager_calls
    out = vlm.predict(imgs)
    assert (vlm.replays, vlm.eager_calls) == (replays + 1, eager)
    assert torch.equal(out, vlm.logits(imgs).softmax(num_samples=0))
    proj.weight = torch.nn.Parameter(proj.weight.detach() * 0.5, requires_grad=False)
    out = vlm.predict(imgs)                       # a new Parameter: general path
    assert (vlm.replays, vlm.eager_calls) == (replays + 1, eager + 1)
    vlm.compile_serving([2])
    vlm.head = dataclasses.replace(vlm.head, logit_scale=vlm.head.logit_scale * 0.5)
    out2 = vlm.predict(imgs)                      # a new head tensor: general path
    assert vlm.eager_calls == eager + 2
    assert not torch.allclose(out, out2)
    assert torch.equal(out2, vlm.logits(imgs).softmax(num_samples=0))


def test_compile_serving_validation(hessian_dir, weights_dir):
    vlm = ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(hessian_dir), weights_dir=str(weights_dir), dtype="fp32",
        prior_num_steps=5, device="cpu")
    with pytest.raises(ValueError, match="set_class_prompts"):
        vlm.compile_serving(2)
    vlm.set_class_prompts(PROMPTS)
    with pytest.raises(ValueError, match=">= 1"):
        vlm.compile_serving([0, 2])
    with pytest.raises(ValueError, match="uint8 or floats"):
        vlm.compile_serving(2, input_dtype=torch.int32)
    assert vlm._serving is None


# -- BatchingServer against the JAX package's ------------------------------------


def _concurrent(srv, imgs):
    results = [None] * len(imgs)

    def worker(i):
        results[i] = srv.predict(imgs[i], timeout=WAIT)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    return np.stack(results)


def test_concurrent_submissions_match_jax(vlm, jax_vlm, reference_predict):
    from bayesvlm_tpu.serve import BatchingServer as JaxBatchingServer

    imgs = _images(n=12, seed=3)
    expected = reference_predict(imgs)
    with BatchingServer(vlm, batch_size=4, max_wait_ms=20.0) as srv:
        ours = _concurrent(srv, imgs)
        stats = srv.stats()
    with JaxBatchingServer(jax_vlm, batch_size=4, max_wait_ms=20.0) as jsrv:
        theirs = _concurrent(jsrv, imgs)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, expected, rtol=RTOL, atol=ATOL)
    assert stats.requests == 12
    assert stats.batches >= 3  # 12 rows cannot fit in fewer than 3 x B=4
    assert stats.latency_ms_p50 > 0.0
    assert 0.0 < stats.fill <= 1.0


def test_partial_batch_is_padded_and_sliced(vlm, reference_predict):
    img = _images(n=1, seed=4)[0]
    expected = reference_predict(img[None])[0]
    srv = BatchingServer(vlm, batch_size=4, max_wait_ms=1.0).start()
    try:
        probs = srv.predict(img, timeout=WAIT)
        np.testing.assert_allclose(probs, expected, rtol=RTOL, atol=ATOL)
        assert probs.shape == (len(PROMPTS),)
        stats = srv.stats()
        assert (stats.requests, stats.batches, stats.padded_rows) == (1, 1, 3)
    finally:
        srv.stop(drain=True)


@pytest.mark.parametrize("batch_size, buckets", [
    (8, None), (8, "pow2"), (6, "pow2"), (1, "pow2"), (8, [2, 3]), (8, [8, 8, 1]),
    (8, [16]), (8, [0, 4]), (0, None), (-2, "pow2")])
def test_ladders_match_jax(batch_size, buckets):
    """pow2 and explicit ladders, and their errors, as JAX's _build_ladder
    gives them without a mesh."""
    from types import SimpleNamespace

    from bayesvlm_tpu.serve import BatchingServer as JaxBatchingServer

    def build(cls, *args):
        srv = cls.__new__(cls)
        srv.batch_size = batch_size
        try:
            return srv._build_ladder(*args)
        except ValueError as exc:
            return ("ValueError", str(exc))

    ours = build(BatchingServer, buckets)
    theirs = build(JaxBatchingServer, SimpleNamespace(mesh=None), buckets)
    assert ours == theirs


def test_submit_validation_and_lifecycle(vlm):
    srv = BatchingServer(vlm, batch_size=4, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="not accepting"):
            srv.submit(_images(n=1)[0])
        srv.start()
        with pytest.raises(RuntimeError, match="already started"):
            srv.start()
        with pytest.raises(ValueError, match="shape"):
            srv.submit(np.zeros((8, 8, 3), np.float32))
        with pytest.raises(ValueError, match="dtype"):
            srv.submit(np.zeros((32, 32, 3), np.uint8))  # float32 ladder
        # float64 -> float32 coercion is allowed (same guard as predict())
        fut = srv.submit(_images(n=1, seed=5)[0].astype(np.float64))
        assert fut.result(timeout=WAIT).shape == (len(PROMPTS),)
    finally:
        assert srv.stop(drain=True, timeout=WAIT) is True
    with pytest.raises(RuntimeError, match="not accepting"):
        srv.submit(_images(n=1)[0])
    assert srv.stop() is True  # second stop is a no-op


def test_queue_full_is_backpressure(vlm, monkeypatch):
    import queue

    entered, release = threading.Event(), threading.Event()
    real_predict = vlm.predict

    def gated(pixels, **kw):
        entered.set()
        assert release.wait(timeout=WAIT)
        return real_predict(pixels, **kw)

    monkeypatch.setattr(vlm, "predict", gated)
    srv = BatchingServer(vlm, batch_size=1, max_wait_ms=0.0, max_queue=2).start()
    try:
        first = srv.submit(_images(n=1, seed=9)[0])
        assert entered.wait(timeout=WAIT)
        queued = srv.submit_many(list(_images(n=2, seed=10)))
        with pytest.raises(queue.Full):
            srv.submit(_images(n=1, seed=11)[0])
        release.set()
        for f in [first, *queued]:
            assert f.result(timeout=WAIT).shape == (len(PROMPTS),)
    finally:
        release.set()
        srv.stop(drain=True, timeout=WAIT)


def test_drain_serves_all_queued(vlm, reference_predict):
    imgs = _images(n=7, seed=6)
    expected = reference_predict(imgs)
    srv = BatchingServer(vlm, batch_size=4, max_wait_ms=200.0).start()
    futs = srv.submit_many(list(imgs))
    assert srv.stop(drain=True, timeout=WAIT) is True  # sentinel BEHIND the requests
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=1), expected[i], rtol=RTOL, atol=ATOL)


def test_stop_without_drain_fails_queued(vlm, monkeypatch):
    """Requests still queued when stop(drain=False) runs fail with a
    RuntimeError; the batch already in flight still resolves."""
    entered, release = threading.Event(), threading.Event()
    real_predict = vlm.predict

    def gated(pixels, **kw):
        entered.set()
        assert release.wait(timeout=WAIT)
        return real_predict(pixels, **kw)

    monkeypatch.setattr(vlm, "predict", gated)
    srv = BatchingServer(vlm, batch_size=4, max_wait_ms=0.0).start()
    try:
        first = srv.submit(_images(n=1, seed=7)[0])
        assert entered.wait(timeout=WAIT)  # dispatcher is inside predict
        late = srv.submit_many(list(_images(n=4, seed=8)))
        stopper = threading.Thread(target=srv.stop, kwargs=dict(drain=False))
        stopper.start()
        deadline = time.monotonic() + WAIT
        while not all(f.done() for f in late) and time.monotonic() < deadline:
            time.sleep(0.005)
        release.set()
        stopper.join(timeout=WAIT)
        assert not stopper.is_alive()
        assert first.result(timeout=WAIT).shape == (len(PROMPTS),)
        for f in late:
            exc = f.exception(timeout=WAIT)
            assert exc is not None and "without draining" in str(exc)
    finally:
        release.set()
        srv.stop(drain=False, timeout=WAIT)


def test_request_behind_stop_sentinel_is_failed(vlm):
    srv = BatchingServer(vlm, batch_size=2, max_wait_ms=0.0).start()
    stray = serve_mod._Request(_images(n=1, seed=13)[0])
    real_put = srv._queue.put

    def put_with_stray(item):
        real_put(item)
        if item is serve_mod._STOP:
            real_put(stray)

    srv._queue.put = put_with_stray
    assert srv.stop(drain=True, timeout=WAIT) is True
    exc = stray.future.exception(timeout=5)
    assert isinstance(exc, RuntimeError) and "raced a server stop" in str(exc)


def test_dispatch_error_propagates_to_batch(vlm, monkeypatch):
    def boom(pixels, **kw):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(vlm, "predict", boom)
    srv = BatchingServer(vlm, batch_size=2, max_wait_ms=50.0).start()
    try:
        futs = srv.submit_many(list(_images(n=2, seed=9)))
        for f in futs:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=WAIT)
        assert srv.stats().errors == 2
        monkeypatch.undo()  # the dispatcher survived: new work is served
        assert srv.predict(_images(n=1, seed=10)[0], timeout=WAIT).shape == (len(PROMPTS),)
    finally:
        srv.stop(drain=False, timeout=WAIT)


def test_uint8_lane_matches_jax(hessian_dir, weights_dir, reference_predict):
    """uint8 ladder: raw bytes in, /255 + normalize in the program, results
    equal to JAX's uint8 server and to the float general path."""
    import jax.numpy as jnp

    from bayesvlm_tpu.serve import BatchingServer as JaxBatchingServer

    vlm = _port_vlm(hessian_dir, weights_dir)
    u8 = _u8(3, 10)
    expected = reference_predict(u8)
    with BatchingServer(vlm, batch_size=2, max_wait_ms=5.0, input_dtype=torch.uint8) as srv:
        ours = np.stack([f.result(timeout=WAIT) for f in srv.submit_many(list(u8))])
        with pytest.raises(ValueError, match="dtype"):
            srv.submit(_images(n=1)[0])  # float on the uint8 ladder
    with JaxBatchingServer(_jax_vlm(hessian_dir), batch_size=2, max_wait_ms=5.0,
                           input_dtype=jnp.uint8) as jsrv:
        theirs = np.stack([f.result(timeout=WAIT) for f in jsrv.submit_many(list(u8))])
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, expected, rtol=RTOL, atol=ATOL)
    assert vlm._serving["dtype"] == torch.uint8 and vlm.eager_calls == 0


def test_cancelled_request_is_skipped_and_dispatcher_survives(vlm, monkeypatch):
    entered, release = threading.Event(), threading.Event()
    real_predict = vlm.predict

    def gated(pixels, **kw):
        entered.set()
        assert release.wait(timeout=WAIT)
        return real_predict(pixels, **kw)

    monkeypatch.setattr(vlm, "predict", gated)
    srv = BatchingServer(vlm, batch_size=4, max_wait_ms=0.0).start()
    try:
        first = srv.submit(_images(n=1, seed=20)[0])
        assert entered.wait(timeout=WAIT)  # dispatcher is inside predict
        futs = srv.submit_many(list(_images(n=3, seed=21)))
        assert futs[1].cancel()  # still queued: cancellable
        release.set()
        for f in (first, futs[0], futs[2]):
            assert f.result(timeout=WAIT).shape == (len(PROMPTS),)
        assert futs[1].cancelled()
        assert srv.predict(_images(n=1, seed=22)[0], timeout=WAIT).shape == (len(PROMPTS),)
    finally:
        release.set()
        srv.stop(drain=True, timeout=WAIT)


def test_stop_reports_dispatcher_exit(vlm, monkeypatch):
    entered, release = threading.Event(), threading.Event()
    real_predict = vlm.predict

    def gated(pixels, **kw):
        entered.set()
        assert release.wait(timeout=WAIT)
        return real_predict(pixels, **kw)

    monkeypatch.setattr(vlm, "predict", gated)
    srv = BatchingServer(vlm, batch_size=2, max_wait_ms=0.0).start()
    try:
        fut = srv.submit(_images(n=1, seed=23)[0])
        assert entered.wait(timeout=WAIT)
        assert srv.stop(drain=True, timeout=0.05) is False
        release.set()
        assert fut.result(timeout=WAIT).shape == (len(PROMPTS),)
    finally:
        release.set()
    srv2 = BatchingServer(vlm, batch_size=2, max_wait_ms=0.0).start()
    assert srv2.stop(drain=True, timeout=WAIT) is True


def test_signature_and_stats_have_jax_keys(vlm, jax_vlm):
    from bayesvlm_tpu.serve import BatchingServer as JaxBatchingServer
    from bayesvlm_tpu.serve import ServerStats as JaxServerStats

    srv = BatchingServer(vlm, batch_size=2, max_wait_ms=0.0)
    jsrv = JaxBatchingServer(jax_vlm, batch_size=2, max_wait_ms=0.0)
    assert srv.signature() == jsrv.signature()
    assert srv.signature() == {"batch_size": 2, "buckets": [2], "image_shape": [32, 32, 3],
                               "input_dtype": "float32", "max_wait_ms": 0.0,
                               "pipeline_depth": 0}
    assert vars(srv.stats()) == vars(jsrv.stats()) == vars(ServerStats())
    assert list(vars(ServerStats())) == list(vars(JaxServerStats()))


def test_bucket_ladder_reduces_padding(vlm, reference_predict):
    imgs = _images(n=3, seed=40)
    expected = reference_predict(imgs)
    srv = BatchingServer(vlm, batch_size=8, max_wait_ms=50.0, buckets="pow2").start()
    try:
        assert srv._buckets == [1, 2, 4, 8] == sorted(vlm._serving["programs"])
        futs = srv.submit_many(list(imgs))
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=WAIT), expected[i],
                                       rtol=RTOL, atol=ATOL)
        stats = srv.stats()
        assert (stats.dispatched_rows, stats.padded_rows) == (4, 1)  # bucket 4, not 8
        assert stats.fill == pytest.approx(0.75)
    finally:
        srv.stop(drain=True, timeout=WAIT)


# -- pipelined resolution (pipeline_depth > 0) ------------------------------------


def test_pipelined_matches_inline_bit_for_bit(vlm):
    """batch_size 1: every request is its own batch, so the pipelined
    server's results must equal the inline server's exactly."""
    imgs = _images(n=6, seed=21)
    out = {}
    for depth in (0, 3):
        with BatchingServer(vlm, batch_size=1, max_wait_ms=0.0,
                            pipeline_depth=depth) as srv:
            assert srv.signature()["pipeline_depth"] == depth
            futs = srv.submit_many(list(imgs))
            out[depth] = np.stack([f.result(timeout=WAIT) for f in futs])
            stats = srv.stats()
        assert (stats.requests, stats.batches) == (6, 6)
    np.testing.assert_array_equal(out[3], out[0])


def test_pipelined_stop_drain_resolves_in_flight(vlm, reference_predict):
    imgs = _images(n=7, seed=22)
    expected = reference_predict(imgs)
    srv = BatchingServer(vlm, batch_size=2, max_wait_ms=5.0, pipeline_depth=2).start()
    futs = [srv.submit(im) for im in imgs]
    assert srv.stop(drain=True, timeout=WAIT) is True
    for i, f in enumerate(futs):
        assert f.done()  # the resolver drained before stop returned
        np.testing.assert_allclose(f.result(timeout=1), expected[i], rtol=RTOL, atol=ATOL)
    srv.start()  # restart after stop works (fresh resolver thread)
    try:
        np.testing.assert_allclose(srv.predict(imgs[0], timeout=WAIT), expected[0],
                                   rtol=RTOL, atol=ATOL)
    finally:
        assert srv.stop(drain=True, timeout=WAIT) is True


def test_pipelined_dispatch_error_propagates(vlm, monkeypatch):
    def boom(pixels, **kw):
        raise RuntimeError("injected predict failure")

    srv = BatchingServer(vlm, batch_size=2, max_wait_ms=0.0, pipeline_depth=2).start()
    try:
        monkeypatch.setattr(srv, "vlm", type("B", (), {"predict": staticmethod(boom)})())
        futs = [srv.submit(im) for im in _images(n=2, seed=23)]
        for f in futs:
            with pytest.raises(RuntimeError, match="injected predict"):
                f.result(timeout=WAIT)
        assert srv.stats().errors == 2
    finally:
        monkeypatch.undo()
        srv.stop(drain=False, timeout=WAIT)


def test_pipeline_depth_validation(vlm):
    with pytest.raises(ValueError, match="pipeline_depth"):
        BatchingServer(vlm, batch_size=2, pipeline_depth=-1)


# -- the CUDA-graph ladder on the card ----------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_ladder_equals_eager_on_card(cuda, tmp_path):
    """Each size's replay equals the general path on the same pixels, bit
    for bit; a same-count prompt swap, a replaced projection weight and a
    replaced head are served correctly, never stale."""
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians

    hdir = save_synthetic_hessians(tmp_path, TINY_CLIP_CONFIG, 0)
    vlm = ProbabilisticVLM.from_pretrained("tiny-clip", str(hdir), dtype="fp32",
                                           prior_num_steps=20, device=cuda)
    vlm.set_class_prompts(PROMPTS).compile_serving([1, 2, 4, 8])

    def eager(x):
        return vlm.logits(x).softmax(num_samples=0)

    imgs = _images(n=8, seed=30)
    for b in (1, 2, 4, 8):
        replays = vlm.replays
        out = vlm.predict(imgs[:b])
        torch.cuda.synchronize()
        assert vlm.replays == replays + 1
        assert torch.equal(out, eager(imgs[:b])), b
    swapped = [f"A photo of item {i}" for i in range(4)]
    vlm.set_class_prompts(swapped)
    assert torch.equal(vlm.predict(imgs[:4]), eager(imgs[:4]))
    assert vlm.eager_calls == 0
    proj = vlm.image_encoder.projection()
    proj.weight = torch.nn.Parameter(proj.weight.detach() * 2.0, requires_grad=False)
    assert torch.equal(vlm.predict(imgs[:4]), eager(imgs[:4]))
    assert vlm.eager_calls == 1
    vlm.compile_serving([4])
    vlm.head = dataclasses.replace(vlm.head, logit_scale=vlm.head.logit_scale + 0.5)
    assert torch.equal(vlm.predict(imgs[:4]), eager(imgs[:4]))
    assert vlm.eager_calls == 2
    vlm.compile_serving([4], input_dtype=torch.uint8)
    u8 = _u8(4, 31)
    assert torch.equal(vlm.predict(u8), eager(u8))
    with BatchingServer(vlm, batch_size=4, max_wait_ms=1.0, input_dtype=torch.uint8,
                        pipeline_depth=2) as srv:
        served = np.stack([f.result(timeout=WAIT) for f in srv.submit_many(list(u8))])
    assert vlm.eager_calls == 2
    np.testing.assert_allclose(served, eager(u8).cpu().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_graph_ladder_siglip_on_card(cuda, tmp_path):
    """SigLIP's tower (its probe's cross-attention takes the plain path)
    captures too: each size's replay equals the general path bit for bit,
    float and uint8 ladders."""
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
    from bayesvlm_tpu_torch.models.configs import TINY_SIGLIP_CONFIG

    hdir = save_synthetic_hessians(tmp_path, TINY_SIGLIP_CONFIG, 0)
    vlm = ProbabilisticVLM.from_pretrained("tiny-siglip", str(hdir), dtype="fp32",
                                           prior_num_steps=20, device=cuda)
    vlm.set_class_prompts(PROMPTS)
    for dtype, x in ((torch.float32, _images(n=4, seed=32)), (torch.uint8, _u8(4, 33))):
        vlm.compile_serving([1, 4], input_dtype=dtype)
        for b in (1, 4):
            out = vlm.predict(x[:b])
            assert torch.equal(out, vlm.logits(x[:b]).softmax(num_samples=0)), (dtype, b)
    assert vlm.replays == 4 and vlm.eager_calls == 0
