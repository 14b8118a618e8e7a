"""The port's MultiModelServer (`bayesvlm_tpu_torch.multiserve`) and
serve_cli's manifest mode against the JAX package's, mirroring
tests/test_multiserve.py: tiny-clip and tiny-siglip resident together in
fp32 on the CPU, the port carrying the JAX towers' weights (through
models/bridge.save_weights) and both packages reading the same Hessian
directories. Served rows are held to the same model's direct predict of
the same package at rtol 1e-5 / atol 1e-6 (as the JAX file does), and the
port's rows to JAX's at test_torch_pipeline.py's rtol 1e-4 / atol 1e-5
(fp32 throughout; the packages differ by summation order). Every wait has
a timeout and every server is stopped in a `finally` or a `with`.

JAX is imported inside the fixtures and tests that compare with it, so
the `cuda` test (two lanes on the card with a shared resolver and slowed
host copies, skipped without a GPU) also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_multiserve.py
"""

import argparse
import json
import threading
import time

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch import serve as serve_mod
from bayesvlm_tpu_torch import serve_cli
from bayesvlm_tpu_torch.io.artifacts import save_hessians, save_prior_precision
from bayesvlm_tpu_torch.models.configs import TINY_CLIP_CONFIG, TINY_SIGLIP_CONFIG
from bayesvlm_tpu_torch.multiserve import MultiModelServer
from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

CLIP_PROMPTS = [f"An image of a thing {i}" for i in range(4)]
SIGLIP_PROMPTS = [f"A photo of object {i}" for i in range(5)]
PROMPTS = {"clip": CLIP_PROMPTS, "siglip": SIGLIP_PROMPTS}
MODELS = {"clip": "tiny-clip", "siglip": "tiny-siglip"}
RTOL, ATOL = 1e-4, 1e-5      # port vs JAX
SAME_RTOL, SAME_ATOL = 1e-5, 1e-6  # served vs direct, one package
WAIT = 120  # seconds: every future, join and request is bounded by it
OCTET = {"Content-Type": "application/octet-stream", "X-Image-Shape": "32,32,3",
         "X-Image-Dtype": "float32"}


def _spd(rng, d, s=0.5):
    M = rng.normal(size=(d, d)).astype(np.float32)
    return torch.from_numpy(M @ M.T / d * s + np.eye(d, dtype=np.float32))


def _hessian_dir(tmp, name, seed):
    """tests/test_multiserve.py's factors: CLIP's image side the pooled
    hidden state, SigLIP's the fc1 outputs plus a bias column."""
    rng = np.random.default_rng(seed)
    cfg = TINY_CLIP_CONFIG if name == "clip" else TINY_SIGLIP_CONFIG
    a_img, a_txt = ((cfg.vision.hidden_size, cfg.text.hidden_size) if name == "clip"
                    else (cfg.vision.mlp_dim + 1, cfg.text.hidden_size + 1))
    save_hessians(tmp, _spd(rng, a_img), _spd(rng, cfg.vision.projection_dim), "img")
    save_hessians(tmp, _spd(rng, a_txt), _spd(rng, cfg.vision.projection_dim), "txt")
    save_prior_precision(tmp, 5.0, 1.0, 5.0, 1.0)
    return tmp


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{name: its Hessian directory}, read by both packages."""
    out = {}
    for seed, name in enumerate(MODELS):
        out[name] = _hessian_dir(tmp_path_factory.mktemp(f"ms_{name}_hessians"), name, seed)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    import jax

    from bayesvlm_tpu.models import load_model as jax_load_model
    from bayesvlm_tpu_torch.models.bridge import save_weights

    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    out = {}
    for name, model in MODELS.items():
        j_img, j_txt, _ = jax_load_model(model, dtype=np.float32, seed=0)
        out[name] = save_weights(tmp_path_factory.mktemp(f"ms_{name}_weights"),
                                 to_np(j_img.params), to_np(j_txt.params))
    return out


def _port_vlm(name, dirs, weights):
    return ProbabilisticVLM.from_pretrained(
        MODELS[name], str(dirs[name]), weights_dir=str(weights[name]), dtype="fp32",
        prior_num_steps=30, device="cpu").set_class_prompts(PROMPTS[name])


@pytest.fixture(scope="module")
def vlms(dirs, weights):
    return {name: _port_vlm(name, dirs, weights) for name in MODELS}


@pytest.fixture(scope="module")
def jax_vlms(dirs):
    from bayesvlm_tpu.pipeline import ProbabilisticVLM as JaxProbabilisticVLM

    return {name: JaxProbabilisticVLM.from_pretrained(
        MODELS[name], str(dirs[name]), dtype="fp32", prior_num_steps=30,
        mesh=None).set_class_prompts(PROMPTS[name]) for name in MODELS}


@pytest.fixture(scope="module")
def expected(dirs, weights, jax_vlms):
    """Ground truth: an independent port VLM a model on its general path
    (no ladder), itself held to JAX's predict of the same images."""
    plain = {name: _port_vlm(name, dirs, weights) for name in MODELS}

    def fn(name, imgs):
        imgs = np.asarray(imgs)
        want = plain[name].predict(imgs).numpy()
        np.testing.assert_allclose(want, np.asarray(jax_vlms[name].predict(imgs)),
                                   rtol=RTOL, atol=ATOL)
        return want
    return fn


def _images(n, seed, size=32):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=SAME_RTOL, atol=SAME_ATOL)


def _threaded_submit(ms, jobs):
    """Submit (name, image) pairs from one thread each; futures in order."""
    futs = [None] * len(jobs)

    def submit(i, name, img):
        futs[i] = ms.submit(name, img)

    threads = [threading.Thread(target=submit, args=(i, n, im))
               for i, (n, im) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    return futs


def test_interleaved_concurrent_submissions_match_direct_and_jax(vlms, jax_vlms,
                                                                  expected):
    from bayesvlm_tpu.multiserve import MultiModelServer as JaxMultiModelServer

    imgs = {"clip": _images(9, seed=3), "siglip": _images(7, seed=4)}
    want = {n: expected(n, imgs[n]) for n in MODELS}
    jobs = [(n, im) for n in MODELS for im in imgs[n]]
    rows = {}
    for pkg, cls, models in (("port", MultiModelServer, vlms),
                             ("jax", JaxMultiModelServer, jax_vlms)):
        with cls(dict(models), batch_size={"clip": 4, "siglip": 3},
                 max_wait_ms=20.0) as ms:
            futs = _threaded_submit(ms, jobs)
            rows[pkg] = [f.result(timeout=WAIT) for f in futs]
            stats = ms.stats()
        assert stats["clip"].requests == 9 and stats["siglip"].requests == 7
        assert stats["clip"].batches >= 1 and stats["siglip"].batches >= 1
    for (name, _), i, ours, theirs in zip(jobs, [*range(9), *range(7)], rows["port"],
                                         rows["jax"]):
        assert ours.shape == (len(PROMPTS[name]),)
        _close(ours, want[name][i])
        np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    assert all(v.eager_calls == 0 for v in vlms.values())


def test_unknown_model_raises(vlms):
    ms = MultiModelServer({"clip": vlms["clip"]}, batch_size=2)
    with pytest.raises(KeyError, match="unknown model"):
        ms.submit("nope", _images(1, seed=0)[0])


def test_submit_before_start_raises(vlms):
    ms = MultiModelServer({"clip": vlms["clip"]}, batch_size=2)
    with pytest.raises(RuntimeError, match="not accepting"):
        ms.submit("clip", _images(1, seed=0)[0])


def test_per_lane_buckets_and_signature_match_jax(vlms, jax_vlms):
    from bayesvlm_tpu.multiserve import MultiModelServer as JaxMultiModelServer

    kw = dict(batch_size={"clip": 4, "siglip": 4},
              buckets={"clip": "pow2", "siglip": None})
    sig = MultiModelServer(dict(vlms), **kw).signature()
    assert sig["clip"]["buckets"] == [1, 2, 4]
    assert sig["siglip"]["buckets"] == [4]
    assert sig == JaxMultiModelServer(dict(jax_vlms), **kw).signature()


def test_stop_drain_serves_everything(vlms, expected):
    imgs = _images(5, seed=6)
    want = expected("clip", imgs)
    ms = MultiModelServer(dict(vlms), batch_size={"clip": 2, "siglip": 2},
                          max_wait_ms=50.0).start()
    try:
        futs = [ms.submit("clip", im) for im in imgs]
    finally:
        assert ms.stop(drain=True, timeout=WAIT) is True
    for i, f in enumerate(futs):
        _close(f.result(timeout=1), want[i])


def test_stop_no_drain_fails_undispatched(vlms, monkeypatch):
    """The dispatcher held inside its first (gated) siglip batch:
    stop(drain=False) fails everything still queued, and the gated batch
    still resolves once the gate opens."""
    gate = threading.Event()
    orig_predict = vlms["siglip"].predict

    def gated_predict(pixels, *a, **k):
        gate.wait(timeout=WAIT)
        return orig_predict(pixels, *a, **k)

    monkeypatch.setattr(vlms["siglip"], "predict", gated_predict)
    ms = MultiModelServer(dict(vlms), batch_size={"clip": 2, "siglip": 2},
                          max_wait_ms=0.0).start()
    try:
        futs = [ms.submit("siglip", im) for im in _images(6, seed=7)]
        deadline = time.monotonic() + WAIT
        while (ms.stats()["siglip"].queue_depth == 6
               and time.monotonic() < deadline):
            time.sleep(0.01)
        # the dispatcher is in the gate: the join times out (False), the
        # queue has been emptied and its requests failed
        assert ms.stop(drain=False, timeout=0.2) is False
    finally:
        gate.set()
    served = failed = 0
    for f in futs:
        try:
            f.result(timeout=WAIT)
            served += 1
        except RuntimeError as e:
            assert "without draining" in str(e)
            failed += 1
    assert served <= 2 and failed >= 4 and served + failed == 6
    assert ms.stats()["siglip"].queue_depth == 0


def test_error_stays_in_its_lane(vlms, expected, monkeypatch):
    clip_imgs = _images(3, seed=8)
    want = expected("clip", clip_imgs)

    class _Broken:
        @staticmethod
        def predict(*a, **k):
            raise RuntimeError("injected lane failure")

    with MultiModelServer(dict(vlms), batch_size={"clip": 4, "siglip": 4},
                          max_wait_ms=10.0) as ms:
        monkeypatch.setattr(ms._lanes["siglip"], "vlm", _Broken())
        sig_futs = [ms.submit("siglip", im) for im in _images(2, seed=9)]
        clip_futs = [ms.submit("clip", im) for im in clip_imgs]
        for f in sig_futs:
            with pytest.raises(RuntimeError, match="injected lane failure"):
                f.result(timeout=WAIT)
        for i, f in enumerate(clip_futs):
            _close(f.result(timeout=WAIT), want[i])
        assert ms.stats()["siglip"].errors == 2
        assert ms.stats()["clip"].errors == 0


def test_no_lane_starvation_under_alternating_load(vlms, expected):
    """Alternating single submissions with no hold-open window: every
    request is served although batches never fill."""
    imgs = {"clip": _images(4, seed=10), "siglip": _images(4, seed=11)}
    want = {n: expected(n, imgs[n]) for n in MODELS}
    with MultiModelServer(dict(vlms), batch_size={"clip": 4, "siglip": 4},
                          max_wait_ms=0.0) as ms:
        futs = [(n, i, ms.submit(n, imgs[n][i])) for i in range(4) for n in MODELS]
        for name, i, f in futs:
            _close(f.result(timeout=WAIT), want[name][i])


def test_many_submitters_lose_no_count(vlms):
    """More submitting threads than cores, the interpreter switching
    threads every microsecond: every request resolves once, each lane's
    request count is exact and no request stays pending (a lost update
    of the shared counters would break one of them)."""
    import os
    import sys

    n_threads, per_thread = 2 * (os.cpu_count() or 4) + 2, 4
    img = _images(1, seed=30)[0]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with MultiModelServer(dict(vlms), batch_size={"clip": 4, "siglip": 3},
                              max_wait_ms=1.0, pipeline_depth=1) as ms:
            futs = _threaded_submit(ms, [(("clip", "siglip")[(t + r) % 2], img)
                                         for t in range(n_threads)
                                         for r in range(per_thread)])
            rows = [f.result(timeout=WAIT) for f in futs]
            stats = ms.stats()
    finally:
        sys.setswitchinterval(old)
    half = n_threads * per_thread // 2
    assert len(rows) == 2 * half
    for name in MODELS:
        s = stats[name]
        assert (s.requests, s.queue_depth, s.errors) == (half, 0, 0)
        assert s.dispatched_rows - s.padded_rows == half


# -- the HTTP front end (serve_cli --models_json mode) against scripts/serve.py --


def _load_jax_cli():
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("bvt_serve_script_multi_torch",
                                                  root / "scripts" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve(app, module):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(app))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


@pytest.fixture(scope="module")
def http_multi(vlms, jax_vlms):
    """{package: (app, port)}: each package's MultiServingApp over its own
    two VLMs, batch 2 a lane."""
    fronts, running = {}, []
    try:
        for pkg, mod, models in (("port", serve_cli, vlms),
                                 ("jax", _load_jax_cli(), jax_vlms)):
            app = mod.MultiServingApp(dict(models), batch_size={"clip": 2, "siglip": 2},
                                      max_wait_ms=2.0, input_dtype="float32")
            httpd, thread = _serve(app, mod)
            running.append((httpd, thread, app))
            fronts[pkg] = (app, httpd.server_address[1])
        yield fronts
    finally:
        for httpd, thread, app in running:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=WAIT)
            app.server.stop(drain=False, timeout=WAIT)


def _request(port, method, path, body=None, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _both(fronts, method, path, body=None, headers=None):
    return [_request(fronts[pkg][1], method, path, body, headers) for pkg in ("port", "jax")]


def test_http_routes_per_model_match_jax(http_multi, expected):
    img = _images(1, seed=12)[0]
    raw = img.tobytes()
    for name in MODELS:
        (s1, ours), (s2, theirs) = _both(http_multi, "POST", f"/predict/{name}", raw, OCTET)
        assert s1 == s2 == 200
        _close(ours["probs"], expected(name, img[None])[0])
        np.testing.assert_allclose(ours["probs"], theirs["probs"], rtol=RTOL, atol=ATOL)
        assert ours["class"] == int(np.argmax(ours["probs"]))
    # no model path with two resident, an unknown model: client errors
    for path, msg in (("/predict", "model name required"), ("/predict/nope", "unknown model")):
        (s1, ours), (s2, theirs) = _both(http_multi, "POST", path, raw, OCTET)
        assert s1 == s2 == 400 and msg in ours["error"] and msg in theirs["error"]


def test_http_multi_observability(http_multi):
    (s1, ours), (s2, theirs) = _both(http_multi, "GET", "/healthz")
    assert s1 == s2 == 200 and ours["ok"]
    assert ours["models"] == theirs["models"]
    assert set(ours["models"]) == {"clip", "siglip"}
    assert set(ours["hbm_gib"]) == set(theirs["hbm_gib"]) == {"clip", "siglip", "total"}
    (s1, ours), (s2, theirs) = _both(http_multi, "GET", "/stats")
    assert s1 == s2 == 200 and set(ours) == set(theirs) == {"clip", "siglip"}
    assert all(set(s) == set(theirs[n]) and "latency_ms_p50" in s for n, s in ours.items())


def test_http_class_prompts_swap_one_lane(http_multi):
    app = http_multi["port"][0]
    img = _images(1, seed=13)[0]
    raw = img.tobytes()
    before = _request(http_multi["port"][1], "POST", "/predict/siglip", raw, OCTET)[1]
    for prompts in ([f"swapped class {i}" for i in range(3)], CLIP_PROMPTS):
        body = json.dumps({"prompts": prompts}).encode()
        (s1, ours), (s2, theirs) = _both(http_multi, "POST", "/class_prompts/clip", body,
                                         {"Content-Type": "application/json"})
        assert s1 == s2 == 200 and ours == theirs == {"ok": True,
                                                      "num_classes": len(prompts)}
        (s1, ours), (s2, theirs) = _both(http_multi, "POST", "/predict/clip", raw, OCTET)
        assert s1 == s2 == 200 and len(ours["probs"]) == len(prompts)
        np.testing.assert_allclose(ours["probs"], theirs["probs"], rtol=RTOL, atol=ATOL)
        want = app.vlms["clip"].logits(img[None], class_prompts=prompts).softmax(
            num_samples=0)
        _close(ours["probs"], want[0].numpy())
        # the other lane is untouched by the swap, bit for bit
        status, after = _request(http_multi["port"][1], "POST", "/predict/siglip", raw,
                                 OCTET)
        assert status == 200 and after["probs"] == before["probs"]
    assert all(v.eager_calls == 0 for v in app.vlms.values())


def _manifest_args(manifest, **over):
    kw = dict(model_str="tiny-clip", hessian_dir=None, weights_dir=None, tokenizer_dir=None,
              classes_json=None, models_json=str(manifest),
              text_prompt="An image of a {class_name}", batch_size=4, max_wait_ms=2.0,
              input_dtype="float32", dtype="fp32", use_mesh=False, mlp_int8=False,
              device="cpu", buckets=None, predict_timeout_s=120.0, pipeline_depth=0,
              aot_cache=None, host="127.0.0.1", port=0, verbose=False)
    kw.update(over)
    return argparse.Namespace(**kw)


def test_build_app_manifest_mode_matches_jax(tmp_path, dirs, weights):
    """--models_json builds a MultiServingApp from per-model specs (the
    JAX manifest's keys and defaults); the port's spec adds weights_dir,
    the JAX towers' weights, so both serve the same model."""
    classes = tmp_path / "classes.json"
    classes.write_text(json.dumps(["ant", "bee"]))
    spec = {"model_str": "tiny-clip", "hessian_dir": str(dirs["clip"]),
            "classes_json": str(classes), "batch_size": 2, "buckets": "pow2"}
    manifests = {}
    for pkg, extra in (("port", {"weights_dir": str(weights["clip"])}), ("jax", {})):
        manifests[pkg] = tmp_path / f"fleet_{pkg}.json"
        manifests[pkg].write_text(json.dumps({"tiny": {**spec, **extra}}))
    img = _images(1, seed=14)[0]
    out = {}
    for pkg, mod in (("port", serve_cli), ("jax", _load_jax_cli())):
        app = mod.build_app(_manifest_args(manifests[pkg]))
        try:
            assert isinstance(app, mod.MultiServingApp)
            assert app.server.signature()["tiny"]["buckets"] == [1, 2]
            out[pkg] = app.predict(img, model="tiny")
            assert out[pkg].shape == (2,)
            # one resident model: the path without a model resolves to it
            np.testing.assert_array_equal(app.predict(img), out[pkg])
        finally:
            app.server.stop(drain=False, timeout=WAIT)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=RTOL, atol=ATOL)


def test_hbm_footprint_reports_all_lanes(vlms):
    ms = MultiModelServer(dict(vlms), batch_size={"clip": 4, "siglip": 4})
    fp = ms.hbm_footprint()
    assert set(fp) == {"clip", "siglip", "total"}
    assert fp["total"] == pytest.approx(fp["clip"] + fp["siglip"], abs=1e-3)
    for name in MODELS:
        module = vlms[name].image_encoder.module
        weights = sum(p.numel() * p.element_size() for p in module.parameters())
        assert fp[name] >= round(weights / 2**30, 4) > 0.0


# -- pipelined resolution (one resolver for all lanes) -------------------------------


def test_pipelined_interleaved_lanes_match_direct(vlms, expected):
    """pipeline_depth>0: one resolver copies out while the dispatcher runs
    the next lane's batch; every lane's rows still equal its direct
    predict, in order."""
    imgs = {"clip": _images(8, seed=20), "siglip": _images(6, seed=21)}
    want = {n: expected(n, imgs[n]) for n in MODELS}
    with MultiModelServer(dict(vlms), batch_size={"clip": 4, "siglip": 3},
                          max_wait_ms=10.0, pipeline_depth=2) as ms:
        futs = []
        for i in range(8):
            futs.append(("clip", i, ms.submit("clip", imgs["clip"][i])))
            if i < 6:
                futs.append(("siglip", i, ms.submit("siglip", imgs["siglip"][i])))
        for name, i, f in futs:
            _close(f.result(timeout=WAIT), want[name][i])
        stats = ms.stats()
        assert stats["clip"].requests == 8 and stats["siglip"].requests == 6


def test_pipelined_stop_drain_resolves_everything(vlms, expected):
    imgs = _images(5, seed=22)
    want = expected("clip", imgs)
    ms = MultiModelServer(dict(vlms), batch_size={"clip": 2, "siglip": 2},
                          max_wait_ms=5.0, pipeline_depth=2).start()
    futs = [ms.submit("clip", im) for im in imgs]
    assert ms.stop(drain=True, timeout=WAIT) is True
    for i, f in enumerate(futs):
        assert f.done()  # the resolver drained before stop returned
        _close(f.result(timeout=1), want[i])


def test_pipelined_lanes_share_one_resolver_with_rings_of_their_own(vlms, expected,
                                                                    monkeypatch):
    """Two lanes, pipeline_depth=2, the resolver slowed so the dispatcher
    runs ahead of it: each lane keeps a host ring of depth + 2 slots (the
    batches one lane can have in flight behind one shared resolver), both
    lanes push to the one resolver queue while started and to none after
    stop, and every row still equals its model's direct predict."""
    imgs = {"clip": _images(6, seed=23), "siglip": _images(6, seed=24)}
    want = {n: expected(n, imgs[n]) for n in MODELS}
    slow_copy = serve_mod._to_numpy

    def slowed(probs):
        time.sleep(0.02)
        return slow_copy(probs)

    monkeypatch.setattr(serve_mod, "_to_numpy", slowed)
    ms = MultiModelServer(dict(vlms), batch_size={"clip": 1, "siglip": 1},
                          max_wait_ms=0.0, pipeline_depth=2)
    assert all(len(lane._host_ring) == 4 and lane._resolve_q is None
               for lane in ms._lanes.values())
    ms.start()
    try:
        queues = {id(lane._resolve_q) for lane in ms._lanes.values()}
        assert queues == {id(ms._resolve_q)} and ms._resolve_q.maxsize == 2
        futs = [(n, i, ms.submit(n, imgs[n][i])) for i in range(6) for n in MODELS]
        for name, i, f in futs:
            _close(f.result(timeout=WAIT), want[name][i])
    finally:
        assert ms.stop(drain=True, timeout=WAIT) is True
    assert all(lane._resolve_q is None for lane in ms._lanes.values())
    assert ms.stats()["clip"].batches == ms.stats()["siglip"].batches == 6


# -- two lanes on the card -------------------------------------------------------


@pytest.mark.cuda
def test_two_lanes_on_card_pipelined(tmp_path, monkeypatch):
    """tiny-clip and tiny-siglip ladders resident on the card, uint8 input,
    pipeline_depth=2, the resolver slowed so each lane's pinned ring is
    cycled while copies are still in flight: every served row equals its
    model's eager predict of the same image at the same bucket, and no
    eager call is made in either lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have no CPU mode)")
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians

    vlms = {}
    for name, cfg in (("clip", TINY_CLIP_CONFIG), ("siglip", TINY_SIGLIP_CONFIG)):
        hdir = save_synthetic_hessians(tmp_path / name, cfg, 0)
        vlms[name] = ProbabilisticVLM.from_pretrained(
            MODELS[name], str(hdir), dtype="fp32", prior_num_steps=20,
            device="cuda").set_class_prompts(PROMPTS[name])
    u8 = np.random.default_rng(40).integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    want = {n: v.logits(u8).softmax(num_samples=0).cpu().numpy() for n, v in vlms.items()}
    slow_copy = serve_mod._to_numpy

    def slowed(probs):
        time.sleep(0.005)
        return slow_copy(probs)

    monkeypatch.setattr(serve_mod, "_to_numpy", slowed)
    with MultiModelServer(vlms, batch_size=1, max_wait_ms=0.0, input_dtype=torch.uint8,
                          pipeline_depth=2) as ms:
        futs = [(n, i, ms.submit(n, u8[i])) for i in range(16) for n in MODELS]
        got = [(n, i, f.result(timeout=WAIT)) for n, i, f in futs]
    for name, i, row in got:
        np.testing.assert_allclose(row, want[name][i], rtol=SAME_RTOL, atol=SAME_ATOL)
    assert all(v.eager_calls == 0 and v.replays == 16 for v in vlms.values())
