"""The port's HTTP front end (`bayesvlm_tpu_torch.serve_cli`) against the
JAX package's `scripts/serve.py` (imported by path), both on 127.0.0.1 at
port 0, tiny-clip in fp32 on the CPU with the same weights (the port
carrying the JAX towers' through models/bridge.save_weights) and one
Hessian directory. The same octet-stream (uint8 and float32) and JSON
requests give probabilities within test_torch_pipeline.py's rtol 1e-4 /
atol 1e-5; the same bad requests get the same status codes; /healthz,
/stats and /class_prompts swaps behave alike. `--models_json` and
`--aot_cache` (tests/test_aot_cache.py's restart flow: a full build saves,
a restart restores without the Hessian directory, a changed prompt set
rebuilds and refreshes the file, a stale file or a failed save never
keeps the server down) are driven through build_app and, as a
subprocess, through `python -m bayesvlm_tpu_torch.serve_cli`; the
manifest against the JAX CLI is in tests/test_torch_multiserve.py. Every
request has a client timeout and every server is shut down in a
finalizer."""

import concurrent.futures
import http.client
import importlib.util
import json
import queue
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bayesvlm_tpu.io.artifacts import save_hessians, save_prior_precision
from bayesvlm_tpu.models import load_model as jax_load_model
from bayesvlm_tpu.models.configs import TINY_CLIP_CONFIG
from bayesvlm_tpu.pipeline import ProbabilisticVLM as JaxProbabilisticVLM
from bayesvlm_tpu_torch import serve_cli
from bayesvlm_tpu_torch.models.bridge import save_weights
from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

REPO = Path(__file__).resolve().parent.parent
PROMPTS = [f"An image of a thing {i}" for i in range(4)]
RTOL, ATOL = 1e-4, 1e-5
WAIT = 120  # seconds: client timeout and every join
OCTET = {"Content-Type": "application/octet-stream", "X-Image-Shape": "32,32,3"}


def _load_jax_cli():
    spec = importlib.util.spec_from_file_location("bvt_serve_script",
                                                  REPO / "scripts" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A Hessian directory, the JAX seed-0 towers as the port's files, and
    a classes file."""
    tmp = tmp_path_factory.mktemp("torch_serve_cli")
    rng = np.random.default_rng(0)

    def spd(d, s=0.5):
        M = rng.normal(size=(d, d)).astype(np.float32)
        return M @ M.T / d * s + np.eye(d, dtype=np.float32)

    P, D, Pt = (TINY_CLIP_CONFIG.vision.hidden_size,
                TINY_CLIP_CONFIG.vision.projection_dim,
                TINY_CLIP_CONFIG.text.hidden_size)
    hdir = tmp / "hessians"
    save_hessians(hdir, spd(P), spd(D), "img")
    save_hessians(hdir, spd(Pt), spd(D), "txt")
    save_prior_precision(hdir, 5.0, 1.0, 5.0, 1.0)
    j_img, j_txt, _ = jax_load_model("tiny-clip", dtype=np.float32, seed=0)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    wd = save_weights(tmp / "weights", to_np(j_img.params), to_np(j_txt.params))
    classes = tmp / "classes.json"
    classes.write_text(json.dumps([f"thing {i}" for i in range(4)]))
    return {"hessian_dir": hdir, "weights_dir": wd, "classes_json": classes}


def _serve(app, module):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(app))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


@pytest.fixture(scope="module")
def fronts(dirs):
    """{(package, input dtype): (app, port)} for the port's front end and
    JAX's, float32 and uint8 ladders of batch 2, each on its own VLM."""
    jmod = _load_jax_cli()
    running, out = [], {}
    try:
        for dtype in ("float32", "uint8"):
            tvlm = ProbabilisticVLM.from_pretrained(
                "tiny-clip", str(dirs["hessian_dir"]), weights_dir=str(dirs["weights_dir"]),
                dtype="fp32", prior_num_steps=30, device="cpu").set_class_prompts(PROMPTS)
            jvlm = JaxProbabilisticVLM.from_pretrained(
                "tiny-clip", str(dirs["hessian_dir"]), dtype="fp32", prior_num_steps=30,
                mesh=None).set_class_prompts(PROMPTS)
            for name, mod, vlm in (("port", serve_cli, tvlm), ("jax", jmod, jvlm)):
                app = mod.ServingApp(vlm, batch_size=2, max_wait_ms=2.0, input_dtype=dtype,
                                     predict_timeout_s=60.0)
                httpd, thread = _serve(app, mod)
                running.append((httpd, thread, app))
                out[(name, dtype)] = (app, httpd.server_address[1])
        yield out
    finally:
        for httpd, thread, app in running:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=WAIT)
            app.server.stop(drain=False, timeout=WAIT)


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _both(fronts, dtype, method, path, body=None, headers=None):
    return [_request(fronts[(name, dtype)][1], method, path, body, headers)
            for name in ("port", "jax")]


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _u8(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def test_http_predict_matches_jax(fronts):
    img, u8 = _images(1, 11)[0], _u8(1, 12)[0]
    requests = [
        ("float32", img.tobytes(), {**OCTET, "X-Image-Dtype": "float32"}),
        ("float32", json.dumps({"image": img.tolist()}).encode(),
         {"Content-Type": "application/json"}),
        ("uint8", u8.tobytes(), {**OCTET, "X-Image-Dtype": "uint8"}),
    ]
    for dtype, body, headers in requests:
        (s1, ours), (s2, theirs) = _both(fronts, dtype, "POST", "/predict", body, headers)
        assert s1 == s2 == 200, (ours, theirs)
        np.testing.assert_allclose(ours["probs"], theirs["probs"], rtol=RTOL, atol=ATOL)
        assert ours["class"] == theirs["class"] == int(np.argmax(ours["probs"]))
        assert len(ours["probs"]) == len(PROMPTS) and ours["latency_ms"] > 0
    assert fronts[("port", "uint8")][0].vlm.eager_calls == 0


@pytest.mark.parametrize("method, path, body, headers, status", [
    ("POST", "/predict", b"\x00" * 12, {**OCTET, "X-Image-Dtype": "float32"}, 400),
    ("POST", "/predict", np.zeros((32, 32, 3), np.uint8).tobytes(),
     {**OCTET, "X-Image-Dtype": "uint8"}, 400),
    ("POST", "/predict", np.zeros((16, 16, 3), np.float32).tobytes(),
     {**OCTET, "X-Image-Shape": "16,16,3", "X-Image-Dtype": "float32"}, 400),
    # no shape header: an AttributeError in both front ends, a 500 in both
    ("POST", "/predict", np.zeros((32, 32, 3), np.float32).tobytes(),
     {"Content-Type": "application/octet-stream"}, 500),
    ("POST", "/predict", b'{"pixels": []}', {"Content-Type": "application/json"}, 400),
    ("POST", "/predict", b"{not json", {"Content-Type": "application/json"}, 400),
    ("POST", "/predict/some-model", np.zeros((32, 32, 3), np.float32).tobytes(),
     {**OCTET, "X-Image-Dtype": "float32"}, 400),
    ("POST", "/class_prompts", b'{"labels": ["a"]}', {"Content-Type": "application/json"},
     400),
    ("POST", "/nope", b"", {}, 404),
    ("GET", "/nope", None, {}, 404),
], ids=["size", "dtype", "shape", "no-shape", "json-key", "json", "model-path",
        "prompts-key", "post-404", "get-404"])
def test_bad_requests_get_jax_status(fronts, method, path, body, headers, status):
    (s1, ours), (s2, theirs) = _both(fronts, "float32", method, path, body, headers)
    assert s1 == s2 == status, (s1, s2)
    assert "error" in ours and "error" in theirs


@pytest.mark.parametrize("exc, status", [
    (queue.Full(), 429), (concurrent.futures.TimeoutError(), 504),
    (ValueError("x"), 400), (KeyError("x"), 400), (TypeError("x"), 400),
    (RuntimeError("server not accepting (call start())"), 503),
    (RuntimeError("injected device failure"), 500), (OSError("x"), 500)])
def test_status_mapping_matches_jax(exc, status):
    jmod = _load_jax_cli()
    ours = serve_cli.make_handler(None)._status_for(exc)
    assert ours == jmod.make_handler(None)._status_for(exc) == status


def test_healthz_stats_and_prompt_swaps(fronts):
    for dtype in ("float32", "uint8"):
        (s1, ours), (s2, theirs) = _both(fronts, dtype, "GET", "/healthz")
        assert s1 == s2 == 200 and ours == theirs
        assert ours["ok"] and ours["input_dtype"] == dtype and ours["batch_size"] == 2
        (s1, ours), (s2, theirs) = _both(fronts, dtype, "GET", "/stats")
        assert s1 == s2 == 200 and set(ours) == set(theirs)
    app = fronts[("port", "float32")][0]
    img = _images(1, 13)[0]
    predict = ("POST", "/predict", img.tobytes(), {**OCTET, "X-Image-Dtype": "float32"})
    for prompts in ([f"A photo of item {i}" for i in range(4)],          # same count
                    [f"A photo of item {i}" for i in range(5)],          # another count
                    PROMPTS):                                            # restored
        body = json.dumps({"prompts": prompts}).encode()
        (s1, ours), (s2, theirs) = _both(fronts, "float32", "POST", "/class_prompts", body,
                                         {"Content-Type": "application/json"})
        assert s1 == s2 == 200 and ours == theirs == {"ok": True,
                                                      "num_classes": len(prompts)}
        (s1, ours), (s2, theirs) = _both(fronts, "float32", *predict)
        assert s1 == s2 == 200 and len(ours["probs"]) == len(prompts)
        np.testing.assert_allclose(ours["probs"], theirs["probs"], rtol=RTOL, atol=ATOL)
        # the served labels are the new ones, on the ladder
        want = app.vlm.logits(img[None], class_prompts=prompts).softmax(num_samples=0)
        np.testing.assert_allclose(ours["probs"], want[0].numpy(), rtol=1e-6, atol=1e-7)
        assert app.vlm._serving is not None
    assert app.vlm.eager_calls == 0


def test_servingapp_predict_retries_after_swap(dirs):
    """A /predict that lands in a label swap's stopped window waits out the
    swap (via _swap_lock) and succeeds on the replacement server."""
    vlm = ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(dirs["hessian_dir"]), weights_dir=str(dirs["weights_dir"]),
        dtype="fp32", prior_num_steps=5, device="cpu").set_class_prompts(PROMPTS)
    app = serve_cli.ServingApp(vlm, batch_size=2, max_wait_ms=0.0, input_dtype="float32")
    try:
        app.server.stop(drain=True)        # the mid-swap stopped window
        app._swap_lock.acquire()           # swap "in progress"
        out = {}
        t = threading.Thread(target=lambda: out.update(probs=app.predict(_images(1, 24)[0])))
        t.start()
        time.sleep(0.2)  # let the first attempt fail and park on the lock
        app.server = app._make().start()   # swap completes
        app._swap_lock.release()
        t.join(timeout=WAIT)
        assert not t.is_alive()
        assert out["probs"].shape == (len(PROMPTS),)
    finally:
        if app._swap_lock.locked():
            app._swap_lock.release()
        app.server.stop(drain=True, timeout=WAIT)


def test_error_status_and_swap_recovery(dirs, monkeypatch):
    """Server faults map to 5xx, and a failed label swap leaves the
    endpoint serving with the old labels."""
    vlm = ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(dirs["hessian_dir"]), weights_dir=str(dirs["weights_dir"]),
        dtype="fp32", prior_num_steps=5, device="cpu").set_class_prompts(PROMPTS)
    app = serve_cli.ServingApp(vlm, batch_size=2, max_wait_ms=0.0, input_dtype="float32",
                               predict_timeout_s=30.0)
    httpd, thread = _serve(app, serve_cli)
    port = httpd.server_address[1]
    req = dict(body=_images(1, 25)[0].tobytes(),
               headers={**OCTET, "X-Image-Dtype": "float32"})
    try:
        def boom(pixels, **kw):
            raise RuntimeError("injected device failure")

        with monkeypatch.context() as mp:
            mp.setattr(vlm, "predict", boom)
            status, err = _request(port, "POST", "/predict", **req)
            assert status == 500 and "injected" in err["error"]

        def tokenizer_explodes(prompts):
            raise RuntimeError("tokenizer exploded")

        with monkeypatch.context() as mp:
            mp.setattr(vlm, "set_class_prompts", tokenizer_explodes)
            status, err = _request(port, "POST", "/class_prompts",
                                   body=json.dumps({"prompts": ["a", "b", "c"]}).encode(),
                                   headers={"Content-Type": "application/json"})
            assert status == 500 and "tokenizer" in err["error"]
        status, pred = _request(port, "POST", "/predict", **req)
        assert status == 200 and len(pred["probs"]) == len(PROMPTS)

        app.server.stop(drain=True)  # shutdown window: 'not accepting' -> 503
        status, err = _request(port, "POST", "/predict", **req)
        assert status == 503
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=WAIT)
        app.server.stop(drain=False, timeout=WAIT)


def _manifest(dirs, tmp, names=("tiny",)):
    """A manifest of tiny-clip lanes on the JAX towers' weights."""
    path = tmp / "fleet.json"
    path.write_text(json.dumps({n: {
        "model_str": "tiny-clip", "hessian_dir": str(dirs["hessian_dir"]),
        "weights_dir": str(dirs["weights_dir"]), "classes_json": str(dirs["classes_json"]),
        "batch_size": 2, "buckets": "pow2"} for n in names}))
    return path


@pytest.mark.parametrize("flag", [["--models_json"], ["--aot_cache"],
                                  ["--models_json", "--aot_cache"]])
def test_models_json_and_aot_cache_flags_work(flag, dirs, tmp_path, capsys):
    """Both flags, alone and together, build a working app: a manifest
    gives a MultiServingApp serving its lane on the same weights, the
    cache directory gets its file (`serving.aotserv`, or `<name>.aotserv`
    a lane), and the rows agree with a VLM built directly."""
    argv = ["--hessian_dir", str(dirs["hessian_dir"]), "--classes_json",
            str(dirs["classes_json"]), "--weights_dir", str(dirs["weights_dir"]),
            "--model_str", "tiny-clip", "--device", "cpu", "--dtype", "fp32",
            "--batch_size", "2", "--verbose"]
    if "--models_json" in flag:
        argv += ["--models_json", str(_manifest(dirs, tmp_path))]
    if "--aot_cache" in flag:
        argv += ["--aot_cache", str(tmp_path / "cache")]
    app = serve_cli.build_app(serve_cli.parse_args(argv))
    img = _images(1, 30)[0]
    try:
        multi = "--models_json" in flag
        assert isinstance(app, serve_cli.MultiServingApp if multi else serve_cli.ServingApp)
        probs = app.predict(img, model="tiny" if multi else None)
    finally:
        app.server.stop(drain=False, timeout=WAIT)
    direct = ProbabilisticVLM.from_pretrained(
        "tiny-clip", str(dirs["hessian_dir"]), weights_dir=str(dirs["weights_dir"]),
        dtype="fp32", device="cpu").set_class_prompts(
            [f"An image of a thing {i}" for i in range(4)])
    # the app pads to its bucket of 2: summation order only
    np.testing.assert_allclose(probs, direct.predict(img[None])[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    if "--aot_cache" in flag:
        name = "tiny.aotserv" if "--models_json" in flag else "serving.aotserv"
        assert [p.name for p in (tmp_path / "cache").iterdir()] == [name]
        assert "[aot_cache] saved serving ladder" in capsys.readouterr().out


def test_aot_cache_restart_flow(dirs, tmp_path, monkeypatch, capsys):
    """tests/test_aot_cache.py's flow on the port: the first build runs the
    Stage-2 preamble and saves; the restart runs none of it (no
    from_pretrained, no Hessian file read), captures the ladder once
    (load_serving) and serves the first build's bits; a changed prompt
    set rebuilds and refreshes the file; the next restart restores the
    new prompt set."""
    from bayesvlm_tpu_torch.io import artifacts

    classes = tmp_path / "classes.json"
    classes.write_text(json.dumps([f"thing {i}" for i in range(4)]))
    args = serve_cli.parse_args([
        "--model_str", "tiny-clip", "--hessian_dir", str(dirs["hessian_dir"]),
        "--weights_dir", str(dirs["weights_dir"]), "--classes_json", str(classes),
        "--device", "cpu", "--dtype", "fp32", "--batch_size", "4", "--buckets", "2,4",
        "--max_wait_ms", "0", "--aot_cache", str(tmp_path / "aot"), "--verbose"])
    calls = {"from_pretrained": 0, "compile_serving": 0, "load_hessians": 0}
    for owner, name in ((ProbabilisticVLM, "compile_serving"), (artifacts, "load_hessians")):
        real = getattr(owner, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(owner, name, counted)
    real_fp = ProbabilisticVLM.from_pretrained.__func__

    def counted_fp(cls, *a, **k):
        calls["from_pretrained"] += 1
        return real_fp(cls, *a, **k)

    monkeypatch.setattr(ProbabilisticVLM, "from_pretrained", classmethod(counted_fp))
    img = _images(1, 31)[0]

    def build(expect_restore):
        for k in calls:
            calls[k] = 0
        app = serve_cli.build_app(args)
        try:
            out = capsys.readouterr().out
            assert ("[aot_cache] restored the serving state" in out) == expect_restore, out
            return app.predict(img), app.vlm, dict(calls), out
        finally:
            app.server.stop(drain=False, timeout=WAIT)

    first, vlm1, c1, _ = build(False)
    assert c1["from_pretrained"] == 1 and c1["load_hessians"] == 2
    assert (tmp_path / "aot" / "serving.aotserv").exists()
    second, vlm2, c2, _ = build(True)
    assert c2 == {"from_pretrained": 0, "compile_serving": 1, "load_hessians": 0}
    np.testing.assert_array_equal(second, first)
    assert vlm2._class_prompts == vlm1._class_prompts and vlm2.info == vlm1.info

    classes.write_text(json.dumps([f"other {i}" for i in range(4)]))
    third, vlm3, c3, out = build(False)
    assert "prompt set differs" in out and c3["from_pretrained"] == 1
    assert "[aot_cache] saved serving ladder" in out  # the runtime block refreshed
    assert third.shape == (4,) and not np.array_equal(third, first)
    fourth, vlm4, c4, _ = build(True)
    assert c4["from_pretrained"] == 0 and vlm4._class_prompts == vlm3._class_prompts
    np.testing.assert_array_equal(fourth, third)


def test_models_json_aot_cache_restores_each_lane(dirs, tmp_path, capsys, monkeypatch):
    """Manifest mode keeps a file a lane: the restart restores both lanes;
    a torn file falls back to a full build of that lane alone (and is
    written again), and a failed save is printed while the server still
    comes up."""
    argv = ["--models_json", str(_manifest(dirs, tmp_path, ("a", "b"))), "--device", "cpu",
            "--dtype", "fp32", "--aot_cache", str(tmp_path / "aot"), "--verbose"]
    img = _images(1, 32)[0]

    def build():
        app = serve_cli.build_app(serve_cli.parse_args(argv))
        try:
            return {n: app.predict(img, model=n) for n in ("a", "b")}, capsys.readouterr().out
        finally:
            app.server.stop(drain=False, timeout=WAIT)

    first, out = build()
    assert sorted(p.name for p in (tmp_path / "aot").iterdir()) == ["a.aotserv", "b.aotserv"]
    second, out = build()
    assert out.count("[aot_cache] restored the serving state") == 2
    data = (tmp_path / "aot" / "b.aotserv").read_bytes()
    (tmp_path / "aot" / "b.aotserv").write_bytes(data[:len(data) // 3])
    third, out = build()
    assert out.count("[aot_cache] restored the serving state") == 1
    assert "full restore unavailable" in out and "stale" in out
    assert "[aot_cache] saved serving ladder to" in out and "b.aotserv" in out
    for rows in (second, third):
        for n in ("a", "b"):
            np.testing.assert_array_equal(rows[n], first[n])

    def fail(self, path, include_runtime=True):
        raise OSError("disk full")

    monkeypatch.setattr(ProbabilisticVLM, "save_serving", fail)
    (tmp_path / "aot" / "a.aotserv").unlink()
    fourth, out = build()
    assert "[aot_cache] save failed (disk full); serving without cache" in out
    np.testing.assert_array_equal(fourth["a"], first["a"])


def test_cli_aot_cache_restart_reads_no_hessian_dir(dirs, tmp_path):
    """`python -m bayesvlm_tpu_torch.serve_cli --aot_cache` twice on one
    directory: the first run builds and saves; the second, with its
    Hessian directory deleted, says it restored and answers with the
    first run's bits."""
    import shutil

    hdir = tmp_path / "hessians"
    shutil.copytree(dirs["hessian_dir"], hdir)
    argv = ["--model_str", "tiny-clip", "--hessian_dir", str(hdir), "--classes_json",
            str(dirs["classes_json"]), "--weights_dir", str(dirs["weights_dir"]),
            "--device", "cpu", "--dtype", "fp32", "--input_dtype", "uint8",
            "--buckets", "pow2", "--batch_size", "4", "--port", "0", "--verbose",
            "--aot_cache", str(tmp_path / "aot")]
    answers, logs = [], []
    for run in range(2):
        proc = subprocess.Popen([sys.executable, "-m", "bayesvlm_tpu_torch.serve_cli",
                                 *argv], cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                         daemon=True).start()
        try:
            seen = []
            while not any(x.startswith("serving on") for x in seen):
                seen.append(lines.get(timeout=WAIT))
            port = int(seen[-1].split(":")[1].split()[0])
            replies = [_request(port, "POST", "/predict", _u8(1, 40 + i)[0].tobytes(),
                                {**OCTET, "X-Image-Dtype": "uint8"}) for i in range(3)]
            assert all(status == 200 for status, _ in replies)
            answers.append([r["probs"] for _, r in replies])
            logs.append("".join(seen))
        finally:
            proc.kill()
            proc.communicate(timeout=WAIT)
        if run == 0:
            shutil.rmtree(hdir)  # the restart must not need it
    assert "[aot_cache] saved serving ladder" in logs[0]
    assert "[aot_cache] restored the serving state" in logs[1]
    assert answers[1] == answers[0]


def test_flags_and_defaults_match_jax(monkeypatch):
    jmod = _load_jax_cli()
    monkeypatch.setattr(sys, "argv", ["serve.py"])
    theirs = vars(jmod.parse_args())
    ours = vars(serve_cli.parse_args([]))
    assert ours.pop("device") == "cuda" and theirs.pop("device") == "tpu"
    assert ours == theirs
    with pytest.raises(SystemExit, match="required"):
        serve_cli.main(serve_cli.parse_args(["--hessian_dir", "h"]))


def test_cli_serves_without_jax(dirs):
    """`python -m bayesvlm_tpu_torch.serve_cli --device cpu` on port 0 answers
    /healthz and an octet-stream uint8 /predict, and loads no JAX."""
    code = (
        "import http.server, runpy, sys\n"
        "serve_forever = http.server.ThreadingHTTPServer.serve_forever\n"
        "def checked(self):\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'bayesvlm_tpu')]\n"
        "    print('NO_JAX' if not bad else f'LOADED {bad}', flush=True)\n"
        "    serve_forever(self)\n"
        "http.server.ThreadingHTTPServer.serve_forever = checked\n"
        "sys.argv = ['serve_cli', '--model_str', 'tiny-clip', '--hessian_dir', "
        f"{str(dirs['hessian_dir'])!r}, '--classes_json', {str(dirs['classes_json'])!r}, "
        f"'--weights_dir', {str(dirs['weights_dir'])!r}, '--device', 'cpu', "
        "'--dtype', 'fp32', '--input_dtype', 'uint8', '--buckets', 'pow2', "
        "'--batch_size', '4', '--port', '0', '--no_mesh']\n"
        "runpy.run_module('bayesvlm_tpu_torch.serve_cli', run_name='__main__')\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()  # read on a thread, so that every wait has a timeout
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    try:
        seen = []
        while not any(x.startswith(("NO_JAX", "LOADED")) for x in seen):
            seen.append(lines.get(timeout=WAIT))
        assert "NO_JAX\n" in seen, seen
        line = next(x for x in seen if x.startswith("serving on"))
        port = int(line.split(":")[1].split()[0])
        status, health = _request(port, "GET", "/healthz")
        assert status == 200 and health["buckets"] == [1, 2, 4]
        assert health["input_dtype"] == "uint8" and health["pipeline_depth"] == 0
        status, out = _request(port, "POST", "/predict", _u8(1, 14)[0].tobytes(),
                               {**OCTET, "X-Image-Dtype": "uint8"})
        assert status == 200 and len(out["probs"]) == 4
        assert sum(out["probs"]) == pytest.approx(1.0, rel=1e-5)
    finally:
        proc.kill()
        proc.communicate(timeout=WAIT)
