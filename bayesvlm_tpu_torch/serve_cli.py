"""HTTP serving front end for probabilistic zero-shot inference, the port
of the JAX package's `scripts/serve.py` (no reference counterpart: the
reference has batch scripts only, ref:scripts/zeroshot.py:25-128):
`serve.BatchingServer` (dynamic micro-batching onto the CUDA-graph ladder
of `pipeline.ProbabilisticVLM.compile_serving`), or for several models
`multiserve.MultiModelServer`, behind a stdlib ThreadingHTTPServer. Runs
on the card unless `--device` names another.

Endpoints
---------
POST /predict            (one model; or a manifest of one model)
POST /predict/<model>    (manifest mode)
    application/octet-stream: raw image bytes + headers
        X-Image-Shape: "224,224,3"   (row-major, channels-last)
        X-Image-Dtype: "float32" | "uint8"
    application/json: {"image": [[[...]]]}  (nested lists)
    -> {"probs": [...], "class": <argmax>, "latency_ms": ...}
POST /class_prompts           (one model)
POST /class_prompts/<model>   (manifest mode)
    {"prompts": ["a photo of a cat", ...]}: swaps the label set (drains
    in-flight requests, re-encodes the prompts, captures the ladder again
    if the class count changed; in manifest mode the swap pauses every
    resident model: the lanes share one dispatcher)
GET /healthz   -> {"ok": true, ...the ladder's signature(s)...}
GET /stats     -> server counters (fill, p50/p95 latency, ...; per model
                  in manifest mode)

Several models on one card (`--models_json`): a JSON dict name ->
{model_str, hessian_dir, classes_json, [weights_dir, tokenizer_dir,
text_prompt, batch_size, buckets, input_dtype, dtype, mlp_int8]};
omitted fields take the CLI flags' values.

Several cards: with more than one card visible each model is served on
the serving mesh (`pipeline.from_pretrained(mesh="auto")`: a replica of
its image tower a card, every batch split over them, so `--batch_size`
and the buckets must be multiples of the card count); `--no_mesh` serves
on the one card `--device` names.

Restarts (`--aot_cache DIR`): the serving state is saved to
`DIR/serving.aotserv` (`DIR/<name>.aotserv` a model in manifest mode,
`pipeline.save_serving`); the next start brings each model up from it
(`from_serving_cache`: towers from weights, labels / head / lambdas from
the file, no Hessian directory read, no lambda re-opt), captures the
ladder again, and falls back to a full build when the file is missing,
stale or was saved from another prompt set.

Example
-------
  python -m bayesvlm_tpu_torch.serve_cli --model_str clip-large \\
      --hessian_dir hessians/... --classes_json classes.json \\
      --input_dtype uint8 --buckets pow2 --batch_size 64 --port 8000 \\
      --aot_cache serving_cache
  curl -X POST localhost:8000/predict -H 'Content-Type: application/octet-stream' \\
      -H 'X-Image-Shape: 224,224,3' -H 'X-Image-Dtype: uint8' \\
      --data-binary @image.raw
  # several models:
  python -m bayesvlm_tpu_torch.serve_cli --models_json fleet.json --port 8000
  curl -X POST localhost:8000/predict/siglip ...
"""

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

_INPUT_DTYPES = {"float32": torch.float32, "uint8": torch.uint8}


class ServingApp:
    """Owns the VLM + BatchingServer; serializes label-set swaps."""

    def __init__(self, vlm, batch_size: int, max_wait_ms: float,
                 input_dtype: str, predict_timeout_s: float = 120.0,
                 buckets=None, pipeline_depth: int = 0):
        from bayesvlm_tpu_torch.serve import BatchingServer

        self._dtype = _INPUT_DTYPES[input_dtype]
        self._make = lambda: BatchingServer(
            vlm, batch_size, max_wait_ms=max_wait_ms,
            input_dtype=self._dtype, buckets=buckets,
            pipeline_depth=pipeline_depth,
        )
        self.vlm = vlm
        self.verbose = False
        self.predict_timeout_s = predict_timeout_s
        self.server = self._make().start()
        self._swap_lock = threading.Lock()

    def predict(self, image: np.ndarray, model=None) -> np.ndarray:
        if model is not None:
            raise KeyError(
                "single-model server: POST /predict (no model path)")
        # A request can race a /class_prompts swap into the stopped
        # window; retry on the replacement server after the swap ends
        # (waiting on _swap_lock) instead of surfacing a client error.
        for _ in range(2):
            try:
                return self.server.predict(
                    image, timeout=self.predict_timeout_s)
            except RuntimeError as exc:
                if "not accepting" not in str(exc):
                    raise
                with self._swap_lock:
                    pass  # swap (or shutdown) finished; retry once
        return self.server.predict(image, timeout=self.predict_timeout_s)

    def set_class_prompts(self, prompts, model=None):
        """Drain, swap labels, restart (the new server captures the ladder
        again if the class count dropped it). The old dispatcher must have
        exited before the labels change (timeout=None): it may be mid-replay,
        and a capture must not run beside another thread's CUDA work.
        Exception-safe: the endpoint comes back up even if the swap itself
        fails."""
        if model is not None:
            raise KeyError(
                "single-model server: POST /class_prompts (no model path)")
        with self._swap_lock:
            self.server.stop(drain=True, timeout=None)
            try:
                self.vlm.set_class_prompts(prompts)
            finally:
                # restart with whatever labels the VLM now holds (new on
                # success, old if set_class_prompts raised) so /predict
                # keeps working either way
                self.server = self._make().start()

    def signature(self) -> dict:
        return {"ok": True, **self.server.signature()}

    def stats_dict(self) -> dict:
        return vars(self.server.stats())


class MultiServingApp:
    """Owns several resident VLMs behind one MultiModelServer. Same swap
    contract as ServingApp, but a /class_prompts/<model> swap drains and
    rebuilds the whole multiplexer (the lanes share one dispatcher), so
    the other models pause while it runs."""

    def __init__(self, vlms: dict, batch_size, max_wait_ms: float,
                 input_dtype, predict_timeout_s: float = 120.0,
                 buckets=None, pipeline_depth: int = 0):
        from bayesvlm_tpu_torch.multiserve import MultiModelServer

        dt = ({k: _INPUT_DTYPES[v] for k, v in input_dtype.items()}
              if isinstance(input_dtype, dict) else _INPUT_DTYPES[input_dtype])
        self.vlms = dict(vlms)
        self._make = lambda: MultiModelServer(
            self.vlms, batch_size, max_wait_ms=max_wait_ms,
            input_dtype=dt, buckets=buckets,
            pipeline_depth=pipeline_depth,
        )
        self.verbose = False
        self.predict_timeout_s = predict_timeout_s
        self.server = self._make().start()
        self._swap_lock = threading.Lock()

    def _resolve(self, model):
        if model is None:
            if len(self.vlms) == 1:
                return next(iter(self.vlms))
            raise KeyError(
                f"model name required (POST /predict/<model>); resident: "
                f"{sorted(self.vlms)}")
        if model not in self.vlms:
            raise KeyError(
                f"unknown model {model!r}; resident: {sorted(self.vlms)}")
        return model

    def predict(self, image: np.ndarray, model=None) -> np.ndarray:
        model = self._resolve(model)
        for _ in range(2):
            try:
                return self.server.predict(
                    model, image, timeout=self.predict_timeout_s)
            except RuntimeError as exc:
                if "not accepting" not in str(exc):
                    raise
                with self._swap_lock:
                    pass  # swap (or shutdown) finished; retry once
        return self.server.predict(model, image,
                                   timeout=self.predict_timeout_s)

    def set_class_prompts(self, prompts, model=None):
        """Drain the whole multiplexer (timeout=None: the dispatcher and
        the resolver have exited, so no replay runs beside a recapture),
        swap one lane's labels, build and start a new multiplexer (the
        changed lane captures again if its class count dropped its
        ladder). The endpoint comes back up even if the swap fails."""
        model = self._resolve(model)
        with self._swap_lock:
            self.server.stop(drain=True, timeout=None)
            try:
                self.vlms[model].set_class_prompts(prompts)
            finally:
                self.server = self._make().start()

    def signature(self) -> dict:
        return {"ok": True, "models": self.server.signature(),
                "hbm_gib": self.server.hbm_footprint()}

    def stats_dict(self) -> dict:
        return {name: vars(s) for name, s in self.server.stats().items()}


def _parse_image(handler: BaseHTTPRequestHandler) -> np.ndarray:
    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "")
    if ctype.startswith("application/octet-stream"):
        shape = tuple(
            int(x) for x in handler.headers["X-Image-Shape"].split(","))
        dtype = np.dtype(handler.headers.get("X-Image-Dtype", "float32"))
        arr = np.frombuffer(body, dtype=dtype)
        if arr.size != int(np.prod(shape)):
            raise ValueError(
                f"payload has {arr.size} elements, shape {shape} needs "
                f"{int(np.prod(shape))}")
        return arr.reshape(shape)
    payload = json.loads(body)
    return np.asarray(payload["image"], dtype=np.float32)


def make_handler(app: ServingApp):
    class Handler(BaseHTTPRequestHandler):
        # quiet by default; --verbose restores BaseHTTPRequestHandler logs
        def log_message(self, fmt, *args):  # noqa: D102
            if app.verbose:
                super().log_message(fmt, *args)

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self._responded = True  # no second status line after this
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        @staticmethod
        def _status_for(exc: Exception) -> int:
            """Client errors -> 4xx, server faults -> 5xx (so clients and
            load balancers retry the right things)."""
            import concurrent.futures
            import queue as queue_mod

            if isinstance(exc, queue_mod.Full):
                return 429  # backpressure: retry later
            if isinstance(exc, concurrent.futures.TimeoutError):
                return 504  # the card did not answer within predict_timeout_s
            if isinstance(exc, (ValueError, KeyError, TypeError)):
                return 400  # malformed request (shape/dtype/JSON)
            if isinstance(exc, RuntimeError) and "not accepting" in str(exc):
                return 503  # shutting down / mid-swap
            return 500

        @staticmethod
        def _route(path: str, stem: str):
            """Match `/<stem>` (None model) or `/<stem>/<model>`;
            no-match -> (False, None)."""
            if path == f"/{stem}":
                return True, None
            prefix = f"/{stem}/"
            if path.startswith(prefix) and len(path) > len(prefix):
                return True, path[len(prefix):]
            return False, None

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/healthz":
                self._send(200, app.signature())
            elif self.path == "/stats":
                self._send(200, app.stats_dict())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            import time

            self._responded = False
            try:
                hit, model = self._route(self.path, "predict")
                if hit:
                    t0 = time.monotonic()
                    probs = app.predict(_parse_image(self), model=model)
                    self._send(200, {
                        "probs": np.asarray(probs, np.float64).tolist(),
                        "class": int(np.argmax(probs)),
                        "latency_ms": (time.monotonic() - t0) * 1000.0,
                    })
                    return
                hit, model = self._route(self.path, "class_prompts")
                if hit:
                    length = int(self.headers.get("Content-Length", 0))
                    prompts = json.loads(self.rfile.read(length))["prompts"]
                    app.set_class_prompts(prompts, model=model)
                    self._send(200, {"ok": True, "num_classes": len(prompts)})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except Exception as exc:  # noqa: BLE001 — client-visible error
                if self._responded:
                    # failure mid-write (e.g. client hung up): the status
                    # line is already on the wire — never write a second
                    # response onto a half-written stream
                    self.close_connection = True
                    return
                self._send(self._status_for(exc),
                           {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def _parse_buckets(spec):
    if not spec:
        return None
    return "pow2" if spec == "pow2" else [int(b) for b in spec.split(",")]


def _build_prompts(classes_json, text_prompt):
    return [text_prompt.format(class_name=c)
            for c in json.loads(Path(classes_json).read_text())]


def _load_vlm(args, model_str, hessian_dir, weights_dir, tokenizer_dir,
              dtype, mlp_int8, classes_json, text_prompt):
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    vlm = ProbabilisticVLM.from_pretrained(
        model_str, hessian_dir,
        weights_dir=weights_dir, tokenizer_dir=tokenizer_dir,
        dtype=dtype, mlp_int8=mlp_int8, device=args.device,
        mesh="auto" if args.use_mesh else None,
    )
    return vlm.set_class_prompts(_build_prompts(classes_json, text_prompt))


def _aot_full_restore(path, verbose, *, model_str, weights_dir, tokenizer_dir,
                      dtype, mlp_int8, device, use_mesh, prompts):
    """The restart lane (pipeline.from_serving_cache): towers from weights,
    labels / head / lambdas from the file, the ladder captured again; no
    Hessian directory, no lambda re-opt, no text tower. (vlm, its serving
    dict) or (None, None) when the file is absent or stale, or was saved
    from another prompt set than the one configured now (its labels would
    be stale: the caller builds in full, and may still take the file's
    ladder signature through _aot_restore)."""
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    try:
        vlm = ProbabilisticVLM.from_serving_cache(
            model_str, path, weights_dir=weights_dir,
            tokenizer_dir=tokenizer_dir, dtype=dtype, mlp_int8=mlp_int8,
            device=device, mesh="auto" if use_mesh else None)
    except FileNotFoundError:
        return None, None
    except Exception as exc:  # noqa: BLE001 — any stale cache -> rebuild
        print(f"[aot_cache] full restore unavailable ({exc}); building",
              flush=True)
        return None, None
    if vlm._class_prompts != list(prompts):
        print("[aot_cache] configured prompt set differs from the cached "
              "labels; rebuilding", flush=True)
        return None, None
    if verbose:
        print(f"[aot_cache] restored the serving state from {path} (no Hessian "
              "directory read; ladder captured again)", flush=True)
    return vlm, vlm._serving


def _aot_restore(vlm, path, verbose):
    """The ladder of the file on a fully built VLM (pipeline.load_serving):
    its serving dict (the sentinel _aot_persist compares with), or None
    when the file is absent or stale (the BatchingServer then captures
    the ladder it needs)."""
    try:
        vlm.load_serving(path)
        if verbose:
            print(f"[aot_cache] restored serving ladder from {path}",
                  flush=True)
        return vlm._serving
    except FileNotFoundError:
        return None
    except Exception as exc:  # noqa: BLE001 — any stale cache -> recapture
        print(f"[aot_cache] stale ({exc}); recompiling", flush=True)
        return None


def _aot_persist(vlm, path, restored, verbose, refresh=False):
    """Save the serving state iff the BatchingServer captured the ladder
    again (its serving dict is not the one restored), or when `refresh`
    says the file's runtime block is missing or stale (the ladder was
    reused, but the next restart should take the restart lane with the
    current labels). A failed save is printed; the server comes up."""
    if vlm._serving is None or (vlm._serving is restored and not refresh):
        return
    try:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        vlm.save_serving(path)
    except Exception as exc:  # noqa: BLE001 — persistence is best-effort
        print(f"[aot_cache] save failed ({exc}); serving without cache",
              flush=True)
        return
    if verbose:
        print(f"[aot_cache] saved serving ladder to {path}", flush=True)


def _build_one(args, aot_path, *, model_str, hessian_dir, weights_dir,
               tokenizer_dir, dtype, mlp_int8, classes_json, text_prompt):
    """One model's VLM, by the restart lane when `aot_path` allows it:
    (vlm, restored serving dict or None, refresh)."""
    vlm = restored = None
    if aot_path is not None:
        vlm, restored = _aot_full_restore(
            aot_path, args.verbose, model_str=model_str, weights_dir=weights_dir,
            tokenizer_dir=tokenizer_dir, dtype=dtype, mlp_int8=mlp_int8,
            device=args.device, use_mesh=args.use_mesh,
            prompts=_build_prompts(classes_json, text_prompt))
    refresh = False
    if vlm is None:
        if hessian_dir is None:
            raise KeyError("hessian_dir")  # a full build needs it
        vlm = _load_vlm(args, model_str, hessian_dir, weights_dir, tokenizer_dir,
                        dtype, mlp_int8, classes_json, text_prompt)
        if aot_path is not None:
            restored = _aot_restore(vlm, aot_path, args.verbose)
            # ladder reused but the restart lane refused: refresh the
            # file's runtime block for the next restart
            refresh = restored is not None
    return vlm, restored, refresh


def build_app(args):
    """The VLM(s) behind a started ServingApp, or MultiServingApp with
    `--models_json`; with `--aot_cache` each restored from its file where
    it can be, and its serving state saved after the build."""
    aot_cache = args.aot_cache
    if args.models_json:
        manifest = json.loads(Path(args.models_json).read_text())
        if not isinstance(manifest, dict) or not manifest:
            raise ValueError("--models_json must be a non-empty JSON dict "
                             "name -> model spec")
        vlms, batch_size, buckets, input_dtype = {}, {}, {}, {}
        restored, refresh = {}, {}
        for name, spec in manifest.items():
            vlms[name], restored[name], refresh[name] = _build_one(
                args, Path(aot_cache) / f"{name}.aotserv" if aot_cache else None,
                model_str=spec.get("model_str", args.model_str),
                hessian_dir=spec.get("hessian_dir"),
                weights_dir=spec.get("weights_dir", args.weights_dir),
                tokenizer_dir=spec.get("tokenizer_dir", args.tokenizer_dir),
                dtype=spec.get("dtype", args.dtype),
                mlp_int8=bool(spec.get("mlp_int8", args.mlp_int8)),
                classes_json=spec["classes_json"],
                text_prompt=spec.get("text_prompt", args.text_prompt))
            batch_size[name] = int(spec.get("batch_size", args.batch_size))
            buckets[name] = _parse_buckets(spec.get("buckets", args.buckets))
            input_dtype[name] = spec.get("input_dtype", args.input_dtype)
        app = MultiServingApp(vlms, batch_size, args.max_wait_ms, input_dtype,
                              predict_timeout_s=args.predict_timeout_s,
                              buckets=buckets,
                              pipeline_depth=args.pipeline_depth)
        app.verbose = args.verbose
        if aot_cache:
            for name, vlm in vlms.items():
                _aot_persist(vlm, Path(aot_cache) / f"{name}.aotserv",
                             restored[name], args.verbose, refresh=refresh[name])
        return app

    aot_path = Path(aot_cache) / "serving.aotserv" if aot_cache else None
    vlm, restored, refresh = _build_one(
        args, aot_path, model_str=args.model_str, hessian_dir=args.hessian_dir,
        weights_dir=args.weights_dir, tokenizer_dir=args.tokenizer_dir,
        dtype=args.dtype, mlp_int8=args.mlp_int8, classes_json=args.classes_json,
        text_prompt=args.text_prompt)
    app = ServingApp(vlm, args.batch_size, args.max_wait_ms, args.input_dtype,
                     predict_timeout_s=args.predict_timeout_s,
                     buckets=_parse_buckets(args.buckets),
                     pipeline_depth=args.pipeline_depth)
    app.verbose = args.verbose
    if aot_path is not None:
        _aot_persist(vlm, aot_path, restored, args.verbose, refresh=refresh)
    return app


def main(args) -> None:
    if not args.models_json and not (args.hessian_dir and args.classes_json):
        raise SystemExit(
            "--hessian_dir and --classes_json are required "
            "(or pass --models_json for multi-model mode)")
    app = build_app(args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(app))
    what = (f"models={sorted(app.vlms)}" if hasattr(app, "vlms")
            else f"batch_size={args.batch_size}")
    print(f"serving on {args.host}:{httpd.server_address[1]} "
          f"({what}, wait={args.max_wait_ms}ms)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.server.stop(drain=False)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_str", default="clip-base")
    p.add_argument("--hessian_dir", default=None,
                   help="required unless --models_json is given")
    p.add_argument("--weights_dir", default=None,
                   help="an HF snapshot or the port's vision.pt / text.pt")
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--classes_json", default=None,
                   help="JSON list of class names (required unless "
                        "--models_json is given)")
    p.add_argument("--models_json", default=None,
                   help="several models on one card: JSON dict name -> "
                        "{model_str, hessian_dir, classes_json, "
                        "[weights_dir, tokenizer_dir, text_prompt, "
                        "batch_size, buckets, input_dtype, dtype, "
                        "mlp_int8]}; omitted fields take the CLI flags. "
                        "Serves POST /predict/<name>.")
    p.add_argument("--text_prompt", default="An image of a {class_name}")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--input_dtype", choices=["float32", "uint8"],
                   default="float32")
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--no_mesh", dest="use_mesh", action="store_false",
                   help="serve on one card: without it, every visible card "
                        "holds a replica of the image tower and each batch is "
                        "split over them (the serving mesh; batch sizes and "
                        "buckets must then be multiples of the card count)")
    p.add_argument("--mlp_int8", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the ladder eagerly")
    p.add_argument("--buckets", default=None,
                   help="batch-size ladder for partial batches: 'pow2' "
                        "or a comma list (e.g. '1,4'); partial batches "
                        "dispatch to the smallest size that fits instead "
                        "of padding to --batch_size")
    p.add_argument(
        "--pipeline_depth", type=int, default=0,
        help="0 resolves each batch inline; >0 overlaps the device->host "
        "copy and resolution of one batch with the execution of the next "
        "(a resolver thread; bounds the batches in flight)")
    p.add_argument("--predict_timeout_s", type=float, default=120.0,
                   help="bound on a single request's wait for its batch "
                        "result; expiry returns HTTP 504 instead of "
                        "leaking a blocked handler thread")
    p.add_argument(
        "--aot_cache", default=None,
        help="directory of the persisted serving state "
             "(pipeline.save_serving): a restart restores labels, head and "
             "lambdas from it without the Hessian directory and captures "
             "the ladder again; a stale or mismatched file falls back to a "
             "full build. Manifest mode writes <name>.aotserv a model")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
