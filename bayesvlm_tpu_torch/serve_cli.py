"""HTTP serving front end for probabilistic zero-shot inference, the port
of the JAX package's `scripts/serve.py` (single-model mode; no reference
counterpart: the reference has batch scripts only,
ref:scripts/zeroshot.py:25-128): `serve.BatchingServer` (dynamic
micro-batching onto the CUDA-graph ladder of
`pipeline.ProbabilisticVLM.compile_serving`) behind a stdlib
ThreadingHTTPServer. Runs on the card unless `--device` names another.

Endpoints
---------
POST /predict
    application/octet-stream: raw image bytes + headers
        X-Image-Shape: "224,224,3"   (row-major, channels-last)
        X-Image-Dtype: "float32" | "uint8"
    application/json: {"image": [[[...]]]}  (nested lists)
    -> {"probs": [...], "class": <argmax>, "latency_ms": ...}
POST /class_prompts
    {"prompts": ["a photo of a cat", ...]}: swaps the label set (drains
    in-flight requests, re-encodes the prompts, captures the ladder again
    if the class count changed)
GET /healthz   -> {"ok": true, ...the ladder's signature...}
GET /stats     -> server counters (fill, p50/p95 latency, ...)

Not ported yet, and refused by name before anything loads:
`--models_json` (several models behind one server) and `--aot_cache`
(the persisted serving state).

Example
-------
  python -m bayesvlm_tpu_torch.serve_cli --model_str clip-large \\
      --hessian_dir hessians/... --classes_json classes.json \\
      --input_dtype uint8 --buckets pow2 --batch_size 64 --port 8000
  curl -X POST localhost:8000/predict -H 'Content-Type: application/octet-stream' \\
      -H 'X-Image-Shape: 224,224,3' -H 'X-Image-Dtype: uint8' \\
      --data-binary @image.raw
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


def _refuse_unported(args) -> None:
    flags = {"--models_json (several models behind one server)": args.models_json,
             "--aot_cache (the persisted serving state)": args.aot_cache}
    asked = [name for name, on in flags.items() if on]
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)}")


def _load_vlm(args):
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    vlm = ProbabilisticVLM.from_pretrained(
        args.model_str, args.hessian_dir,
        weights_dir=args.weights_dir, tokenizer_dir=args.tokenizer_dir,
        dtype=args.dtype, mlp_int8=args.mlp_int8, device=args.device,
    )
    return vlm.set_class_prompts(_build_prompts(args.classes_json, args.text_prompt))


def build_app(args) -> ServingApp:
    """The VLM (from_pretrained -> set_class_prompts) behind a started
    ServingApp; its BatchingServer captures the ladder."""
    _refuse_unported(args)
    app = ServingApp(_load_vlm(args), args.batch_size, args.max_wait_ms,
                     args.input_dtype,
                     predict_timeout_s=args.predict_timeout_s,
                     buckets=_parse_buckets(args.buckets),
                     pipeline_depth=args.pipeline_depth)
    app.verbose = args.verbose
    return app


def main(args) -> None:
    _refuse_unported(args)
    if not (args.hessian_dir and args.classes_json):
        raise SystemExit("--hessian_dir and --classes_json are required")
    app = build_app(args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(app))
    print(f"serving on {args.host}:{httpd.server_address[1]} "
          f"(batch_size={args.batch_size}, wait={args.max_wait_ms}ms)", flush=True)
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
    p.add_argument("--hessian_dir", default=None, help="required")
    p.add_argument("--weights_dir", default=None,
                   help="an HF snapshot or the port's vision.pt / text.pt")
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--classes_json", default=None,
                   help="JSON list of class names (required)")
    p.add_argument("--models_json", default=None,
                   help="not ported yet (several models behind one server)")
    p.add_argument("--text_prompt", default="An image of a {class_name}")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--input_dtype", choices=["float32", "uint8"],
                   default="float32")
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--no_mesh", dest="use_mesh", action="store_false",
                   help="accepted for the JAX CLI's flags; the port builds no "
                        "mesh, so it changes nothing")
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
    p.add_argument("--aot_cache", default=None,
                   help="not ported yet (the persisted serving state)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
