"""Dynamic micro-batching server for low-latency probabilistic serving,
the port of `bayesvlm_tpu.serve` (BatchingServer; no reference
counterpart: the reference has batch scripts only,
ref:scripts/zeroshot.py:25-128).

A single dispatcher thread owns the card: concurrent callers enqueue one
image each, and the dispatcher coalesces them into fixed-shape batches
for the serving ladder of `pipeline.ProbabilisticVLM.compile_serving`
(one CUDA-graph replay per batch, probit softmax on the card, semantics
of ref:scripts/zeroshot.py:119-120). The dispatcher is the only thread
that replays: the graphs share static buffers and one memory pool.
Partial batches (a lone request after `max_wait_ms`) are padded to a
ladder size with a repeat of the last row; padded rows are sliced off
before futures resolve, so callers never see padding. With `buckets` (a
ladder of sizes) a partial batch dispatches to the smallest size that
fits, cutting the padding from (batch_size - n) to (bucket - n) rows.

    vlm = ProbabilisticVLM.from_pretrained(...).set_class_prompts(classes)
    server = BatchingServer(vlm, batch_size=8, max_wait_ms=3.0)
    server.start()
    fut = server.submit(image)          # concurrent.futures.Future
    probs = fut.result()                # [C] calibrated probabilities
    probs = server.predict(image)       # sync convenience
    server.stop(drain=True)

`serve_cli.py` wraps this in an HTTP front end.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["BatchingServer", "ServerStats"]

_STOP = object()  # queue sentinel: dispatcher exits after seeing it


def _fail(future: Future, exc: BaseException) -> None:
    """set_exception tolerating futures already cancelled by the caller."""
    try:
        future.set_exception(exc)
    except InvalidStateError:
        pass


def _to_numpy(probs) -> np.ndarray:
    """A batch's probabilities as a host array of its own (a pinned ring
    slot is reused by a later batch)."""
    if isinstance(probs, torch.Tensor):
        return probs.detach().cpu().numpy().copy()
    return np.array(probs)


def _resolve_loop(q) -> None:
    """Resolver thread of a pipelined server: consumes (lane, live,
    host_buffer, event, bucket, n) tuples, waits on the event that follows
    the batch's device-to-host copy, and resolves the futures. The
    dispatcher has enqueued that copy right after the batch's replay and
    moved on, so the copy and the resolution of batch N overlap the
    execution of batch N+1. FIFO, so futures resolve in dispatch order."""
    while True:
        item = q.get()
        if item is _STOP:
            return
        lane, live, host, event, bucket, n = item
        try:
            if event is not None:
                event.synchronize()
            probs = _to_numpy(host)
        except Exception as exc:  # noqa: BLE001 — propagate to callers
            with lane._lock:
                lane._stats.errors += n
            for req in live:
                _fail(req.future, exc)
            continue
        try:
            lane._finish(live, probs, bucket, n)
        except Exception:  # noqa: BLE001 — the resolver must NOT die
            with lane._lock:
                lane._stats.errors += 1


@dataclass
class ServerStats:
    """Counters since start(); fill = served rows / dispatched rows."""

    requests: int = 0
    batches: int = 0
    dispatched_rows: int = 0
    padded_rows: int = 0
    errors: int = 0
    queue_depth: int = 0
    fill: float = 1.0
    latency_ms_p50: float = 0.0
    latency_ms_p95: float = 0.0
    latency_ms_max: float = 0.0


class _Request:
    __slots__ = ("image", "future", "t_enqueue")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


class BatchingServer:
    """Coalesce concurrent single-image requests into batches on the
    serving ladder.

    Parameters
    ----------
    vlm : ProbabilisticVLM with class prompts set. If its ladder is
        missing, of another input dtype or lacks a size of this server's,
        `compile_serving(buckets, input_dtype)` is run here.
    batch_size : the largest batch per dispatch.
    max_wait_ms : how long the dispatcher holds an open batch after the
        FIRST request arrives before dispatching it partially filled.
        Lower = better tail latency at low load; higher = better fill
        (throughput) under load. 0 dispatches whatever a single drain
        of the queue yields.
    input_dtype : the ladder's input dtype. torch.uint8 puts the /255 +
        normalize into the graphs (raw crops: a quarter of the bytes
        host to device of float32).
    max_queue : backpressure bound; submit() raises queue.Full beyond it.
    buckets : batch-size ladder for partial batches: a CUDA graph has
        static shapes, so a partial batch pads to the smallest size that
        fits instead of to batch_size. None (default): batch_size only;
        "pow2": a power-of-two ladder up to batch_size; a list of ints as
        it is (batch_size is always included). On a serving mesh of n
        replicas every size is a multiple of n, and "pow2" starts at n
        (JAX `serve.py:192-199`).
    pipeline_depth : 0 (default) resolves each batch inline: the
        dispatcher waits for the batch's probabilities before it takes
        the next batch. >0 starts a resolver thread (`_resolve_loop`):
        right after each replay the dispatcher enqueues the copy of the
        output into a pinned host buffer on the same stream, records an
        event, hands both to the resolver and goes on to the next batch,
        so the copy and the resolution overlap the next batch's work. The
        value bounds the batches in flight. Results still resolve in
        dispatch order.
    """

    def __init__(self, vlm, batch_size: int, max_wait_ms: float = 5.0,
                 input_dtype: torch.dtype = torch.float32, max_queue: int = 1024,
                 buckets=None, pipeline_depth: int = 0):
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        self._resolve_q = None
        self._resolve_thread: Optional[threading.Thread] = None
        # pinned host buffers of the batches in flight: the resolver holds
        # one, its queue up to pipeline_depth and the dispatcher one more
        self._host_ring: list = [None] * (self.pipeline_depth + 2)
        self._ring_next = 0
        self.batch_size = int(batch_size)
        mesh = getattr(vlm, "mesh", None)
        self._buckets = self._build_ladder(buckets, 1 if mesh is None else mesh.size)
        srv = vlm._serving
        if (srv is None or srv["dtype"] != input_dtype
                or not set(self._buckets).issubset(srv["programs"])):
            vlm.compile_serving(self._buckets, input_dtype=input_dtype)
        self.vlm = vlm
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._shape = vlm._serving["image_shape"]  # (H, W, 3)
        self._dtype = torch.empty(0, dtype=vlm._serving["dtype"]).numpy().dtype
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._accepting = False
        self._lock = threading.Lock()
        self._lat_ring = np.zeros(1024, np.float64)
        self._lat_n = 0
        self._stats = ServerStats()

    def _build_ladder(self, buckets, step: int = 1) -> list:
        """Sorted batch-size ladder ending at batch_size; every size a
        multiple of `step`, the serving mesh's size."""
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if step > 1 and self.batch_size % step != 0:
            raise ValueError(
                f"batch_size {self.batch_size} must be divisible by "
                f"the {step}-way 'data' mesh axis")
        if buckets is None:
            return [self.batch_size]
        if buckets == "pow2":
            ladder, b = [], step
            while b < self.batch_size:
                ladder.append(b)
                b *= 2
            return ladder + [self.batch_size]
        ladder = sorted({int(b) for b in buckets} | {self.batch_size})
        bad = [b for b in ladder
               if b < 1 or b > self.batch_size or b % step != 0]
        if bad:
            raise ValueError(
                f"bucket sizes must be in [1, batch_size={self.batch_size}]"
                f" and divisible by {step} (mesh data axis), got {bad}")
        return ladder

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "BatchingServer":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("server already started")
            self._accepting = True
            if self.pipeline_depth > 0 and self._resolve_q is None:
                self._resolve_q = queue.Queue(maxsize=self.pipeline_depth)
                self._resolve_thread = threading.Thread(
                    target=_resolve_loop, args=(self._resolve_q,),
                    name="bvt-serve-resolve", daemon=True,
                )
                self._resolve_thread.start()
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="bvt-serve-dispatch",
                daemon=True,
            )
            self._thread.start()
        return self

    def _shutdown_resolver(self, timeout: Optional[float]) -> bool:
        """Plant the resolver sentinel (after the dispatcher has exited,
        so FIFO guarantees every in-flight batch drains first) and join.
        No-op True when no resolver is running."""
        rq, rt = self._resolve_q, self._resolve_thread
        self._resolve_q = None
        self._resolve_thread = None
        if rt is None:
            return True
        rq.put(_STOP)
        rt.join(timeout=timeout)
        return not rt.is_alive()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> bool:
        """Stop accepting; drain=True serves queued requests first,
        drain=False fails them with RuntimeError. Returns True once the
        dispatcher has actually exited; False means the join timed out
        and in-flight work may still be executing (callers that mutate
        shared VLM state afterwards, e.g. a label swap, must treat False
        as "do not proceed", or pass timeout=None to block until exit)."""
        with self._lock:
            thread = self._thread
            if thread is None:
                return True
            self._accepting = False
            self._thread = None
        if not drain:
            failed = []
            try:
                while True:
                    item = self._queue.get_nowait()
                    if item is not _STOP:
                        failed.append(item)
            except queue.Empty:
                pass
            for req in failed:
                _fail(req.future,
                      RuntimeError("server stopped without draining"))
        self._queue.put(_STOP)
        thread.join(timeout=timeout)
        if not thread.is_alive():
            # submit() enqueues under the same lock as its _accepting
            # check, so no request can land behind the sentinel anymore;
            # this sweep is defense-in-depth (e.g. an external put).
            strays = []
            try:
                while True:
                    item = self._queue.get_nowait()
                    if item is not _STOP:
                        strays.append(item)
            except queue.Empty:
                pass
            for req in strays:
                _fail(req.future, RuntimeError(
                    "request raced a server stop and was never dispatched"))
            # in pipelined mode, True additionally means every in-flight
            # batch has been fetched and its futures resolved
            return self._shutdown_resolver(timeout)
        return False

    def __enter__(self) -> "BatchingServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)

    # -- request path -----------------------------------------------------

    def _coerce(self, image) -> np.ndarray:
        """Validate/convert ONE image to the ladder's [H, W, 3] row. Runs
        on the caller's thread (PIL decode + resize off the dispatcher's
        critical path)."""
        if not isinstance(image, np.ndarray) and not hasattr(image, "shape"):
            if self.vlm.transform is None:
                raise ValueError("PIL inputs need a transform; construct "
                                 "the VLM via from_pretrained")
            image = np.asarray(self.vlm.transform(image))
        image = np.asarray(image)
        if tuple(image.shape) != self._shape:
            raise ValueError(
                f"image shape {tuple(image.shape)} != compiled {self._shape}")
        if image.dtype != self._dtype:
            want_float = np.issubdtype(self._dtype, np.floating)
            have_float = np.issubdtype(image.dtype, np.floating)
            if not (want_float and have_float):
                # uint8<->float coercion would skip (or fake) the
                # in-graph normalize lane — same guard as _predict_fast
                raise ValueError(
                    f"image dtype {image.dtype} incompatible with the "
                    f"{self._dtype}-compiled program")
            image = image.astype(self._dtype)
        return image

    def submit(self, image) -> Future:
        """Enqueue one [H, W, 3] image (or PIL); resolves to [C] probs."""
        req = _Request(self._coerce(image))
        with self._lock:
            # The enqueue must share the lock with the _accepting check:
            # stop() flips _accepting under the same lock BEFORE planting
            # the sentinel, so any submit that passes the check is
            # guaranteed to land ahead of the sentinel and be served.
            if not self._accepting:
                raise RuntimeError("server not accepting (call start())")
            self._queue.put_nowait(req)  # queue.Full = backpressure signal
            self._stats.requests += 1
        return req.future

    def submit_many(self, images: Sequence) -> list:
        return [self.submit(im) for im in images]

    def predict(self, image, timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(image).result(timeout=timeout)

    # -- dispatcher -------------------------------------------------------

    def _collect(self) -> Optional[list]:
        """Block for the first request, then hold the batch open up to
        max_wait_s (or until full). None -> stop sentinel seen."""
        item = self._queue.get()
        if item is _STOP:
            return None
        batch = [item]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
            else:
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
            if item is _STOP:
                # serve what we have, then exit: re-plant the sentinel
                self._queue.put(_STOP)
                break
            batch.append(item)
        return batch

    def _dispatch_loop(self):
        while True:
            try:
                batch = self._collect()
                if batch is None:
                    return
                self._run(batch)
            except Exception:  # noqa: BLE001 — the dispatcher must NOT die:
                # a dead dispatcher with _accepting still True would hang
                # every future request forever. _run fails its own batch's
                # futures; anything escaping to here is a bug in the
                # resolution path itself — count it and keep serving.
                with self._lock:
                    self._stats.errors += 1

    def _copy_to_host(self, probs: torch.Tensor):
        """Enqueue the device-to-host copy of a batch's probabilities into
        the next pinned ring slot, on the current stream right after the
        batch's work, and record an event after it: (host view, event).
        Probabilities already on the host are handed over as they are."""
        if not isinstance(probs, torch.Tensor) or probs.device.type != "cuda":
            return probs, None
        i = self._ring_next % len(self._host_ring)
        self._ring_next += 1
        buf = self._host_ring[i]
        if buf is None or buf.shape[1:] != probs.shape[1:] or buf.dtype != probs.dtype:
            buf = torch.empty((self.batch_size, *probs.shape[1:]), dtype=probs.dtype,
                              pin_memory=True)
            self._host_ring[i] = buf
        host = buf[:probs.shape[0]]
        host.copy_(probs, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _run(self, batch: list):
        # Claim each future (RUNNING) so a caller-side cancel() can no
        # longer win the race and make set_result raise InvalidStateError;
        # already-cancelled requests are dropped before wasting a row.
        live = [r for r in batch if r.future.set_running_or_notify_cancel()]
        n = len(live)
        if not n:
            return
        # smallest ladder size that fits: a partial batch wastes
        # (bucket - n) rows, not (batch_size - n)
        bucket = next(b for b in self._buckets if b >= n)
        sink = self._resolve_q
        try:
            pixels = np.stack([r.image for r in live])
            if n < bucket:
                pad = np.broadcast_to(
                    pixels[-1:], (bucket - n, *self._shape))
                pixels = np.concatenate([pixels, pad])
            # public predict(): replays the ladder's graph on a signature
            # match, and still serves correctly through the general path
            # if a runtime change (e.g. a replaced weight) moved a tensor
            # the graph reads
            probs_dev = self.vlm.predict(pixels)
            if sink is None:
                probs = _to_numpy(probs_dev)
            else:
                host, event = self._copy_to_host(probs_dev)
        except Exception as exc:  # noqa: BLE001 — propagate to callers
            with self._lock:
                self._stats.errors += n
            for req in live:
                _fail(req.future, exc)
            return
        if sink is not None:
            # pipelined lane: the copy is enqueued; hand resolution to the
            # resolver and return to dispatch the next batch (the blocking
            # put bounds the batches in flight at pipeline_depth)
            sink.put((self, live, host, event, bucket, n))
            return
        self._finish(live, probs, bucket, n)

    def _finish(self, live: list, probs: np.ndarray, bucket: int, n: int):
        """Record stats and resolve futures for one served batch (called
        by the dispatcher inline, or by the resolver in pipelined mode)."""
        now = time.monotonic()
        with self._lock:
            s = self._stats
            s.batches += 1
            s.dispatched_rows += bucket
            s.padded_rows += bucket - n
            for req in live:
                self._lat_ring[self._lat_n % self._lat_ring.size] = (
                    now - req.t_enqueue) * 1000.0
                self._lat_n += 1
        for i, req in enumerate(live):
            try:
                req.future.set_result(probs[i])
            except InvalidStateError:  # defensive: claimed above
                pass

    # -- observability ----------------------------------------------------

    def signature(self) -> dict:
        """Public ladder-signature view (what /healthz reports)."""
        return {
            "batch_size": self.batch_size,
            "buckets": list(self._buckets),
            "image_shape": list(self._shape),
            "input_dtype": str(self._dtype),
            "max_wait_ms": self.max_wait_s * 1000.0,
            "pipeline_depth": self.pipeline_depth,
        }

    def stats(self) -> ServerStats:
        with self._lock:
            s = ServerStats(**vars(self._stats))
            s.queue_depth = self._queue.qsize()
            s.fill = ((s.dispatched_rows - s.padded_rows)
                      / s.dispatched_rows if s.dispatched_rows else 1.0)
            k = min(self._lat_n, self._lat_ring.size)
            if k:
                lat = np.sort(self._lat_ring[:k])
                s.latency_ms_p50 = float(lat[int(0.50 * (k - 1))])
                s.latency_ms_p95 = float(lat[int(0.95 * (k - 1))])
                s.latency_ms_max = float(lat[-1])
        return s
