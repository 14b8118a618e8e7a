"""Several probabilistic VLMs resident on one card behind one dispatcher,
the port of `bayesvlm_tpu.multiserve` (no reference counterpart: the
reference has batch scripts only, ref:scripts/zeroshot.py:25-128).

Design (as `serve.BatchingServer`, which says why one thread owns the
card):

- Each model is a **lane**: an unstarted `serve.BatchingServer` used as
  the model's execution engine: its CUDA-graph ladder (captured in its
  own graph pool when the lane is built), input coercion, padding to a
  ladder size (`_run`), its pinned host ring and its stats. Lanes never
  start a thread of their own; the multiplexer's dispatcher is the only
  thread that replays, so replays of different models interleave on one
  stream and no capture runs beside them.
- One FIFO carries (lane, request) pairs. The dispatcher takes the
  OLDEST pending request, holds that lane's batch open up to
  `max_wait_ms`, and defers other lanes' arrivals to an internal queue
  that is drained oldest-first before new work: FIFO-fair across models
  at batch granularity, no lane starves another.
- Batch sizes, bucket ladders and input dtypes are per lane
  (`batch_size`, `buckets` and `input_dtype` take dicts keyed by model
  name).

    ms = MultiModelServer(
        {"clip": vlm_clip, "siglip": vlm_siglip},
        batch_size={"clip": 64, "siglip": 32},
        buckets="pow2", max_wait_ms=2.0, input_dtype=torch.uint8,
    ).start()
    fut = ms.submit("clip", image)        # Future -> [C] probabilities
    probs = ms.predict("siglip", image)   # sync convenience
    ms.stats()["clip"].latency_ms_p50
    ms.hbm_footprint()                    # GiB per model + total
    ms.stop(drain=True)

While one lane's batch is held open (at most `max_wait_ms`), other
lanes' requests wait in the deferred queue: a request's added latency is
at most the open windows of the other lanes ahead of it.

A lane's ladder is replaced (a recapture after a prompt swap of another
class count) only while the multiplexer is stopped: `stop(drain=True)`
joins the dispatcher and the resolver first (serve_cli's
`MultiServingApp` builds a new multiplexer after each swap).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from bayesvlm_tpu_torch.serve import (
    _STOP as _RESOLVE_STOP,  # serve._resolve_loop's own sentinel object
    BatchingServer,
    ServerStats,
    _fail,
    _Request,
    _resolve_loop,
)

__all__ = ["MultiModelServer"]

_STOP = object()


def _per_lane(value, name, default=None):
    """A scalar-or-dict setting for one lane."""
    if isinstance(value, dict):
        return value.get(name, default)
    return value


def _ladder_bytes(vlm) -> int:
    """Bytes a lane keeps on its device for its ladder: the distinct
    storages of every tensor the ladder reads (weights, int8 cache, label
    features, head, the programs' static inputs), plus, on the card, the
    segments of the ladder's CUDA-graph pool (each program's activations
    and output), which `torch.cuda.memory_snapshot()` lists by pool."""
    programs = vlm._serving["programs"].values()
    tensors = vlm._ladder_tensors()  # every replica's on a serving mesh
    parts = [part for p in programs for part in getattr(p, "parts", ())]
    tensors += [part.static_in for part in parts]
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        storages[(t.device, st.data_ptr())] = st.nbytes()
    total = sum(storages.values())
    pools = {tuple(part.graph.pool()) for part in parts}
    if pools:
        total += sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg["segment_pool_id"]) in pools)
    return total


class MultiModelServer:
    """Serve several ProbabilisticVLMs from one card with one dispatcher.

    Parameters
    ----------
    models : dict name -> ProbabilisticVLM with class prompts set. Each
        lane captures (or reuses) its own ladder when it is built here.
    batch_size : int, or dict name -> int: the largest batch a dispatch
        of that lane takes.
    max_wait_ms : the hold-open window after a batch's first request
        (shared by all lanes; see the module docstring).
    input_dtype : torch dtype, or dict name -> dtype, of each ladder
        (None: torch.float32); torch.uint8 puts the /255 + normalize
        into the graphs.
    max_queue : backpressure bound across all lanes.
    buckets : None | "pow2" | list[int], or dict name -> one of those:
        per-lane partial-batch ladders (serve.BatchingServer).
    pipeline_depth : 0 resolves each batch inline; >0 starts ONE resolver
        thread for all lanes (serve._resolve_loop): the dispatcher hands
        a batch's device-to-host copy over and dispatches the next lane's
        batch at once. It bounds the batches in flight across all lanes.
        Each lane keeps its own pinned host ring of pipeline_depth + 2
        slots, so no lane reuses a slot before the resolver has copied
        it out.
    """

    def __init__(self, models: Dict[str, object], batch_size,
                 max_wait_ms: float = 5.0, input_dtype=None,
                 max_queue: int = 1024, buckets=None,
                 pipeline_depth: int = 0):
        if not models:
            raise ValueError("models must be a non-empty dict")
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        self._resolve_q = None
        self._resolve_thread: Optional[threading.Thread] = None
        self._lanes: Dict[str, BatchingServer] = {}
        for name, vlm in models.items():
            bs = _per_lane(batch_size, name)
            if bs is None:
                raise ValueError(f"no batch_size for model {name!r}")
            # never start()ed: the lane gives its ladder, coercion,
            # padding, host ring and stats; this object's dispatcher is the
            # only thread touching the card. Its pipeline_depth sizes its
            # host ring for the shared resolver.
            self._lanes[name] = BatchingServer(
                vlm, int(bs), max_wait_ms=max_wait_ms,
                input_dtype=_per_lane(input_dtype, name) or torch.float32,
                buckets=_per_lane(buckets, name),
                pipeline_depth=self.pipeline_depth,
            )
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._deferred: deque = deque()  # dispatcher-thread-only
        self._pending: Dict[str, int] = {n: 0 for n in self._lanes}
        self._thread: Optional[threading.Thread] = None
        self._accepting = False
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MultiModelServer":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("server already started")
            self._accepting = True
            if self.pipeline_depth > 0 and self._resolve_q is None:
                self._resolve_q = queue.Queue(maxsize=self.pipeline_depth)
                self._resolve_thread = threading.Thread(
                    target=_resolve_loop, args=(self._resolve_q,),
                    name="bvt-multiserve-resolve", daemon=True,
                )
                self._resolve_thread.start()
                # one resolver queue for the whole server keeps resolution
                # in dispatch order
                for lane in self._lanes.values():
                    lane._resolve_q = self._resolve_q
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="bvt-multiserve-dispatch",
                daemon=True,
            )
            self._thread.start()
        return self

    def _shutdown_resolver(self, timeout: Optional[float]) -> bool:
        rq, rt = self._resolve_q, self._resolve_thread
        self._resolve_q = None
        self._resolve_thread = None
        for lane in self._lanes.values():
            lane._resolve_q = None
        if rt is None:
            return True
        rq.put(_RESOLVE_STOP)
        rt.join(timeout=timeout)
        return not rt.is_alive()

    def _drain_queue(self) -> list:
        items = []
        try:
            while True:
                item = self._queue.get_nowait()
                if item is not _STOP:
                    items.append(item)
        except queue.Empty:
            pass
        return items

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> bool:
        """Stop accepting; drain=True serves queued requests first,
        drain=False fails those not yet dispatched. True once the
        dispatcher (and, pipelined, the resolver) has exited: only then
        may a lane's VLM change (a prompt swap, a recapture)."""
        with self._lock:
            thread = self._thread
            if thread is None:
                return True
            self._accepting = False
            self._thread = None
        if not drain:
            for name, req in self._drain_queue():
                self._dec_pending(name, 1)
                _fail(req.future, RuntimeError("server stopped without draining"))
        self._queue.put(_STOP)
        thread.join(timeout=timeout)
        if not thread.is_alive():
            # submit() shares the lock with the _accepting check, so
            # nothing lands behind the sentinel; this sweep is defence in
            # depth
            for name, req in self._drain_queue():
                self._dec_pending(name, 1)
                _fail(req.future, RuntimeError(
                    "request raced a server stop and was never dispatched"))
            # pipelined, True also means every batch in flight resolved
            return self._shutdown_resolver(timeout)
        return False

    def __enter__(self) -> "MultiModelServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)

    # -- request path -------------------------------------------------------

    def submit(self, model: str, image) -> Future:
        """Enqueue one image for `model`; resolves to [C] probabilities."""
        lane = self._lanes.get(model)
        if lane is None:
            raise KeyError(
                f"unknown model {model!r}; resident: {sorted(self._lanes)}")
        req = _Request(lane._coerce(image))  # on the caller's thread
        with self._lock:
            if not self._accepting:
                raise RuntimeError("server not accepting (call start())")
            self._queue.put_nowait((model, req))  # queue.Full = backpressure
            self._pending[model] += 1
        with lane._lock:
            lane._stats.requests += 1
        return req.future

    def predict(self, model: str, image,
                timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(model, image).result(timeout=timeout)

    # -- dispatcher ---------------------------------------------------------

    def _dec_pending(self, name: str, n: int) -> None:
        with self._lock:
            self._pending[name] -= n

    def _dispatch_loop(self):
        stop_seen = False
        while True:
            name = None
            try:
                # oldest pending request first: the deferred queue holds
                # requests pulled during earlier lanes' windows, so its
                # head predates anything still queued
                if self._deferred:
                    name, req = self._deferred.popleft()
                else:
                    if stop_seen:
                        return
                    item = self._queue.get()
                    if item is _STOP:
                        return
                    name, req = item
                lane = self._lanes[name]
                batch = [req]
                # this lane's deferred requests are older than anything in
                # the queue: take them first, keep the rest in order
                rest: deque = deque()
                while self._deferred and len(batch) < lane.batch_size:
                    nm, rq = self._deferred.popleft()
                    if nm == name:
                        batch.append(rq)
                    else:
                        rest.append((nm, rq))
                rest.extend(self._deferred)
                self._deferred = rest
                deadline = time.monotonic() + self.max_wait_s
                while len(batch) < lane.batch_size and not stop_seen:
                    remaining = deadline - time.monotonic()
                    try:
                        item = (self._queue.get(timeout=remaining)
                                if remaining > 0 else self._queue.get_nowait())
                    except queue.Empty:
                        break
                    if item is _STOP:
                        stop_seen = True  # serve this batch and the deferred, then exit
                        break
                    nm, rq = item
                    if nm == name:
                        batch.append(rq)
                    else:
                        self._deferred.append(item)
                self._dec_pending(name, len(batch))
                lane._run(batch)
            except Exception:  # noqa: BLE001 — the dispatcher must NOT die:
                # _run fails its own batch's futures; what escapes here is a
                # fault of the resolution path: count it, keep serving
                if name in self._lanes:
                    with self._lanes[name]._lock:
                        self._lanes[name]._stats.errors += 1

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict[str, ServerStats]:
        """Per-model counters; queue_depth is this server's pending count
        for the lane (the lanes' own queues are unused)."""
        with self._lock:
            pending = dict(self._pending)
        out = {}
        for name, lane in self._lanes.items():
            s = lane.stats()
            s.queue_depth = pending[name]
            out[name] = s
        return out

    def signature(self) -> Dict[str, dict]:
        return {name: lane.signature() for name, lane in self._lanes.items()}

    def hbm_footprint(self) -> Dict[str, float]:
        """GiB each model keeps on its device for serving, and 'total' (the
        sum): the bytes of the distinct storages its ladder reads (weights,
        int8 cache, labels, head, static inputs) plus, on the card, the
        segments of its CUDA-graph pool as `torch.cuda.memory_snapshot()`
        lists them (the captured programs' activations and outputs; a pool
        keeps its segments between replays). The JAX package reports XLA's
        peak of (arguments + outputs + temporaries) instead. Not counted:
        the text tower, the pinned host buffers, and cuBLAS / allocator
        workspaces outside the pool. A storage two models share is
        counted in each."""
        out = {name: round(_ladder_bytes(lane.vlm) / 2**30, 4)
               for name, lane in self._lanes.items()}
        out["total"] = round(sum(out.values()), 4)
        return out
