"""Input-pipeline overlap for the webdataset lane, the port's counterpart
of the PIL half of `bayesvlm_tpu.data.prefetch`.

- PrefetchLoader: a bounded-queue background thread running the wrapped
  iterable, so host decode overlaps device compute.
- ParallelPILLoader: tar-parallel decode, the analogue of the
  reference's `num_workers`, in threads (PIL releases the GIL while it
  decodes; a forked process would inherit the parent's CUDA context,
  which is unsafe). Its order is the JAX package's: worker w takes
  tar_paths[w::n] with n = min(num_workers, len(tar_paths)), batches its
  own stream (drop_last per worker), and batches are taken round-robin
  over the workers still running. The order is deterministic for given
  shards and num_workers and differs from the one-stream order, as in
  the reference's multi-worker loader.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence


class _Ctrl:
    """Control message on a prefetch queue (end of stream or an error): a
    class of its own, so that no batch can be taken for one."""

    __slots__ = ("kind", "payload")

    def __init__(self, kind: str, payload=None):
        self.kind = kind
        self.payload = payload


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Stop-aware put: False once the consumer has stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _drain(q: queue.Queue) -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def _batches(samples: Iterable, batch_size: int, drop_last: bool,
             collate_fn: Callable) -> Iterator:
    batch: List = []
    for sample in samples:
        batch.append(sample)
        if len(batch) == batch_size:
            yield collate_fn(batch)
            batch = []
    if batch and not drop_last:
        yield collate_fn(batch)


def _produce(items: Iterable, q: queue.Queue, stop: threading.Event) -> None:
    """Thread body: every item, then an end message (or the error)."""
    try:
        for item in items:
            if not _put(q, item, stop):
                return
        _put(q, _Ctrl("end"), stop)
    except BaseException as e:  # surfaced on the consumer side
        _put(q, _Ctrl("err", e), stop)


class PrefetchLoader:
    """Wrap an iterable of batches with a depth-bounded background
    prefetch thread. Exceptions in the source re-raise in the consumer.
    The thread is started per `__iter__` and joined when the iterator is
    exhausted or closed, so the wrapper is re-iterable and safe for
    partial consumption."""

    def __init__(self, loader: Iterable, depth: int = 2):
        self.loader = loader
        self.depth = max(1, int(depth))

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        # iter() here, in the consumer's thread: a loader may note where
        # its batches are read (NativeDecodeLoader: the consumer's stream)
        t = threading.Thread(target=_produce, args=(iter(self.loader), q, stop),
                             daemon=True, name="bvt-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _Ctrl):
                    if item.kind == "end":
                        break
                    raise item.payload
                yield item
        finally:
            stop.set()
            _drain(q)
            t.join(timeout=5.0)


class ParallelPILLoader:
    """Tar-parallel decode threads for webdataset-style tar streams.

    tar_paths: the shard list. make_iter: callable(tar_path_subset) ->
    iterator of preprocessed samples (tar read -> decode -> transform),
    run in the worker's thread. batch_size / drop_last / collate_fn: the
    batching contract of IterableLoader, drop_last per worker.
    num_workers: decode threads (>= 2), each a queue of 2 batches.
    """

    def __init__(self, tar_paths: Sequence[str], make_iter: Callable,
                 batch_size: int, num_workers: int,
                 drop_last: bool = True,
                 collate_fn: Optional[Callable] = None):
        from bayesvlm_tpu_torch.data.loader import default_collate

        if num_workers < 2:
            raise ValueError("ParallelPILLoader needs num_workers >= 2; "
                             "use IterableLoader for sequential decode")
        self.tar_paths = [str(p) for p in tar_paths]
        self.make_iter = make_iter
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate

    def _stream(self, tars):
        return _batches(self.make_iter(tars), self.batch_size, self.drop_last,
                        self.collate_fn)

    def __iter__(self) -> Iterator:
        n = min(self.num_workers, max(1, len(self.tar_paths)))
        if n < 2:  # one shard: one stream, in this thread
            yield from self._stream(self.tar_paths)
            return
        stop = threading.Event()
        queues = [queue.Queue(maxsize=2) for _ in range(n)]
        threads = [threading.Thread(
            target=_produce, args=(self._stream(self.tar_paths[w::n]), queues[w], stop),
            daemon=True, name=f"bvt-decode-{w}") for w in range(n)]
        for t in threads:
            t.start()
        live = list(range(n))
        try:
            while live:  # round-robin over the workers still running
                for w in list(live):
                    item = queues[w].get()
                    if isinstance(item, _Ctrl):
                        if item.kind == "end":
                            live.remove(w)
                            continue
                        raise RuntimeError(f"decode worker {w} failed") from item.payload
                    yield item
        finally:
            stop.set()
            for q in queues:
                _drain(q)
            for t in threads:
                t.join(timeout=5.0)
