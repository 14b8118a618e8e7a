"""Batched data loading: a prefetching thread-pool loader feeding NumPy
batches, the port's copy of `bayesvlm_tpu.data.loader` (same batch
order, seeded shuffling and collation).

The reference relies on torch DataLoader worker *processes*
(ref:bayesvlm/data/*, `num_workers`); here decode+transform run in a
thread pool (PIL releases the GIL during decode) with a bounded prefetch
queue, and batches are contiguous NumPy arrays that the encoders copy to
the card. Deterministic order; seeded shuffling.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """ref:bayesvlm/data/common.py:13-32 — {image, text, image_id?, class_id?}."""
    out: Dict[str, Any] = {}
    images = [s["image"] for s in samples]
    if isinstance(images[0], np.ndarray):
        out["image"] = np.stack(images, axis=0)
    else:
        out["image"] = images
    out["text"] = [s["text"] for s in samples]
    if "image_id" in samples[0]:
        out["image_id"] = np.asarray([s["image_id"] for s in samples])
    if "class_id" in samples[0]:
        out["class_id"] = np.asarray([s["class_id"] for s in samples])
    for k in samples[0]:
        if k not in ("image", "text", "image_id", "class_id"):
            out[k] = [s[k] for s in samples]
    return out


class DataLoader:
    """Map-style dataset loader.

    dataset: object with __len__ and __getitem__(i) -> sample dict.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = False,
        collate_fn: Callable = default_collate,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [
            order[i : i + self.batch_size]
            for i in range(0, limit, self.batch_size)
            if not self.drop_last or i + self.batch_size <= limit
        ]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batches()
        if not batches:
            return iter(())

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        from concurrent.futures import ThreadPoolExecutor

        def put(item) -> bool:
            """Stop-aware put: a consumer that stopped mid-iteration (an
            early `break`) must not leave the producer parked forever in
            a blocking q.put (same pattern as prefetch.PrefetchLoader)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for idx in batches:
                        if stop.is_set():
                            return
                        samples = list(ex.map(self.dataset.__getitem__, idx.tolist()))
                        if not put(self.collate_fn(samples)):
                            return
            except Exception as e:  # surfaced on the consumer side
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, daemon=True,
                             name="bvt-loader-producer")
        t.start()

        def gen():
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
                try:  # drain so a parked producer can observe stop
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=5.0)

        return gen()


class ListDataset:
    """Wrap parallel lists of samples into a map-style dataset."""

    def __init__(self, samples: Sequence[Dict[str, Any]], transform: Optional[Callable] = None):
        self.samples = list(samples)
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        s = dict(self.samples[i])
        if self.transform is not None and "image" in s:
            s["image"] = self.transform(s["image"])
        return s
