"""Minimal webdataset: tar-shard streaming without the `webdataset`
package, the port's copy of `bayesvlm_tpu.data.wds`.

The subset the reference uses (ref:bayesvlm/data/laion400m.py): iterate
`.tar` shards, group members by key (basename before the first dot),
decode by extension, skip corrupt samples with a warning
(`warn_and_continue`, ref:laion400m.py:68,74), an optional seeded
shuffle buffer, map/preprocess, batched iteration with drop_last.
`shard_slice(host_id, num_hosts)` assigns tar files modulo host.

PIL is imported only where an image is decoded (`decode_image`), so the
module imports on a machine without it. The native C++ lane of the JAX
package (`iterate_tar_samples_native`, `NativeDecodeLoader`) is not
ported: shards are always read with `tarfile`.
"""

from __future__ import annotations

import io
import json
import tarfile
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from bayesvlm_tpu_torch.data.loader import default_collate


def _decode_member(name: str, data: bytes):
    ext = name.split(".", 1)[1] if "." in name else ""
    if ext == "json":
        return json.loads(data)
    if ext == "cls":
        return int(data)
    return data  # images are decoded lazily by the preprocess fn; txt as bytes


def iterate_tar_samples(tar_path) -> Iterator[Dict]:
    """Yield {__key__, ext: bytes/obj} groups from one tar shard."""
    with tarfile.open(tar_path, "r") as tf:
        current_key = None
        sample: Dict = {}
        for member in tf:
            if not member.isfile():
                continue
            base = Path(member.name).name
            if "." not in base:
                continue
            key, ext = base.split(".", 1)
            if current_key is not None and key != current_key:
                if sample:
                    sample["__key__"] = current_key
                    yield sample
                sample = {}
            current_key = key
            try:
                data = tf.extractfile(member).read()
                sample[ext] = _decode_member(base, data)
            except Exception as e:  # warn_and_continue
                warnings.warn(f"skipping corrupt member {member.name}: {e}")
        if sample and current_key is not None:
            sample["__key__"] = current_key
            yield sample


class WebDataset:
    """Iterable dataset over tar shards with map/shuffle, warn-and-continue."""

    def __init__(
        self,
        tar_paths: Sequence,
        shuffle_buffer: int = 0,
        seed: int = 0,
        map_fn: Optional[Callable] = None,
    ):
        self.tar_paths = [str(p) for p in tar_paths]
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.map_fn = map_fn

    def shard_slice(self, host_id: int, num_hosts: int) -> "WebDataset":
        """Deterministic per-host tar assignment (canonical sorted order)."""
        shards = sorted(self.tar_paths)[host_id::num_hosts]
        return WebDataset(shards, self.shuffle_buffer, self.seed, self.map_fn)

    def _raw_iter(self) -> Iterator[Dict]:
        for tar in self.tar_paths:
            try:
                yield from iterate_tar_samples(tar)
            except Exception as e:  # corrupt shard: skip entirely
                warnings.warn(f"skipping corrupt shard {tar}: {e}")

    def __iter__(self) -> Iterator[Dict]:
        it = self._raw_iter()
        if self.shuffle_buffer > 1:
            it = _buffered_shuffle(it, self.shuffle_buffer, self.seed)
        for sample in it:
            if self.map_fn is not None:
                try:
                    yield self.map_fn(sample)
                except Exception as e:  # warn_and_continue on decode errors
                    warnings.warn(f"skipping sample {sample.get('__key__')}: {e}")
            else:
                yield sample


def _buffered_shuffle(it, bufsize: int, seed: int):
    """The JAX package's shuffle buffer, draw for draw (numpy
    default_rng(seed))."""
    rng = np.random.default_rng(seed)
    buf: List = []
    for x in it:
        buf.append(x)
        if len(buf) >= bufsize:
            i = int(rng.integers(len(buf)))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


class IterableLoader:
    """Batched iteration over an iterable dataset (drop_last semantics of
    ref:laion400m.py:79-92)."""

    def __init__(self, dataset, batch_size: int, drop_last: bool = True,
                 collate_fn: Callable = default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate_fn = collate_fn

    def __iter__(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)


def decode_image(data: bytes):
    """A PIL image from encoded bytes (PIL imported here only)."""
    from PIL import Image

    return Image.open(io.BytesIO(data))
