"""Minimal webdataset: tar-shard streaming without the `webdataset`
package, the port's copy of `bayesvlm_tpu.data.wds`.

The subset the reference uses (ref:bayesvlm/data/laion400m.py): iterate
`.tar` shards, group members by key (basename before the first dot),
decode by extension, skip corrupt samples with a warning
(`warn_and_continue`, ref:laion400m.py:68,74), an optional seeded
shuffle buffer, map/preprocess, batched iteration with drop_last.
`shard_slice(host_id, num_hosts)` assigns tar files modulo host.

PIL is imported only where an image is decoded (`decode_image`), so the
module imports on a machine without it. The native lane
(data/native_io.py): `iterate_tar_samples_native` reads a shard through the
port's C++ tar index (`WebDataset(use_native=True)`, which the native lane
takes; the default is `tarfile`, whatever is built), and
`NativeDecodeLoader` decodes whole batches of JPEGs, on the card with
nvJPEG and the resize_crop kernel, or on the CPU with libjpeg.
"""

from __future__ import annotations

import io
import json
import tarfile
import warnings
import zlib
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from bayesvlm_tpu_torch.data.loader import default_collate


def _decode_member(name: str, data: bytes):
    ext = name.split(".", 1)[1] if "." in name else ""
    if ext == "json":
        return json.loads(data)
    if ext == "cls":
        return int(data)
    return data  # images are decoded lazily by the preprocess fn; txt as bytes


def iterate_tar_samples_native(tar_path) -> Iterator[Dict]:
    """`iterate_tar_samples` over the native index: one C++ pass builds the
    member index, then each member is read with one pread. Same output."""
    from bayesvlm_tpu_torch.data import native_io

    current_key = None
    sample: Dict = {}
    for name, offset, size in native_io.tar_index(tar_path):
        base = Path(name).name
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
            sample[ext] = _decode_member(base, native_io.read_member(tar_path, offset, size))
        except Exception as e:  # warn_and_continue
            warnings.warn(f"skipping corrupt member {name}: {e}")
    if sample and current_key is not None:
        sample["__key__"] = current_key
        yield sample


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
        use_native: bool = False,
    ):
        self.tar_paths = [str(p) for p in tar_paths]
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.map_fn = map_fn
        self.use_native = use_native

    def shard_slice(self, host_id: int, num_hosts: int) -> "WebDataset":
        """Deterministic per-host tar assignment (canonical sorted order)."""
        shards = sorted(self.tar_paths)[host_id::num_hosts]
        return WebDataset(shards, self.shuffle_buffer, self.seed, self.map_fn,
                          self.use_native)

    def _raw_iter(self) -> Iterator[Dict]:
        iter_fn = iterate_tar_samples_native if self.use_native else iterate_tar_samples
        for tar in self.tar_paths:
            try:
                yield from iter_fn(tar)
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


class NativeDecodeLoader:
    """Batches with the native decode lane (data/native_io.py).

    Takes RAW samples (a WebDataset with map_fn=None), groups `batch_size`
    of those with a jpg (or jpeg) member, and decodes, resizes and crops
    them in one call: fp32 normalised with `mean` / `std`, or uint8 crops
    (`out_uint8`) that the image encoder normalises on the device. On
    `device="cuda"` the crops are device tensors: each batch is decoded on a
    stream of the loader's own, and handed over only after an event that
    the consumer's stream (the current stream where the iteration starts)
    waits on; the batch is recorded on that stream, so that its memory is
    not reused while the consumer reads it. On "cpu": CPU tensors, libjpeg.

    EXPLICIT OPT-IN, as in the JAX package: the resampler is bilinear, not
    the reference's bicubic. Samples whose decode fails are dropped with a
    warning (warn_and_continue, ref:laion400m.py:68,74), so a batch may
    come up short.
    """

    def __init__(self, dataset, batch_size: int, image_size: int,
                 mean: Sequence[float], std: Sequence[float],
                 square_resize: bool = False, drop_last: bool = True,
                 num_threads: int = 8, out_uint8: bool = False, device="cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.square_resize = square_resize
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.out_uint8 = out_uint8
        self.device = device

    @staticmethod
    def _jpg_of(sample):
        # webdataset members may be named *.jpg or *.jpeg
        return sample.get("jpg", sample.get("jpeg"))

    @staticmethod
    def _image_id_of(key) -> int:
        """int(__key__) per the LAION contract; a key that is not an integer
        (e.g. 'n01440764_10026') takes its crc32 instead of ending the
        stream."""
        try:
            return int(key)
        except (TypeError, ValueError):
            return zlib.crc32(str(key).encode("utf-8"))

    def _emit(self, samples, device):
        from bayesvlm_tpu_torch.data import native_io

        jpegs = [self._jpg_of(s) for s in samples]
        if self.out_uint8:
            imgs, status = native_io.decode_batch_u8(
                jpegs, self.image_size, square_resize=self.square_resize,
                num_threads=self.num_threads, device=device)
        else:
            imgs, status = native_io.decode_batch(
                jpegs, self.image_size, self.mean, self.std,
                square_resize=self.square_resize, num_threads=self.num_threads,
                device=device)
        for s, st in zip(samples, status):
            if st != 0:
                warnings.warn(f"skipping sample {s.get('__key__')}: native decode "
                              f"failed (status {int(st)})")
        keep = np.flatnonzero(status == 0)
        if len(keep) == 0:
            return None
        if len(keep) < len(samples):
            imgs = imgs[torch.from_numpy(keep).to(imgs.device)]
        kept = [samples[i] for i in keep]
        out = {"image": imgs}
        if "txt" in kept[0]:
            out["text"] = [s["txt"].decode("utf-8") for s in kept]
        out["image_id"] = np.asarray([self._image_id_of(s["__key__"]) for s in kept])
        if "cls" in kept[0]:
            out["class_id"] = np.asarray([int(s["cls"]) for s in kept])
        return out

    def _groups(self) -> Iterator[List[Dict]]:
        batch: List[Dict] = []
        for sample in self.dataset:
            if self._jpg_of(sample) is None:
                warnings.warn(f"skipping sample {sample.get('__key__')}: no jpg/jpeg "
                              f"member")
                continue
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self) -> Iterator[Dict]:
        from bayesvlm_tpu_torch.data import native_io

        device = native_io.resolve_device(self.device)
        # read where the iteration starts (PrefetchLoader: the consumer's
        # thread): the stream that will read the batches
        consumer = torch.cuda.current_stream(device) if device.type == "cuda" else None
        return self._batches(device, consumer)

    def _batches(self, device, consumer) -> Iterator[Dict]:
        stream = torch.cuda.Stream(device) if consumer is not None else None
        for group in self._groups():
            if stream is None:
                out = self._emit(group, device)
            else:
                with torch.cuda.stream(stream):
                    out = self._emit(group, device)
                    ready = torch.cuda.Event()
                    ready.record(stream)
                consumer.wait_event(ready)
                if out is not None:
                    out["image"].record_stream(consumer)
            if out is not None:
                yield out


def decode_image(data: bytes):
    """A PIL image from encoded bytes (PIL imported here only)."""
    from PIL import Image

    return Image.open(io.BytesIO(data))
