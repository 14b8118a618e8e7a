"""Feature precompute + disk cache (ref:bayesvlm/precompute.py), the
port's counterpart of `bayesvlm_tpu.inference.precompute`:

    embeddings_img.pt activations_img.pt residuals_img.pt class_ids_img.pt
    image_ids.pt embeddings_txt.pt activations_txt.pt
    activations_{tag}.pt embeddings_{tag}.pt          (Hessian estimation)

Plain tensors in torch's zip format (`torch.save` / `torch.load`), the
files the reference and the JAX package write and read. A cache hit
short-circuits as in the reference, so an interrupted run resumes for
free. `checkpoint_every=k` (with `save_predictions`, or with
`compute_features`' `cache_dir`) also writes the accumulated features
as atomic part files every k batches (`<cache_dir>/_parts_<tag>/
part_*.npz`, tmp + rename, the JAX package's layout and keys): a
restarted pass resumes after the last completed part, never re-encodes
a sample (the loader is fast-forwarded by exact sample count, mid-batch
too), and writes the same final files as an uninterrupted run. Parts are deleted once the final files land. Needs a
deterministic loader order.

Eager torch needs no fixed batch shape: the last, short batch is encoded
as it is. Features stay on the encoder's device until a part or a cache
file is written.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from bayesvlm_tpu_torch.types import EncoderResult

PathLike = Union[str, Path]


def _load(path: Path, device) -> torch.Tensor:
    return torch.load(path, map_location=device, weights_only=True)


def _save(t: torch.Tensor, path: Path) -> None:
    torch.save(t.detach().cpu().contiguous(), path)


class _PartedAccumulator:
    """Crash-durable accumulation of named per-batch tensor streams.

    With a `parts_dir`, every `flush` writes the rows accumulated since
    the last flush as one atomic `part_{k:05d}.npz` (tmp + `os.replace`);
    a new instance pointed at the same directory resumes with those rows
    preloaded and reports how many samples are already done
    (`resumed_rows`). No cursor file: the part files are the cursor (a
    torn write cannot exist past the rename)."""

    def __init__(self, keys, parts_dir: Optional[Path]):
        self.keys = list(keys)
        self.parts_dir = Path(parts_dir) if parts_dir is not None else None
        self.parts: Dict[str, List[torch.Tensor]] = {k: [] for k in self.keys}
        self._flushed = 0  # entries of each parts list already on disk
        self.resumed_rows = 0
        if self.parts_dir is not None and self.parts_dir.exists():
            files = sorted(self.parts_dir.glob("part_*.npz"))
            for p in files:
                with np.load(p) as z:
                    for k in self.keys:
                        self.parts[k].append(torch.from_numpy(z[k]))
            self._flushed = len(files)
            self.resumed_rows = sum(len(a) for a in self.parts[self.keys[0]])

    def push(self, key: str, value: torch.Tensor) -> None:
        self.parts[key].append(value)

    def flush(self) -> None:
        """Write everything accumulated since the last flush as one part."""
        if self.parts_dir is None or len(self.parts[self.keys[0]]) == self._flushed:
            return
        arrays = {k: torch.cat(self.parts[k][self._flushed:]).cpu().numpy()
                  for k in self.keys}
        self.parts_dir.mkdir(parents=True, exist_ok=True)
        tmp = self.parts_dir / f".part_{self._flushed:05d}.tmp.npz"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, self.parts_dir / f"part_{self._flushed:05d}.npz")
        # one part file per flush: the entries written become one entry
        for k in self.keys:
            self.parts[k][self._flushed:] = [torch.from_numpy(arrays[k])]
        self._flushed += 1

    def concat(self, key: str, device) -> torch.Tensor:
        return torch.cat([p.to(device) for p in self.parts[key]])

    def cleanup(self) -> None:
        """Remove the parts directory once the final files are durable."""
        if self.parts_dir is not None and self.parts_dir.exists():
            shutil.rmtree(self.parts_dir)


def _pixels(batch):
    """A batch's "image": a tensor as it is (the native lane's crops may
    already be on the card), anything else as a numpy array."""
    images = batch["image"]
    return images if isinstance(images, torch.Tensor) else np.asarray(images)


def _skip_done(batch, consumed: int, skip: int):
    """Fast-forward helper: (the rows of `batch` not yet encoded, or None
    if the whole batch is done; the new cursor)."""
    n = len(batch)
    if consumed >= skip:
        return batch, consumed
    take = min(n, skip - consumed)
    consumed += take
    if take == n:
        return None, consumed
    return batch[take:], consumed


def encode_images_batched(image_encoder, images, batch_size: int) -> EncoderResult:
    """Encode [N, H, W, 3] pixels in batches of at most `batch_size`."""
    return EncoderResult.concatenate([
        image_encoder(images[start:start + batch_size])
        for start in range(0, len(images), batch_size)
    ])


def image_cache_paths(cache_dir: PathLike) -> dict:
    """The image feature cache's files under `cache_dir`, by field."""
    cache_dir = Path(cache_dir)
    return {"embeds": cache_dir / "embeddings_img.pt",
            "activations": cache_dir / "activations_img.pt",
            "residuals": cache_dir / "residuals_img.pt",
            "class_ids": cache_dir / "class_ids_img.pt",
            "image_ids": cache_dir / "image_ids.pt"}


def save_image_features(cache_dir: PathLike, result: EncoderResult,
                        class_ids: torch.Tensor, image_ids: torch.Tensor) -> None:
    """Write features in the files `precompute_image_features` reads."""
    Path(cache_dir).mkdir(parents=True, exist_ok=True)
    t = {"embeds": result.embeds, "activations": result.activations,
         "residuals": result.residuals, "class_ids": class_ids, "image_ids": image_ids}
    for k, p in image_cache_paths(cache_dir).items():
        _save(t[k], p)


def precompute_image_features(
    image_encoder,
    loader: Iterable,
    save_predictions: bool = False,
    cache_dir: Optional[PathLike] = None,
    checkpoint_every: Optional[int] = None,
):
    """ref:bayesvlm/precompute.py:68-124. Returns (EncoderResult,
    class_ids, image_ids), on the encoder's device.

    `checkpoint_every=k` (with `save_predictions`) writes the features as
    atomic part files every k batches, so that a preempted pass resumes
    without re-encoding (module docstring)."""
    if save_predictions and cache_dir is None:
        raise ValueError("cache_dir must be provided if save_predictions is True")
    device = image_encoder.device

    if cache_dir is not None:
        cache_dir = Path(cache_dir)
        paths = image_cache_paths(cache_dir)
        if all(p.exists() for p in paths.values()):
            t = {k: _load(p, device) for k, p in paths.items()}
            return (EncoderResult(t["embeds"], t["activations"], t["residuals"]),
                    t["class_ids"], t["image_ids"])
        if save_predictions:
            cache_dir.mkdir(parents=True, exist_ok=True)

    keys = ("embeds", "activations", "residuals", "class_ids", "image_ids")
    parts_dir = (cache_dir / "_parts_img"
                 if checkpoint_every and save_predictions and cache_dir is not None
                 else None)
    acc = _PartedAccumulator(keys, parts_dir)
    skip, consumed = acc.resumed_rows, 0
    batches_since_flush = 0
    for batch in loader:
        images = _pixels(batch)
        labels = np.asarray(batch["class_id"]).reshape(-1)
        img_ids = np.asarray(batch["image_id"]).reshape(-1)
        images, _ = _skip_done(images, consumed, skip)
        labels, _ = _skip_done(labels, consumed, skip)
        img_ids, consumed = _skip_done(img_ids, consumed, skip)
        if images is None:
            continue
        r = image_encoder(images)
        consumed += len(images)
        acc.push("embeds", r.embeds)
        acc.push("activations", r.activations)
        acc.push("residuals", r.residuals)
        acc.push("class_ids", torch.from_numpy(np.ascontiguousarray(labels)))
        acc.push("image_ids", torch.from_numpy(np.ascontiguousarray(img_ids)))
        batches_since_flush += 1
        if parts_dir is not None and batches_since_flush >= checkpoint_every:
            acc.flush()
            batches_since_flush = 0

    t = {k: acc.concat(k, device) for k in keys}
    result = EncoderResult(t["embeds"], t["activations"], t["residuals"])
    if save_predictions and cache_dir is not None:
        save_image_features(cache_dir, result, t["class_ids"], t["image_ids"])
        acc.cleanup()
    return result, t["class_ids"], t["image_ids"]


def precompute_text_features(
    text_encoder,
    class_prompts: List[str],
    batch_size: int,
    save_predictions: bool = False,
    cache_dir: Optional[PathLike] = None,
) -> EncoderResult:
    """ref:bayesvlm/precompute.py:127-168."""
    if cache_dir is None and save_predictions:
        raise ValueError("cache_dir must be provided if save_predictions is True")
    device = text_encoder.device

    if cache_dir is not None:
        cache_dir = Path(cache_dir)
        embeds_path = cache_dir / "embeddings_txt.pt"
        activations_path = cache_dir / "activations_txt.pt"
        if embeds_path.exists() and activations_path.exists():
            return EncoderResult.create(embeds=_load(embeds_path, device),
                                        activations=_load(activations_path, device))

    parts = [text_encoder.encode_texts(class_prompts[start:start + batch_size])
             for start in range(0, len(class_prompts), batch_size)]
    embeds = torch.cat([r.embeds for r in parts])
    activations = torch.cat([r.activations for r in parts])

    if save_predictions and cache_dir is not None:
        cache_dir.mkdir(parents=True, exist_ok=True)
        _save(embeds, embeds_path)
        _save(activations, activations_path)
    return EncoderResult.create(embeds=embeds, activations=activations)


def compute_features(
    encoder,
    loader: Iterable,
    tag: str = None,
    cache_dir: Optional[PathLike] = None,
    return_tensors: bool = False,
    modality: str = "image",
    checkpoint_every: Optional[int] = None,
):
    """Streaming feature dump for Hessian estimation
    (ref:bayesvlm/precompute.py:173-205): the image tower over each
    batch's "image" (`modality="image"`) or the text tower over its
    "text". With a `cache_dir`, writes `activations_{tag}.pt` and
    `embeddings_{tag}.pt` there and returns their paths (the tensors with
    `return_tensors`); a cache hit returns without encoding. Without one,
    returns (activations, embeddings) on the encoder's device.

    `checkpoint_every=k` (with a `cache_dir`) writes part files every k
    batches, and a restarted call resumes after the last one without
    re-encoding a sample (module docstring)."""
    if cache_dir is not None:
        cache_dir = Path(cache_dir)
        cache_dir.mkdir(parents=True, exist_ok=True)
        path_activations = cache_dir / f"activations_{tag}.pt"
        path_embeddings = cache_dir / f"embeddings_{tag}.pt"
        if path_activations.exists() and path_embeddings.exists():
            if return_tensors:
                return (_load(path_activations, encoder.device),
                        _load(path_embeddings, encoder.device))
            return str(path_activations), str(path_embeddings)

    parts_dir = (cache_dir / f"_parts_{tag}"
                 if checkpoint_every and cache_dir is not None else None)
    acc = _PartedAccumulator(("activations", "embeddings"), parts_dir)
    skip, consumed = acc.resumed_rows, 0
    batches_since_flush = 0
    for batch in loader:
        if modality == "image":
            images, consumed = _skip_done(_pixels(batch), consumed, skip)
            if images is None:
                continue
            n = len(images)
            r = encoder(images)
        else:
            texts, consumed = _skip_done(batch["text"], consumed, skip)
            if texts is None:
                continue
            n = len(texts)
            r = encoder.encode_texts(texts)
        consumed += n
        acc.push("activations", r.activations)
        acc.push("embeddings", r.embeds)
        batches_since_flush += 1
        if parts_dir is not None and batches_since_flush >= checkpoint_every:
            acc.flush()
            batches_since_flush = 0

    activations = acc.concat("activations", encoder.device)
    embeddings = acc.concat("embeddings", encoder.device)
    if cache_dir is None:
        return activations, embeddings
    _save(activations, path_activations)
    _save(embeddings, path_embeddings)
    acc.cleanup()
    if return_tensors:
        return activations, embeddings
    return str(path_activations), str(path_embeddings)
