"""LAION-400M webdataset module (ref:bayesvlm/data/laion400m.py), the
port's copy of `bayesvlm_tpu.data.laion400m`: the pretraining-data
source of Hessian estimation. jpg + txt caption pairs, image_id =
int(__key__), drop_last batches, no labels. `enable_native_decode` opts
into the native lane (data/native_io.py: whole batches decoded on the card
with nvJPEG, or on the CPU with libjpeg; bilinear)."""

from __future__ import annotations

from pathlib import Path

from bayesvlm_tpu_torch.data.base import DataModule
from bayesvlm_tpu_torch.data.prefetch import ParallelPILLoader, PrefetchLoader
from bayesvlm_tpu_torch.data.wds import (
    IterableLoader,
    NativeDecodeLoader,
    WebDataset,
    decode_image,
)


class Laion400mDataModule(DataModule):
    DATASET_SUBDIR = "laion400m"

    def __init__(self, *args, **kwargs):
        if kwargs.pop("use_few_shot", False):
            raise ValueError("Few shot not supported for this dataset")
        kwargs.pop("shots_per_class", None)
        kwargs.pop("few_shot_sample_seed", None)
        if kwargs.pop("subset_indices", None) is not None:
            raise ValueError("Subset indices are not supported for this dataset")
        super().__init__(*args, **kwargs)
        self.data_path = [str(t) for t in sorted(Path(self.data_dir).glob("*.tar"))]

    def _preprocess(self, item):
        image = decode_image(item["jpg"])
        return dict(
            image=self.train_transform(image) if self.train_transform else image,
            text=item["txt"].decode("utf-8"),
            image_id=int(item["__key__"]),
        )

    def setup(self):
        self.dataset = WebDataset(
            self.data_path,
            shuffle_buffer=1000 if self.shuffle_train else 0,
            map_fn=self._preprocess,
        )
        self.class_names = []

    def shard_for_host(self, host_id: int, num_hosts: int):
        """Per-host tar assignment for multi-host runs."""
        self.dataset = self.dataset.shard_slice(host_id, num_hosts)

    def enable_native_decode(self, image_size: int, family: str = "clip",
                             num_threads: int = 8, out_uint8: bool = False,
                             device="cuda"):
        """Opt into the native batched JPEG decode lane on `device`.

        Bilinear resampling (PIL bicubic stays the default pipeline). SigLIP
        takes IMAGENET_STANDARD mean/std and a square resize, CLIP the
        DEFAULT ones and a shorter-side resize with a centre crop.
        `out_uint8` ships raw uint8 crops, which the image encoder
        normalises on the device. Builds the tar reader and the decoder of
        `device` now, and raises with the reason where one cannot be built
        (the CPU decoder needs `jpeglib.h`) or there is no card."""
        from bayesvlm_tpu_torch.data import native_io
        from bayesvlm_tpu_torch.data.transforms import (
            DEFAULT_MEAN,
            DEFAULT_STD,
            IMAGENET_STANDARD_MEAN,
            IMAGENET_STANDARD_STD,
        )

        native_io.prepare(device)
        if family == "siglip":
            params = dict(mean=IMAGENET_STANDARD_MEAN, std=IMAGENET_STANDARD_STD,
                          square_resize=True)
        else:
            params = dict(mean=DEFAULT_MEAN, std=DEFAULT_STD, square_resize=False)
        self._native_decode = dict(image_size=image_size, num_threads=num_threads,
                                   out_uint8=out_uint8, device=device, **params)

    def train_dataloader(self):
        ds = self.dataset
        native = getattr(self, "_native_decode", None)
        if native is not None:
            # the lane reads through the port's tar reader, which
            # enable_native_decode has built
            raw = WebDataset(ds.tar_paths, shuffle_buffer=ds.shuffle_buffer, seed=ds.seed,
                             map_fn=None, use_native=True)
            # a background thread overlaps the batch decode with the tower
            return PrefetchLoader(NativeDecodeLoader(raw, self.batch_size, drop_last=True,
                                                     **native), depth=2)
        if self.num_workers and self.num_workers >= 2 and len(ds.tar_paths) >= 2:
            # the reference's DataLoader(num_workers=N) analogue: decode
            # threads over round-robin tar assignment (deterministic, and
            # another order than num_workers < 2, as there)
            def make_iter(tars):
                return iter(WebDataset(tars, shuffle_buffer=ds.shuffle_buffer,
                                       seed=ds.seed, map_fn=ds.map_fn,
                                       use_native=ds.use_native))

            return ParallelPILLoader(ds.tar_paths, make_iter, self.batch_size,
                                     num_workers=self.num_workers, drop_last=True)
        return PrefetchLoader(IterableLoader(ds, self.batch_size, drop_last=True),
                              depth=2)

    def val_dataloader(self):
        return self.train_dataloader()

    def test_dataloader(self):
        return self.train_dataloader()

    @property
    def class_prompts(self):
        return []
