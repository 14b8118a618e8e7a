"""LAION-400M webdataset module (ref:bayesvlm/data/laion400m.py), the
port's copy of `bayesvlm_tpu.data.laion400m`: the pretraining-data
source of Hessian estimation. jpg + txt caption pairs, image_id =
int(__key__), drop_last batches, no labels. The native decode lane is
not ported (`enable_native_decode` raises)."""

from __future__ import annotations

from pathlib import Path

from bayesvlm_tpu_torch.data.base import DataModule
from bayesvlm_tpu_torch.data.prefetch import ParallelPILLoader, PrefetchLoader
from bayesvlm_tpu_torch.data.wds import IterableLoader, WebDataset, decode_image


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

    def enable_native_decode(self, *args, **kwargs):
        raise NotImplementedError("the native decode lane is not ported yet")

    def train_dataloader(self):
        ds = self.dataset
        if self.num_workers and self.num_workers >= 2 and len(ds.tar_paths) >= 2:
            # the reference's DataLoader(num_workers=N) analogue: decode
            # threads over round-robin tar assignment (deterministic, and
            # another order than num_workers < 2, as there)
            def make_iter(tars):
                return iter(WebDataset(tars, shuffle_buffer=ds.shuffle_buffer,
                                       seed=ds.seed, map_fn=ds.map_fn))

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
