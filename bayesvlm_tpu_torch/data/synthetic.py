"""Synthetic in-memory datamodule for tests and benchmarks (no disk/net),
the port's copy of `bayesvlm_tpu.data.synthetic`: the same images, ids
and class names for the same seed.

Generates deterministic random images per (seed, split); class names are
"class_<i>". The images are already normalised floats of `image_size`
(default 32): the module's transforms are not applied, so a full-width
run passes `image_size` through `DataModuleFactory.create(...,
image_size=...)`.
"""

from __future__ import annotations

import numpy as np

from bayesvlm_tpu_torch.data.base import DataModule


class _SyntheticDataset:
    def __init__(self, n, num_classes, image_size, seed, text_prompt, transform=None):
        self.n = n
        self.num_classes = num_classes
        self.image_size = image_size
        self.seed = seed
        self.text_prompt = text_prompt
        self.transform = transform

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        img = rng.normal(0.0, 1.0, (self.image_size, self.image_size, 3)).astype(
            np.float32
        )
        class_id = int(i % self.num_classes)
        return dict(
            image=img,
            text=self.text_prompt.format(class_name=f"class {class_id}"),
            class_id=class_id,
            image_id=i,
        )


class SyntheticDataModule(DataModule):
    def __init__(
        self,
        *args,
        num_train: int = 256,
        num_val: int = 64,
        num_test: int = 128,
        num_classes: int = 10,
        image_size: int = 32,
        seed: int = 0,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.num_train = num_train
        self.num_val = num_val
        self.num_test = num_test
        self.num_classes = num_classes
        self.image_size = image_size
        self.seed = seed

    def setup(self):
        self.class_names = [f"class_{i}" for i in range(self.num_classes)]
        self.train_dataset = _SyntheticDataset(
            self.num_train, self.num_classes, self.image_size, self.seed,
            self.text_prompt,
        )
        self.val_dataset = _SyntheticDataset(
            self.num_val, self.num_classes, self.image_size, self.seed + 1,
            self.text_prompt,
        )
        self.test_dataset = _SyntheticDataset(
            self.num_test, self.num_classes, self.image_size, self.seed + 2,
            self.text_prompt,
        )
