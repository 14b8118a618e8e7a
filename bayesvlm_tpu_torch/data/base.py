"""DataModule base class — the contract every dataset module implements
(ref:bayesvlm/data/*, SURVEY §2.5):

    ctor(data_dir, batch_size, num_workers, text_prompt, train_transform,
         test_transform, shuffle_train, subset_indices,
         [shots_per_class, use_few_shot, few_shot_sample_seed])
    setup()
    train_dataloader() / val_dataloader() / test_dataloader()
    class_prompts -> list[str]

This replaces LightningDataModule with a plain Python base (no Lightning
dependency in the compute path). The port's copy of
`bayesvlm_tpu.data.base`: `data_dir` is the module's dataset directory
(the factory joins `DATA_BASE_DIR` with the module's `DATASET_SUBDIR`).
PIL is imported where an image is opened, so the package imports on a
machine without it.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from bayesvlm_tpu_torch.data.loader import DataLoader


class ImageRecordDataset:
    """Lazy file-backed dataset: records of (path, class_id, image_id)."""

    def __init__(self, records, transform: Optional[Callable], text_prompt: str,
                 class_names: List[str]):
        self.records = list(records)
        self.transform = transform
        self.text_prompt = text_prompt
        self.class_names = class_names

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        from PIL import Image

        path, class_id, image_id = self.records[i]
        img = Image.open(path)
        if self.transform is not None:
            img = self.transform(img)
        name = self.class_names[class_id] if self.class_names else str(class_id)
        return dict(
            image=img,
            text=self.text_prompt.format(class_name=name),
            class_id=int(class_id),
            image_id=int(image_id),
        )


def train_test_split(items: Sequence, test_size: float, random_state: int):
    """(train, test) lists as `sklearn.model_selection.train_test_split(
    items, test_size=test_size, random_state=random_state)` gives them for
    a float `test_size` and an int seed, without sklearn: one permutation
    of `RandomState(random_state)`, its first ceil(test_size * n)
    positions the test part, the rest the train part (ShuffleSplit)."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    if n_test == 0 or n_test >= n:
        raise ValueError(f"test_size={test_size} of {n} samples leaves an empty part")
    perm = np.random.RandomState(random_state).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


class SubsetDataset:
    """The samples of `base` at `indices`, in that order."""

    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self.indices = [int(i) for i in indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[self.indices[int(i)]]


def few_shot_positions(labels: Sequence, shots_per_class: int, seed: int) -> List[int]:
    """Per-class few-shot draw over `labels` (one per sample), classes in
    order of first appearance. Keeps the reference's RNG quirk: the seed
    is reset before EVERY class draw (ref:bayesvlm/data/food101.py:43-57,
    eurosat.py:53-56), so two classes of the same size pick the same
    positions; a fresh `RandomState(seed)` per class draws what
    `np.random.seed(seed)` then `np.random.choice` draws."""
    by_class = {}
    for i, label in enumerate(labels):
        by_class.setdefault(label, []).append(i)
    out = []
    for positions in by_class.values():
        rng = np.random.RandomState(seed)
        out.extend(int(i) for i in rng.choice(positions, shots_per_class, replace=False))
    return out


class DataModule:
    DATASET_SUBDIR: str = ""

    def __init__(
        self,
        data_dir: str = "",
        batch_size: int = 32,
        num_workers: int = 4,
        text_prompt: str = "An image of a {class_name}",
        train_transform: Optional[Callable] = None,
        test_transform: Optional[Callable] = None,
        shuffle_train: bool = True,
        subset_indices: Optional[Sequence[int]] = None,
        shots_per_class: int = 10,
        use_few_shot: bool = False,
        few_shot_sample_seed: int = 42,
    ):
        self.data_dir = Path(data_dir) if data_dir else Path(".")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.text_prompt = text_prompt
        self.train_transform = train_transform
        self.test_transform = test_transform
        self.shuffle_train = shuffle_train
        self.subset_indices = subset_indices
        self.shots_per_class = shots_per_class
        self.use_few_shot = use_few_shot
        self.few_shot_sample_seed = few_shot_sample_seed

        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None
        self.class_names: List[str] = []

    # -- subclass API --------------------------------------------------
    def setup(self):
        raise NotImplementedError

    @property
    def class_prompts(self) -> List[str]:
        """ref pattern: [text_prompt.format(class_name=c) for c in classes]
        (e.g. ref:bayesvlm/data/cifar100.py:112-114)."""
        return [
            self.text_prompt.format(class_name=c.replace("_", " "))
            for c in self.class_names
        ]

    # -- loaders --------------------------------------------------------
    def _loader(self, dataset, shuffle: bool, drop_last: bool = False) -> DataLoader:
        return DataLoader(
            dataset,
            batch_size=self.batch_size,
            shuffle=shuffle,
            num_workers=self.num_workers,
            drop_last=drop_last,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader(self.train_dataset, shuffle=self.shuffle_train)

    def val_dataloader(self) -> DataLoader:
        return self._loader(self.val_dataset, shuffle=False)

    def test_dataloader(self) -> DataLoader:
        return self._loader(self.test_dataset, shuffle=False)

    # -- helpers ---------------------------------------------------------
    def _apply_subset(self, records):
        if self.subset_indices is None:
            return records
        return [records[int(i)] for i in self.subset_indices]

    def _apply_few_shot(self, records):
        """Per-class few-shot subsampling of (path, class_id, image_id)
        records (few_shot_positions)."""
        if not self.use_few_shot:
            return records
        return [records[i] for i in few_shot_positions(
            [r[1] for r in records], self.shots_per_class, self.few_shot_sample_seed)]

    def _subset_dataset(self, dataset):
        """`dataset` cut to `subset_indices`, when given."""
        if self.subset_indices is None:
            return dataset
        return SubsetDataset(dataset, self.subset_indices)
