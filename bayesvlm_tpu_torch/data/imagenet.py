"""ImageNet-family datamodules (ref:bayesvlm/data/{imagenet_wds,
imagenet_1k,imagenet_r,imagenet_sketch,imagenet_da}.py), the port's copy
of `bayesvlm_tpu.data.imagenet`.

- ImagenetWDSModule: validation tar shards (webdataset, data/wds.py);
  labels from the `cls` member, names from `imagenet_classes.json` in the
  data directory or its parent (the reference pulls them from the HF
  dataset builder, ref:imagenet_wds.py:14-19, tried here last), else
  `class_<i>`.
- Imagenet50/100: parquet shards (pandas) filtered to a seeded class
  subset (ref:imagenet_1k.py:16-44).
- ImagenetR / Imagenet-DA variants: folder trees with a wnid -> words
  `classes.csv` (ref:imagenet_da.py:15-26); ImagenetSketch: HF
  `songweig/imagenet_sketch`. Their 64/16/20 splits are sklearn's
  train_test_split twice, reproduced without sklearn
  (data/base.train_test_split).

PIL, pandas and `datasets` are imported where they are used.
"""

from __future__ import annotations

import csv
import io
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from bayesvlm_tpu_torch.data.base import DataModule, ImageRecordDataset, train_test_split
from bayesvlm_tpu_torch.data.wds import IterableLoader, WebDataset, decode_image


def _load_label_names(data_dir: Path) -> Optional[List[str]]:
    """The 1000 ImageNet class names (a JSON list ordered by class index)
    from the data directory or its parent; else the HF builder's, where
    its metadata is cached locally; else None."""
    for candidate in (data_dir / "imagenet_classes.json",
                      data_dir.parent / "imagenet_classes.json"):
        if candidate.exists():
            with open(candidate) as f:
                return json.load(f)
    try:  # works when the HF builder metadata is cached locally
        from datasets import load_dataset_builder

        b = load_dataset_builder("ILSVRC/imagenet-1k")
        return list(b.info.features["label"].names)
    except Exception:  # no `datasets`, no cache, no network: no names
        return None


def _two_splits(items):
    """(train, val, test): sklearn's train_test_split(test_size=0.2,
    random_state=0) of `items`, then of its train part."""
    trainval, test = train_test_split(items, test_size=0.2, random_state=0)
    train, val = train_test_split(trainval, test_size=0.2, random_state=0)
    return train, val, test


class ImagenetWDSModule(DataModule):
    DATASET_SUBDIR = "imagenet_val_wds"

    def __init__(self, *args, **kwargs):
        if kwargs.pop("use_few_shot", False):
            raise ValueError("Few shot not supported for this dataset")
        kwargs.pop("shots_per_class", None)
        kwargs.pop("few_shot_sample_seed", None)
        super().__init__(*args, **kwargs)
        if self.subset_indices is not None:
            raise ValueError("Subset indices are not supported for this dataset")
        self.data_path = sorted(str(p) for p in Path(self.data_dir).glob("*.tar"))

    def setup(self):
        names = _load_label_names(Path(self.data_dir))
        self.class_names = names if names is not None else [
            f"class_{i}" for i in range(1000)]
        self._counter = 0

        def _preprocess(item):
            if "cls" not in item:
                # a missing label would otherwise index class_names[-1];
                # raising makes WebDataset skip the sample with a warning
                raise ValueError("missing 'cls' member (no label)")
            img = decode_image(item["jpg"] if "jpg" in item else item["jpeg"])
            label = int(item["cls"])
            self._counter += 1
            return dict(
                image=self.test_transform(img) if self.test_transform else img,
                text=self.text_prompt.format(class_name=self.class_names[label]),
                class_id=label,
                image_id=self._counter - 1,
            )

        wds = WebDataset(self.data_path, shuffle_buffer=1000 if self.shuffle_train else 0,
                         map_fn=_preprocess)
        module = self

        class _EpochStableIds:
            """Reset the image_id counter at each iteration start, so a
            sample keeps its id across epochs (the Hessian CLIs iterate one
            loader twice: image pass, then text pass)."""

            def __iter__(self):
                module._counter = 0
                return iter(wds)

            def __getattr__(self, attr):
                return getattr(wds, attr)

        self.dataset = _EpochStableIds()

    def train_dataloader(self):
        return IterableLoader(self.dataset, self.batch_size, drop_last=False)

    val_dataloader = train_dataloader
    test_dataloader = train_dataloader


class _ParquetDataset:
    def __init__(self, rows, transform, text_prompt, class_names, id_map):
        self.rows = rows
        self.transform = transform
        self.text_prompt = text_prompt
        self.class_names = class_names
        self.id_map = id_map

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        from PIL import Image

        row = self.rows[int(i)]
        img = Image.open(io.BytesIO(row["jpg"]))
        if self.transform is not None:
            img = self.transform(img)
        cid = self.id_map[int(row["cls"])]
        return dict(image=img, text=self.text_prompt.format(class_name=self.class_names[cid]),
                    class_id=cid, image_id=int(i))


class _ImagenetParquetModule(DataModule):
    """Seeded class-subset parquet module (ref:imagenet_1k.py)."""

    DATASET_SUBDIR = "imagenet_1k"
    NUM_CLASSES = 100
    CLASSES_SEED = 0

    def setup(self):
        import pandas as pd

        names = _load_label_names(Path(self.data_dir))
        if names is None:
            raise FileNotFoundError("imagenet_classes.json not found and HF builder "
                                    "metadata unavailable offline")
        classes = np.array(names)
        # the reference's np.random.seed + np.random.choice, on a local
        # generator
        class_ids = np.sort(np.random.RandomState(self.CLASSES_SEED).choice(
            np.arange(len(classes)), self.NUM_CLASSES, replace=False))
        self.class_names = [str(c) for c in classes[class_ids]]
        id_map = {int(c): i for i, c in enumerate(class_ids)}
        keep = set(class_ids.tolist())

        trainval = pd.read_parquet(self.data_dir / "trainval.parquet")
        trainval = trainval[trainval.cls.isin(keep)]
        n = len(trainval)
        test = pd.read_parquet(self.data_dir / "test.parquet")
        test = test[test.cls.isin(keep)]

        def make_ds(df, transform):
            return _ParquetDataset(df.to_dict("records"), transform, self.text_prompt,
                                   self.class_names, id_map)

        self.train_dataset = make_ds(trainval.iloc[: int(0.8 * n)], self.train_transform)
        self.val_dataset = make_ds(trainval.iloc[int(0.8 * n):], self.test_transform)
        self.test_dataset = make_ds(test, self.test_transform)


class Imagenet50DataModule(_ImagenetParquetModule):
    NUM_CLASSES = 50


class Imagenet100DataModule(_ImagenetParquetModule):
    NUM_CLASSES = 100


class _FolderTreeModule(DataModule):
    """wnid-folder tree + classes.csv wnid -> words (ref:imagenet_da.py)."""

    SUBTREE = ""

    def _wnid_to_words(self) -> dict:
        out = {}
        with open(self.data_dir / "classes.csv") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    out[row[0]] = row[1]
        return out

    def setup(self):
        root = self.data_dir / self.SUBTREE if self.SUBTREE else self.data_dir
        words = self._wnid_to_words() if (self.data_dir / "classes.csv").exists() else {}
        wnids = sorted(d.name for d in root.iterdir() if d.is_dir())
        self.class_names = [words.get(w, w) for w in wnids]
        records = []
        for ci, wnid in enumerate(wnids):
            for p in sorted((root / wnid).iterdir()):
                if p.suffix.lower() in (".jpg", ".jpeg", ".png"):
                    records.append((p, ci, len(records)))
        idx_train, idx_val, idx_test = _two_splits(list(range(len(records))))

        def make(ids, transform):
            return ImageRecordDataset([records[i] for i in ids], transform,
                                      self.text_prompt, self.class_names)

        self.train_dataset = make(self._apply_subset(idx_train), self.train_transform)
        self.val_dataset = make(idx_val, self.test_transform)
        self.test_dataset = make(idx_test, self.test_transform)


class ImagenetRDataModule(_FolderTreeModule):
    DATASET_SUBDIR = "imagenet-r"
    SUBTREE = ""


class ImagenetDARenditionsDataModule(_FolderTreeModule):
    DATASET_SUBDIR = "imagenet_variations"
    SUBTREE = "renditions"


class ImagenetDASketchDataModule(_FolderTreeModule):
    DATASET_SUBDIR = "imagenet_variations"
    SUBTREE = "sketch"


class _HFRowsDataset:
    def __init__(self, ds, ids, transform, text_prompt, names):
        self.ds = ds
        self.ids = ids
        self.transform = transform
        self.text_prompt = text_prompt
        self.names = names

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        row = self.ds[int(self.ids[int(i)])]
        img = row["image"]
        if self.transform is not None:
            img = self.transform(img)
        return dict(image=img, text=self.text_prompt.format(class_name=self.names[row["label"]]),
                    class_id=int(row["label"]), image_id=int(self.ids[int(i)]))


class ImagenetSketchDataModule(DataModule):
    """HF songweig/imagenet_sketch (ref:imagenet_sketch.py)."""

    DATASET_SUBDIR = "imagenet_sketch"

    def setup(self):
        import datasets as hf_datasets

        ds = hf_datasets.load_dataset("songweig/imagenet_sketch",
                                      cache_dir=str(self.data_dir))["train"]
        names = ds.features["label"].names
        self.class_names = list(names)
        idx_train, idx_val, idx_test = _two_splits(list(range(len(ds))))

        def make(ids, transform):
            return _HFRowsDataset(ds, ids, transform, self.text_prompt, names)

        self.train_dataset = make(idx_train, self.train_transform)
        self.val_dataset = make(idx_val, self.test_transform)
        self.test_dataset = make(idx_test, self.test_transform)
