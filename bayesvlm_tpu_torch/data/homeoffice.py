"""Office-Home datasets (ref:bayesvlm/data/homeoffice.py and
homeoffice_da.py), the port's copy of `bayesvlm_tpu.data.homeoffice`.

- Standard variant: per-domain directory scan, seeded shuffle(42), then
  80/20 trainval/test and 80/20 train/val splits
  (ref:homeoffice.py:88-117). Python's `random.Random(42)` gives the
  ordering the reference's `random.seed(42)` + `random.shuffle` gives,
  without touching the interpreter's global generator.
- Domain-adaptation variant: train = concatenation of all four domains,
  val/test = the target domain (ref:homeoffice_da.py:112-172); samples
  carry `image_path` in the batch (ref:homeoffice_da.py:43-66).
"""

from __future__ import annotations

import random
from pathlib import Path

from bayesvlm_tpu_torch.data.base import DataModule

DOMAINS = ["Art", "Clipart", "Product", "Real World"]


def scan_domain_dir(data_dir: Path):
    """ref:homeoffice.py scan_dir: sorted classes, sorted .jpg paths."""
    classes = sorted(d.name for d in data_dir.iterdir() if d.is_dir())
    data = []
    for i, class_name in enumerate(classes):
        for img_path in (data_dir / class_name).iterdir():
            if img_path.suffix in [".jpg"]:
                data.append(dict(img_path=img_path, class_id=i))
    data = sorted(data, key=lambda x: x["img_path"])
    return data, classes


class _HomeOfficeDataset:
    def __init__(self, data, label_names, text_prompt, transform, with_path=False):
        self._data = list(data)
        self._label_names = label_names
        self._text_prompt = text_prompt
        self._transform = transform
        self._with_path = with_path

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        from PIL import Image

        item = self._data[int(idx)]
        img = Image.open(item["img_path"])
        if self._transform is not None:
            img = self._transform(img)
        out = dict(
            image=img,
            text=self._text_prompt.format(class_name=self._label_names[item["class_id"]]),
            class_id=int(item["class_id"]),
            image_id=int(idx),
        )
        if self._with_path:
            out["image_path"] = str(item["img_path"])
        return out


class HomeOfficeDataModule(DataModule):
    DATASET_SUBDIR = "homeoffice"
    VARIANT = "Art"

    def setup(self):
        data, classes = scan_domain_dir(self.data_dir / self.VARIANT)
        self.class_names = classes
        random.Random(42).shuffle(data)
        n = len(data)
        trainval, test = data[: int(0.8 * n)], data[int(0.8 * n):]
        m = len(trainval)
        train, val = trainval[: int(0.8 * m)], trainval[int(0.8 * m):]
        # the reference applies train_transform to val/test too
        # (ref:homeoffice.py:119-143); the eval splits take test_transform
        self.train_dataset = self._subset_dataset(_HomeOfficeDataset(
            train, classes, self.text_prompt, self.train_transform))
        self.val_dataset = _HomeOfficeDataset(val, classes, self.text_prompt,
                                              self.test_transform)
        self.test_dataset = _HomeOfficeDataset(test, classes, self.text_prompt,
                                               self.test_transform)


class HomeOfficeArtDataModule(HomeOfficeDataModule):
    VARIANT = "Art"


class HomeOfficeClipartDataModule(HomeOfficeDataModule):
    VARIANT = "Clipart"


class HomeOfficeProductDataModule(HomeOfficeDataModule):
    VARIANT = "Product"


class HomeOfficeRealWorldDataModule(HomeOfficeDataModule):
    VARIANT = "Real World"


class HomeOfficeDADataModule(DataModule):
    """Domain adaptation: train on all domains, evaluate on the target
    (ref:homeoffice_da.py:112-172)."""

    DATASET_SUBDIR = "homeoffice"
    VARIANT = "Art"

    def setup(self):
        all_train = []
        classes = None
        for domain in DOMAINS:
            data, cls = scan_domain_dir(self.data_dir / domain)
            classes = cls if classes is None else classes
            all_train.extend(data)
        self.class_names = classes

        target_data, _ = scan_domain_dir(self.data_dir / self.VARIANT)
        random.Random(42).shuffle(target_data)
        n = len(target_data)
        val, test = target_data[: int(0.5 * n)], target_data[int(0.5 * n):]
        self.train_dataset = self._subset_dataset(_HomeOfficeDataset(
            all_train, classes, self.text_prompt, self.train_transform, with_path=True))
        self.val_dataset = _HomeOfficeDataset(val, classes, self.text_prompt,
                                              self.test_transform, with_path=True)
        self.test_dataset = _HomeOfficeDataset(test, classes, self.text_prompt,
                                               self.test_transform, with_path=True)


class HomeOfficeDAArtDataModule(HomeOfficeDADataModule):
    VARIANT = "Art"


class HomeOfficeDAClipartDataModule(HomeOfficeDADataModule):
    VARIANT = "Clipart"


class HomeOfficeDAProductDataModule(HomeOfficeDADataModule):
    VARIANT = "Product"


class HomeOfficeDARealWorldDataModule(HomeOfficeDADataModule):
    VARIANT = "Real World"
