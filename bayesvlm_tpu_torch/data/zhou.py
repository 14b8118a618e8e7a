"""SuS-X / CoOp "zhou split" JSON datasets: EuroSAT, SUN397, UCF101,
OxfordPets, CUB (ref:bayesvlm/data/{eurosat,sun397,ucf101,oxfordpets,cub}.py),
the port's copy of `bayesvlm_tpu.data.zhou`.

Split file format: {"train": [[rel_path, class_id, class_name], ...],
"val": [...], "test": [...]}. Few-shot sampling mirrors the reference's
per-class np.random.choice with the seed reset per class
(ref:eurosat.py:41-58, data/base.few_shot_positions). Images load lazily
(PIL imported where one is opened); the reference preloads them into RAM
(ref:eurosat.py:17-23). The class prompts keep the names as the split
file spells them: unlike the base class, `_` is not replaced.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

from bayesvlm_tpu_torch.data.base import DataModule, few_shot_positions


def _label_names_from_split_info(split_info) -> List[str]:
    idx_to_classname = {x[1]: x[2] for x in split_info}
    return [idx_to_classname[x] for x in sorted(idx_to_classname.keys())]


class _ZhouDataset:
    def __init__(self, image_dir, split_info, text_prompt, transform,
                 use_few_shot=False, shots_per_class=5, few_shot_sample_seed=0):
        self._image_dir = Path(image_dir)
        self._split_info = list(split_info)
        self._text_prompt = text_prompt
        self._transform = transform
        if use_few_shot:
            self._split_info = [self._split_info[i] for i in few_shot_positions(
                [item[1] for item in self._split_info], shots_per_class,
                few_shot_sample_seed)]

    def __len__(self):
        return len(self._split_info)

    def __getitem__(self, idx):
        from PIL import Image

        rel_path, class_id, class_name = self._split_info[int(idx)]
        img = Image.open(self._image_dir / rel_path)
        if self._transform is not None:
            img = self._transform(img)
        return dict(
            image=img,
            text=self._text_prompt.format(class_name=class_name),
            class_id=int(class_id),
            image_id=int(idx),
        )


class ZhouSplitDataModule(DataModule):
    SPLIT_FILE = ""        # e.g. split_zhou_EuroSAT.json
    IMAGE_SUBDIR = ""      # images root relative to data_dir

    def setup(self):
        with open(self.data_dir / self.SPLIT_FILE) as f:
            split = json.load(f)
        image_dir = self.data_dir / self.IMAGE_SUBDIR
        self.class_names = _label_names_from_split_info(
            split["train"] + split["val"] + split["test"])
        self.train_dataset = self._subset_dataset(_ZhouDataset(
            image_dir, split["train"], self.text_prompt, self.train_transform,
            use_few_shot=self.use_few_shot, shots_per_class=self.shots_per_class,
            few_shot_sample_seed=self.few_shot_sample_seed))
        self.val_dataset = _ZhouDataset(image_dir, split["val"], self.text_prompt,
                                        self.test_transform)
        self.test_dataset = _ZhouDataset(image_dir, split["test"], self.text_prompt,
                                         self.test_transform)

    @property
    def class_prompts(self):
        return [self.text_prompt.format(class_name=n) for n in self.class_names]


class EuroSATDataModule(ZhouSplitDataModule):
    DATASET_SUBDIR = "eurosat"
    SPLIT_FILE = "split_zhou_EuroSAT.json"
    IMAGE_SUBDIR = "2750"


class Sun397DataModule(ZhouSplitDataModule):
    DATASET_SUBDIR = "sun397"
    SPLIT_FILE = "split_zhou_SUN397.json"
    IMAGE_SUBDIR = "SUN397"


class UCF101DataModule(ZhouSplitDataModule):
    DATASET_SUBDIR = "ucf101"
    SPLIT_FILE = "split_zhou_UCF101.json"
    IMAGE_SUBDIR = "UCF-101-midframes"


class OxfordpetsDataModule(ZhouSplitDataModule):
    DATASET_SUBDIR = "oxfordpets"
    SPLIT_FILE = "split_zhou_OxfordPets.json"
    IMAGE_SUBDIR = "images"


class CUBDataModule(ZhouSplitDataModule):
    DATASET_SUBDIR = "cub"
    SPLIT_FILE = "split_CUB.json"
    IMAGE_SUBDIR = "images"
