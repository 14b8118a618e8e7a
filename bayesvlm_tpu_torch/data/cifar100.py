"""CIFAR-100 datamodule through HF `datasets` (ref:bayesvlm/data/cifar100.py),
the port's copy of `bayesvlm_tpu.data.cifar100`.

Split parity: `dataset['train'].train_test_split(test_size=0.2, seed=0)`
(ref:cifar100.py:69-73), the same HF call, so the split is the
reference's. Fine labels. `datasets` is imported in `setup`.
"""

from __future__ import annotations

from bayesvlm_tpu_torch.data.base import DataModule


class _CIFAR100Dataset:
    def __init__(self, data, label_names, text_prompt, transform):
        self._data = data
        self._label_names = label_names
        self._text_prompt = text_prompt
        self._transform = transform

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        row = self._data[int(idx)]
        image = row["img"]
        if self._transform is not None:
            image = self._transform(image)
        label = row["fine_label"]
        return dict(
            image=image,
            text=self._text_prompt.format(class_name=self._label_names[label]),
            class_id=int(label),
            image_id=int(idx),
        )


class CIFAR100DataModule(DataModule):
    DATASET_SUBDIR = "cifar100"

    def setup(self):
        import datasets as hf_datasets

        dataset = hf_datasets.load_dataset("cifar100", cache_dir=str(self.data_dir))
        label_names = dataset["train"].features["fine_label"].names
        self.class_names = list(label_names)
        split = dataset["train"].train_test_split(test_size=0.2, seed=0)
        self.train_dataset = self._subset_dataset(_CIFAR100Dataset(
            split["train"], label_names, self.text_prompt, self.train_transform))
        self.val_dataset = _CIFAR100Dataset(split["test"], label_names, self.text_prompt,
                                            self.test_transform)
        self.test_dataset = _CIFAR100Dataset(dataset["test"], label_names,
                                             self.text_prompt, self.test_transform)

    @property
    def class_prompts(self):
        return [self.text_prompt.format(class_name=n) for n in self.class_names]
