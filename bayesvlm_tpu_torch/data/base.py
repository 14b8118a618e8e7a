"""DataModule base class — the contract every dataset module implements
(ref:bayesvlm/data/*, SURVEY §2.5):

    ctor(data_dir, batch_size, num_workers, text_prompt, train_transform,
         test_transform, shuffle_train)
    setup()
    train_dataloader() / val_dataloader() / test_dataloader()
    class_prompts -> list[str]

This replaces LightningDataModule with a plain Python base (no Lightning
dependency in the compute path). The port's copy of
`bayesvlm_tpu.data.base`, cut to what the registered modules need:
`data_dir` is the module's dataset directory (the factory joins
`DATA_BASE_DIR` with the module's `DATASET_SUBDIR`); subsets and
few-shot sampling come with the file-backed modules (ROADMAP Queue 1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional

from bayesvlm_tpu_torch.data.loader import DataLoader


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
    ):
        self.data_dir = Path(data_dir) if data_dir else Path(".")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.text_prompt = text_prompt
        self.train_transform = train_transform
        self.test_transform = test_transform
        self.shuffle_train = shuffle_train

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
