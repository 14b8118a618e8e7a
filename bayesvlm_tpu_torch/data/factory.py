"""Dataset registry + factory (ref:bayesvlm/data/factory.py), the port's
copy of `bayesvlm_tpu.data.factory`.

Each module's data directory is the `DATA_BASE_DIR` environment variable
(read from a `.env` file in the working directory when the environment
lacks it, parsed without python-dotenv), or the factory's `base_path`,
joined with the module's DATASET_SUBDIR (ref:factory.py:116-127).
Registered: the JAX package's 27 names, the reference's SUPPORTED_MODULES
(ref:factory.py:52-88) plus `synthetic` for tests and benchmarks. The
modules import without PIL, scipy, pandas or `datasets`; each imports
what it reads with where it reads.
"""

from __future__ import annotations

import os
from pathlib import Path

from bayesvlm_tpu_torch.data.cifar100 import CIFAR100DataModule
from bayesvlm_tpu_torch.data.folder import (
    DTDDataModule,
    Flowers102DataModule,
    Food101DataModule,
    StanfordCarsDataModule,
)
from bayesvlm_tpu_torch.data.homeoffice import (
    HomeOfficeArtDataModule,
    HomeOfficeClipartDataModule,
    HomeOfficeDAArtDataModule,
    HomeOfficeDAClipartDataModule,
    HomeOfficeDAProductDataModule,
    HomeOfficeDARealWorldDataModule,
    HomeOfficeProductDataModule,
    HomeOfficeRealWorldDataModule,
)
from bayesvlm_tpu_torch.data.imagenet import (
    Imagenet50DataModule,
    Imagenet100DataModule,
    ImagenetDARenditionsDataModule,
    ImagenetDASketchDataModule,
    ImagenetRDataModule,
    ImagenetSketchDataModule,
    ImagenetWDSModule,
)
from bayesvlm_tpu_torch.data.laion400m import Laion400mDataModule
from bayesvlm_tpu_torch.data.synthetic import SyntheticDataModule
from bayesvlm_tpu_torch.data.transforms import default_transform
from bayesvlm_tpu_torch.data.zhou import (
    CUBDataModule,
    EuroSATDataModule,
    OxfordpetsDataModule,
    Sun397DataModule,
    UCF101DataModule,
)

SUPPORTED_MODULES = {
    "laion400m": Laion400mDataModule,
    # downstream datasets
    "flowers102": Flowers102DataModule,
    "food101": Food101DataModule,
    "eurosat": EuroSATDataModule,
    "cifar100": CIFAR100DataModule,
    "stanfordcars": StanfordCarsDataModule,
    "dtd": DTDDataModule,
    "sun397": Sun397DataModule,
    "oxfordpets": OxfordpetsDataModule,
    "ucf101": UCF101DataModule,
    "cub": CUBDataModule,
    # homeoffice
    "homeoffice-art": HomeOfficeArtDataModule,
    "homeoffice-clipart": HomeOfficeClipartDataModule,
    "homeoffice-product": HomeOfficeProductDataModule,
    "homeoffice-realworld": HomeOfficeRealWorldDataModule,
    "homeoffice-da-art": HomeOfficeDAArtDataModule,
    "homeoffice-da-clipart": HomeOfficeDAClipartDataModule,
    "homeoffice-da-product": HomeOfficeDAProductDataModule,
    "homeoffice-da-realworld": HomeOfficeDARealWorldDataModule,
    # imagenet
    "imagenet-val-wds": ImagenetWDSModule,
    "imagenet-100": Imagenet100DataModule,
    "imagenet-50": Imagenet50DataModule,
    "imagenet-r": ImagenetRDataModule,
    "imagenet-sketch": ImagenetSketchDataModule,
    "imagenet-da-r": ImagenetDARenditionsDataModule,
    "imagenet-da-sketch": ImagenetDASketchDataModule,
    # testing / benchmarking (no reference counterpart)
    "synthetic": SyntheticDataModule,
}


def _load_dotenv():
    """Parse a .env file in cwd (python-dotenv replacement,
    ref:factory.py:117-118); the environment wins."""
    env_path = Path(".env")
    if not env_path.exists():
        return
    for line in env_path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, v = line.split("=", 1)
        os.environ.setdefault(k.strip(), v.strip().strip('"').strip("'"))


class DataModuleFactory:
    def __init__(
        self,
        batch_size: int = 32,
        num_workers: int = 4,
        text_prompt: str = "An image of a {class_name}",
        train_transform=None,
        test_transform=None,
        shuffle_train: bool = True,
        base_path: str = None,
        shots_per_class: int = 10,
        use_few_shot: bool = False,
        few_shot_sample_seed: int = 42,
        subset_indices=None,
    ):
        self.base_path = base_path
        self.kwargs = dict(
            batch_size=batch_size,
            num_workers=num_workers,
            text_prompt=text_prompt,
            train_transform=(train_transform if train_transform is not None
                             else default_transform(224)),
            test_transform=(test_transform if test_transform is not None
                            else default_transform(224)),
            shuffle_train=shuffle_train,
            subset_indices=subset_indices,
            shots_per_class=shots_per_class,
            use_few_shot=use_few_shot,
            few_shot_sample_seed=few_shot_sample_seed,
        )

    def create(self, name: str, **overrides):
        if name not in SUPPORTED_MODULES:
            raise ValueError(
                f"Unknown dataset '{name}'. Supported: {sorted(SUPPORTED_MODULES)}"
            )
        cls = SUPPORTED_MODULES[name]
        _load_dotenv()
        base = self.base_path or os.environ.get("DATA_BASE_DIR", "")
        data_dir = Path(base) / cls.DATASET_SUBDIR if base else Path(cls.DATASET_SUBDIR)
        return cls(**{"data_dir": str(data_dir), **self.kwargs, **overrides})
