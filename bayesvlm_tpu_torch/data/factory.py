"""Dataset registry + factory (ref:bayesvlm/data/factory.py), the port's
copy of `bayesvlm_tpu.data.factory`.

Each module's data directory is the `DATA_BASE_DIR` environment variable
(read from a `.env` file in the working directory when the environment
lacks it, parsed without python-dotenv), or the factory's `base_path`,
joined with the module's DATASET_SUBDIR (ref:factory.py:116-127).
Registered: `laion400m` (the Stage-1 webdataset tars) and `synthetic`;
the other modules of the JAX package's registry, and the subset and
few-shot options, come with the file-backed modules (ROADMAP Queue 1).
"""

from __future__ import annotations

import os
from pathlib import Path

from bayesvlm_tpu_torch.data.laion400m import Laion400mDataModule
from bayesvlm_tpu_torch.data.synthetic import SyntheticDataModule
from bayesvlm_tpu_torch.data.transforms import default_transform

SUPPORTED_MODULES = {
    "laion400m": Laion400mDataModule,
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
