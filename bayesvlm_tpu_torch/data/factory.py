"""Dataset registry + factory (ref:bayesvlm/data/factory.py), the port's
copy of `bayesvlm_tpu.data.factory`.

Only `synthetic` is registered: the other modules of the JAX package's
registry read dataset files and are not ported yet (ROADMAP Queue 1);
the data directory (`DATA_BASE_DIR`) and the subset and few-shot options
come with them.
"""

from __future__ import annotations

from bayesvlm_tpu_torch.data.synthetic import SyntheticDataModule
from bayesvlm_tpu_torch.data.transforms import default_transform

SUPPORTED_MODULES = {
    # testing / benchmarking (no reference counterpart)
    "synthetic": SyntheticDataModule,
}


class DataModuleFactory:
    def __init__(
        self,
        batch_size: int = 32,
        num_workers: int = 4,
        text_prompt: str = "An image of a {class_name}",
        train_transform=None,
        test_transform=None,
        shuffle_train: bool = True,
    ):
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
        return SUPPORTED_MODULES[name](**{**self.kwargs, **overrides})
