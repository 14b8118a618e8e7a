"""wandb-compatible experiment logging with an optional dependency,
counterpart of `bayesvlm_tpu.train.logging`.

The reference logs every fine-tune run to wandb
(ref:scripts/activelearning.py:109-123,179-223). The logger uses wandb
where it can be imported and always appends JSONL to
`<dir>/metrics.jsonl` with the same keys as the JAX package's logger: a
first line {"_config", "_name"}, then one line of metrics per `log` call
with its "_step".
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Optional


class ExperimentLogger:
    def __init__(self, project: str, run_dir, name: Optional[str] = None,
                 config: Optional[dict] = None, use_wandb: bool = True):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                try:
                    self._wandb = wandb.init(project=project, dir=str(self.run_dir),
                                             reinit=True)
                    if config:
                        wandb.config.update(config)
                    if name:
                        wandb.run.name = name
                except Exception as e:  # the run goes on with the JSONL log alone
                    warnings.warn(f"wandb failed ({e!r}); logging to metrics.jsonl only",
                                  RuntimeWarning, stacklevel=2)
                    self._wandb = None
        self._file = open(self.run_dir / "metrics.jsonl", "a")
        if config:
            self._file.write(json.dumps({"_config": config, "_name": name}) + "\n")

    def log(self, metrics: dict, step: int) -> None:
        payload = {k: _to_py(v) for k, v in metrics.items()}
        if self._wandb is not None:
            import wandb

            wandb.log(payload, step=step)
        payload["_step"] = step
        self._file.write(json.dumps(payload) + "\n")
        self._file.flush()

    def finish(self) -> None:
        if self._wandb is not None:
            import wandb

            wandb.finish()
        self._file.close()


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
