"""Tracing and profiling utilities, the counterpart of the JAX package's
`bayesvlm_tpu/profiling.py:1-84`: a profiler trace over a scope, NaN
checking, and a step timer with a warm-up discard.

    with trace("runs/trace"):
        vlm.predict(images)          # runs/trace/trace_<pid>_<n>.json
    with debug_nans():
        loss = step(batch)           # FloatingPointError at the first NaN
    timer = StepTimer()
    for batch in batches:
        with timer.step() as s:
            s["result"] = vlm.predict(batch)
    timer.summary(items_per_step=len(batch))
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_TRACE_IDS = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
    """Run `torch.profiler` over the scope, with CPU and, where a card is
    present, CUDA activities, and write a Chrome trace (viewable in
    Perfetto or chrome://tracing) as `<log_dir>/trace_<pid>_<n>.json`.
    Yields the profiler (its `key_averages()` too).

    Known loss (PERF.md section 7): in a process that has captured a CUDA
    graph or started child processes, the profiler's sessions record no
    kernels; trace such work in a fresh process."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json"))


# debug_nans' setting, a thread's own (as torch's dispatch modes are)
_NAN_CHECK = threading.local()


def _checking() -> bool:
    return getattr(_NAN_CHECK, "on", False)


class _NaNCheckMode(TorchDispatchMode):
    """Raises FloatingPointError when a torch op's floating output holds a
    NaN, while `debug_nans` is on."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _checking():
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.numel() and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"debug_nans: {func} produced a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the scope, raise FloatingPointError at the first torch op
    whose floating output holds a NaN, forward or backward (JAX's
    `jax_debug_nans`; `torch.autograd.set_detect_anomaly` alone catches
    backward NaNs only). The previous setting comes back on exit, so
    `debug_nans(False)` inside turns it off for its own scope. Each op's
    output is read back to the host, which synchronises the card: a
    debugging aid, not a production setting. A hand-written kernel
    launched through ctypes writes its output outside torch's
    dispatcher, so a NaN it writes is caught at the next torch op that
    reads it (its output then holds the NaN), not at the launch. The
    setting is the calling thread's own."""
    prev = _checking()
    _NAN_CHECK.on = bool(enable)
    try:
        if enable and not prev:
            with _NaNCheckMode():
                yield
        else:
            yield
    finally:
        _NAN_CHECK.on = prev


def _synchronize(result) -> None:
    """Wait for every card that holds a tensor of `result` (any nesting)."""
    devices = {t.device for t in tree_leaves(result)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


@dataclass
class StepTimer:
    """Wall-clock step timer with a warm-up discard and items/s. `stop`
    synchronises the cards the passed result lives on (JAX's
    `block_until_ready`), so asynchronous launches do not hide device
    time."""

    warmup: int = 2
    _times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None
    _steps: int = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - self._t0
        self._steps += 1
        if self._steps > self.warmup:
            self._times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        holder = {}
        yield holder
        self.stop(holder.get("result"))

    @property
    def mean_s(self) -> float:
        return sum(self._times) / max(1, len(self._times))

    def items_per_sec(self, items_per_step: int) -> float:
        return items_per_step / self.mean_s if self._times else 0.0

    def summary(self, items_per_step: Optional[int] = None) -> Dict[str, float]:
        out = {
            "steps": len(self._times),
            "mean_ms": self.mean_s * 1e3,
            "min_ms": min(self._times) * 1e3 if self._times else 0.0,
        }
        if items_per_step:
            out["items_per_sec"] = self.items_per_sec(items_per_step)
        return out
