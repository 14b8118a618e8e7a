"""The port's `profiling.py` against the JAX package's, the three cases of
tests/test_profiling.py:14-40: the trace context writes a trace of the
ops it saw, `debug_nans` raises on a NaN as JAX's does (the port:
FloatingPointError at the op; off again outside its scope), and StepTimer's summary equals
JAX's on the same clock readings (exactly: the same arithmetic)."""

import glob
import json

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch import profiling
from bayesvlm_tpu_torch.profiling import StepTimer, debug_nans, trace


def test_trace_writes_profile(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))
    x @ x.T
    with trace(str(tmp_path)) as prof:
        x @ x.T
    files = glob.glob(str(tmp_path / "**" / "*.json"), recursive=True)
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(open(files[0]).read())["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_debug_nans_catches_as_jax_does():
    import jax
    import jax.numpy as jnp

    from bayesvlm_tpu.profiling import debug_nans as jax_debug_nans

    # JAX's case as tests/test_profiling.py:26-29 holds it (any exception)
    with pytest.raises((FloatingPointError, ZeroDivisionError, Exception)):
        with jax_debug_nans():
            jax.block_until_ready(jnp.log(jnp.asarray(-1.0)))
    with pytest.raises(FloatingPointError, match="log"):
        with debug_nans():
            torch.log(torch.tensor(-1.0))
    with debug_nans():
        assert float(torch.log(torch.tensor(2.0))) == pytest.approx(np.log(2.0))
        with debug_nans(False):  # turned off for its own scope
            assert torch.isnan(torch.log(torch.tensor(-1.0)))
        with pytest.raises(FloatingPointError):  # and on again after it
            torch.sqrt(torch.tensor(-1.0))
    assert torch.isnan(torch.log(torch.tensor(-1.0)))  # off outside


def test_debug_nans_catches_a_backward_nan():
    w = torch.tensor([0.0], requires_grad=True)
    with pytest.raises(FloatingPointError):
        with debug_nans():
            (torch.sqrt(w) * 0.0).sum().backward()  # d sqrt at 0 is inf; inf * 0


def test_step_timer_summary_matches_jax(monkeypatch):
    """tests/test_profiling.py:33-40 on both timers, each fed the same
    clock readings."""
    import bayesvlm_tpu.profiling as jax_profiling

    readings = [0.0, 0.004, 1.0, 1.002, 2.0, 2.003, 3.0, 3.005, 4.0, 4.001]
    summaries = []
    for module, timer in ((profiling, StepTimer()), (jax_profiling, jax_profiling.StepTimer())):
        clock = iter(readings)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        for _ in range(5):
            with timer.step():
                pass
        summaries.append(timer.summary(items_per_step=32))
    ours, theirs = summaries
    assert ours == theirs
    assert ours["steps"] == 3  # two warm-up steps discarded
    assert ours["items_per_sec"] == pytest.approx(32 / (ours["mean_ms"] / 1e3), rel=1e-6)
