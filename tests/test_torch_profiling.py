"""The port's profiling utils (``utils/profiling.py``) against the JAX
package's: ``StepTimer`` on the same step times, ``trace`` writing a trace
file, and ``Trainer(profile_first_epoch=True)`` tracing epoch 0 into
``output_dir/profile``."""

import json
import os

import numpy as np
import pytest
import torch

from gelslim_depth_tpu.utils import profiling as jax_profiling
from gelslim_depth_tpu_torch import GelslimConfig, Trainer, bake_dataset
from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object
from gelslim_depth_tpu_torch.utils import StepTimer, trace
from gelslim_depth_tpu_torch.utils import profiling
from tests.torch_port_helpers import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _clock(monkeypatch, module, ticks):
    it = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("window", [3, 100])
def test_step_timer_matches_jax(monkeypatch, window):
    """Seven steps of uneven lengths, through start/stop and the step()
    context manager; with window 3 only the last three stay."""
    durations = [0.5, 0.125, 2.0, 0.25, 1.0, 0.0625, 4.0]
    ticks = list(np.cumsum([[1.0, d] for d in durations]))
    summaries = []
    for module, timer_cls in ((profiling, StepTimer), (jax_profiling, jax_profiling.StepTimer)):
        _clock(monkeypatch, module, ticks)
        timer = timer_cls(window=window)
        assert timer.summary() == {"n": 0}
        for i in range(len(durations)):
            if i % 2:
                with timer.step():
                    pass
            else:
                timer.start()
                timer.stop()
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["n"] == min(window, 7)


def _trace_files(log_dir):
    return [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]


def test_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = _trace_files(log_dir)
    with open(log_dir / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trainer_profiles_its_first_epoch(tmp_path):
    objs = [make_synthetic_object(np.random.RandomState(4), n=4, image_size=(32, 43)) for _ in range(2)]
    ds = bake_dataset(preloaded=objs, device="cpu", use_difference_image=True,
                      image_normalization_method="0_255_to_0_1", norm_scale=0.9)
    cfg = GelslimConfig(weights_name="prof", CNN_dimensions=(4, 8), batch_size=4)
    tr = Trainer(cfg, ds, ds, ds, output_dir=str(tmp_path), device="cpu", enable_plots=False,
                 log_fn=lambda m: None, profile_first_epoch=True)
    tr.fit(max_epochs=2)
    assert len(_trace_files(tmp_path / "profile")) == 1  # epoch 0 only
