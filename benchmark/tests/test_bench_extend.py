"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files and entries, editing no file that is there: the
harness finds them by name in a copy of the benchmark."""

import json
import time

import torch

from benchmark import harness
from benchmark.tests import small

# a loop of its own: the closed loop's window, measured as calls a second
LOOP = """
from benchmark import harness


def run(cell, seed, seconds, traced, device, system=None):
    inner = harness.load_module("loops", "closed").run(cell, seed, seconds, traced, device, system=system)
    window_s = inner.attempted * cell.traffic["dual_frames_per_call"] / inner.metrics["frames_per_s"]
    inner.metrics = {"calls_per_s": inner.attempted / window_s}
    return inner
"""


def test_new_cell_from_new_files(tmp_path):
    """A configuration, a traffic mix with a loop of its own that measures
    an end-to-end metric of its own, a per-layer metric and a cell."""
    root = small.copy(tmp_path)
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "unet_bigdata_int8.json").read_text())
    config.update(CNN_dimensions=[8, 16])
    (bench / "configs" / "unet_tiny_int8.json").write_text(json.dumps(config))
    (bench / "traffic" / "batch2.json").write_text(json.dumps(
        {"loop": "counted", "dual_frames_per_call": 2, "pool": 2, "inputs_on": "host", "outputs_on": "host",
         "warmup_calls": 1, "kept_calls": 2, "traced_calls": 3}))
    (bench / "loops" / "counted.py").write_text(LOOP)
    (bench / "limits" / "tiny_batch2.json").write_text(json.dumps({"worst_frame_rmse_mm": 0.5}))
    (bench / "metrics" / "traced_calls.tiny.py").write_text("def read(trace, ctx):\n    return trace.units\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "unet_tiny_int8", "source": "https://github.com/MMintLab/gelslim_depth",
                            "file": "benchmark/configs/unet_tiny_int8.json", "reduced": ["CNN_dimensions"],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny_batch2", "config": "unet_tiny_int8", "traffic": "batch2", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher", "bound": 0.1,
                               "source": "host_clock", "workloads": ["tiny_batch2"]})
    spec["per_layer"].append({"name": "traced_calls.tiny", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "device", "moves": "calls_per_s",
                              "workloads": ["tiny_batch2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.find_cell("tiny_batch2", root=root)
    assert cell.config["CNN_dimensions"] == [8, 16] and cell.traffic["dual_frames_per_call"] == 2
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "calls_per_s"]
    assert [m["name"] for m in cell.per_layer] == ["traced_calls.tiny"]
    torch.set_num_threads(2)
    plain = harness.run_cell(cell, 7, 0.05, False, "cpu", time.perf_counter(), root=root)
    assert set(plain["metrics"]) == {"calls_per_s", "setup_s"} and plain["correct"]
    assert plain["metrics"]["calls_per_s"]["value"] > 0
    traced = harness.run_cell(cell, 7, 0.05, True, "cpu", time.perf_counter(), root=root)
    assert traced["metrics"] == {"traced_calls.tiny": {"value": 3.0, "unit": "calls"}}
    assert list(traced)[-1] == "compared"
