"""The benchmark's video depth cell ``vda_vitl14_clip64`` driven whole
through ``harness.run_cell`` on the CPU, in a copy of the benchmark
(``benchmark/tests/small.py``) whose configuration and traffic files are
cut to a small size: the program passes the committed limits, the faults
of ``benchmark/faults.py`` planted under its serving call and the
temporal controls of ``scripts/vda_controls.py`` served in its place do
not, and a traced run hands the cell's three readers a trace holding the
program's spans, from which they read numbers once the slice has device
ops.

The small size is ``tests/test_torch_vda.py``'s: the encoder of 4 blocks
of width 64, features 32, reassembly widths (32, 32, 64, 64), clips of 4
frames, a 56x84 input from 64x86 frames; 8 dual frames a call (2 clips a
finger), 2 calls kept. The card's readings at the cell's size, from which
the limits were set, are in PERF.md."""

import importlib.util
import json
import os
import time

import pytest
import torch

from benchmark import faults, harness, spans, yardstick, yardstick_vda
from benchmark.tests import small
from tests.test_torch_benchmark_dpt import _with_device_ops
from tests.torch_port_helpers import torch_threads

WORKLOAD = "vda_vitl14_clip64"
TRAFFIC = {"vda_clip64": {"dual_frames_per_call": 8, "pool": 2, "kept_calls": 2, "warmup_calls": 1,
                          "traced_calls": 2}}
SMALL = {"input_tactile_image_size": [56, 84], "frame_size": [64, 86]}
SMALL_DPT = {"embed_dim": 64, "depth": 4, "num_heads": 4, "hooks": [0, 1, 2, 3], "features": 32,
             "out_channels": [32, 32, 64, 64], "num_frames": 4}
METRICS = ("mfu.vda", "temporal_roofline.vda", "temporal_attention_roofline.vda")

_spec = importlib.util.spec_from_file_location("vda_controls", os.path.join(harness.ROOT, "scripts",
                                                                            "vda_controls.py"))
controls = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(controls)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = small.copy(tmp_path_factory.mktemp("bench"), config={}, traffic=TRAFFIC)
    path = os.path.join(dest, "benchmark", "configs", "vda_vitl14_bf16.json")
    cfg = harness.load_json(path)
    cfg.update(SMALL, dpt={**cfg["dpt"], **SMALL_DPT})
    with open(path, "w") as f:
        json.dump(cfg, f)
    return dest


def run(root, seed=1, traced=False, system=None):
    return harness.run_cell(harness.find_cell(WORKLOAD, root), seed, 0.05, traced, "cpu", time.perf_counter(),
                            system=system, root=root)


@pytest.mark.parametrize("seed", [1, 2])
def test_program_correct(root, seed):
    r = run(root, seed)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert r["counts"]["frames_checked"] == 16
    assert r["counts"]["depth_spread_mm"] > 3 * r["counts"]["depth_rmse_mm"]


@pytest.mark.parametrize("fault", ["half_batch", "swapped_answer", "stale_input"])
def test_faults(root, fault):
    with faults.planted(fault):
        assert not run(root)["correct"]


@pytest.mark.parametrize("kind", ["no_temporal", "reversed", "interleaved"])
def test_temporal_controls(root, kind):
    assert not run(root, system=controls.CONTROLS[kind])["correct"]


def test_traced_run_reads_the_temporal_metrics(root):
    """On the CPU a traced run's slice has no device ops, so the readers
    read nothing; over made-up device ops (one a span) each reads what the
    spans and the yardstick give."""
    cell = harness.find_cell(WORKLOAD, root)
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert run(root, traced=True)["metrics"] == {}
    r = harness.load_module("loops", "closed_vda", root).run(cell, 3, 0.05, True, torch.device("cpu"))
    names = [s.name for s in r.trace.spans]
    assert names.count(spans.CALL) == 2 and names.count("dpt.temporal") == 8
    assert names.count("dpt.temporal_attention") == 16 and names.count("dpt.temporal_ff") == 8
    op_us = 10.0
    st = _with_device_ops(r.trace, op_us)
    ctx = {"config": cell.config, "traffic": cell.traffic,
           "peaks": yardstick.card_peaks("NVIDIA H100 80GB HBM3")}
    got = {m: harness.load_reader(m, root)(st, ctx) for m in METRICS}
    temporal_ms = op_us / 1e3 * sum(st.within(i, "dpt.temporal") for i in range(len(st.spans))) / 2
    assert temporal_ms == pytest.approx(op_us / 1e3 * (8 + 16 + 8) / 2)
    assert got["temporal_roofline.vda"] == pytest.approx(
        100 * yardstick_vda.temporal_bound_ms(cell.config, 8, ctx["peaks"]) / temporal_ms)
    assert got["temporal_attention_roofline.vda"] == pytest.approx(
        100 * yardstick_vda.temporal_attention_bound_ms(cell.config, 8, ctx["peaks"]) / (op_us / 1e3 * 8))
    assert got["mfu.vda"] == pytest.approx(
        100 * yardstick_vda.call_flops(cell.config, 8) * 2 / st.window_s / ctx["peaks"].bf16_flops)


def test_yardstick_at_the_published_size():
    """The cell's arithmetic, counted by hand from the layer equations:
    the modules add 44 C^2 FLOPs a token in their linears and 0.43 GFLOP
    of attention cores, 48.0 GFLOP a finger image on the DPT's 582.85,
    80.75 TFLOP a call of 64 dual frames."""
    cfg = harness.find_cell(WORKLOAD).config
    assert yardstick_vda.clip_lengths(cfg, 64) == [32] * 4
    assert yardstick_vda.temporal_flops(cfg, 64) / 128 == pytest.approx(48.01e9, rel=1e-3)
    assert yardstick_vda.call_flops(cfg, 64) == pytest.approx(80.75e12, rel=1e-3)
    assert yardstick_vda.clip_lengths(cfg, 40) == [32, 8, 32, 8]
