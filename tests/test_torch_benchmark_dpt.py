"""The benchmark's transformer cell ``dpt_vitl14_batch64`` driven whole
through ``harness.run_cell`` on the CPU, in a copy of the benchmark
(``benchmark/tests/small.py``) whose configuration and traffic files are
cut to a small size: the program passes the committed limits, the faults
of ``benchmark/faults.py`` planted under its serving call do not, and a
traced run hands the readers a trace holding the program's spans, from
which the cell's span metrics read numbers once the slice has device ops.

The small size is ``tests/test_torch_dpt.py``'s: patch 14, 4 blocks of
width 64 and 4 heads, features 16, a 28x42 input from 32x43 frames; 4
dual frames a call, 2 calls kept. The card's readings at the cell's size,
from which the limits were set, are in PERF.md."""

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import faults, harness, spans, yardstick, yardstick_dpt
from benchmark.tests import small
from tests.torch_port_helpers import torch_threads

WORKLOAD = "dpt_vitl14_batch64"
TRAFFIC = {"dpt_batch64": {"dual_frames_per_call": 4, "pool": 2, "kept_calls": 2, "warmup_calls": 1,
                           "traced_calls": 2}}
SMALL = {"input_tactile_image_size": [28, 42], "frame_size": [32, 43]}
SMALL_DPT = {"embed_dim": 64, "depth": 4, "num_heads": 4, "hooks": [0, 1, 2, 3], "features": 16,
             "out_channels": [8, 16, 32, 32]}
METRICS = ("mfu.dpt", "vit_roofline.dpt", "attention_roofline.dpt", "dpt_head_ms.dpt", "launches_per_call.dpt",
           "head_passes_ms.dpt")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = small.copy(tmp_path_factory.mktemp("bench"), config={}, traffic=TRAFFIC)
    path = os.path.join(dest, "benchmark", "configs", "dpt_vitl14_bf16.json")
    cfg = harness.load_json(path)
    cfg.update(SMALL, dpt={**cfg["dpt"], **SMALL_DPT})
    with open(path, "w") as f:
        json.dump(cfg, f)
    return dest


def run(root, seed=1, traced=False):
    return harness.run_cell(harness.find_cell(WORKLOAD, root), seed, 0.05, traced, "cpu", time.perf_counter(),
                            root=root)


@pytest.mark.parametrize("seed", [1, 2])
def test_program_correct(root, seed):
    r = run(root, seed)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert r["counts"]["frames_checked"] == 8
    # the depth follows the frame by far more than the rounding moves it
    assert r["counts"]["depth_spread_mm"] > 10 * r["counts"]["depth_rmse_mm"]


@pytest.mark.parametrize("fault", ["half_batch", "stale_input"])
def test_faults(root, fault):
    with faults.planted(fault):
        assert not run(root)["correct"]


def _with_device_ops(st: spans.SpanTrace, op_us: float) -> spans.SpanTrace:
    """The slice's recorded spans over a made-up profile: one device op of
    op_us a span, launched by a runtime call just after the span opens."""
    base_ns = 7_000_000_000
    events = []
    for i, s in enumerate(st.spans):
        start = s.start_us + 0.01
        events.append(SimpleNamespace(name="cudaLaunchKernel", device_type=DeviceType.CPU, id=i, thread=1,
                                      time_range=SimpleNamespace(start=start, end=start + 0.001)))
        events.append(SimpleNamespace(name=f"kernel_{i}", device_type=DeviceType.CUDA, id=i, thread=1,
                                      time_range=SimpleNamespace(start=start, end=start + op_us)))
    prof = SimpleNamespace(events=lambda: events, profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(trace_start_ns=lambda: base_ns)))
    recorded = [SimpleNamespace(name=s.name, site=s.site, parent=s.parent, call=s.call,
                                start_ns=base_ns + s.start_us * 1e3, end_ns=base_ns + s.end_us * 1e3)
                for s in st.spans]
    return spans.SpanTrace(prof, st.units, st.window_s, recorded)


def test_traced_run_reads_the_span_metrics(root):
    """On the CPU a traced run's slice has no device ops, so the readers
    read nothing; its spans are the program's, and over made-up device ops
    (one a span) each reader reads what the spans and the yardstick give."""
    cell = harness.find_cell(WORKLOAD, root)
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert run(root, traced=True)["metrics"] == {}
    r = harness.load_module("loops", "closed_dpt", root).run(cell, 3, 0.05, True, torch.device("cpu"))
    names = [s.name for s in r.trace.spans]
    assert names.count(spans.CALL) == 2 and names.count("dpt.block") == 8 and names.count("dpt.attention") == 8
    op_us = 10.0
    st = _with_device_ops(r.trace, op_us)
    ctx = {"config": cell.config, "traffic": cell.traffic,
           "peaks": yardstick.card_peaks("NVIDIA H100 80GB HBM3")}
    got = {m: harness.load_reader(m, root)(st, ctx) for m in METRICS}
    per_call = len(st.spans) / 2  # every span of the slice is inside a call
    block_ms = op_us / 1e3 * (names.count("dpt.block") + names.count("dpt.attention") + names.count("dpt.mlp")) / 2
    head = sum(st.within(i, "dpt.head") for i in range(len(st.spans))) / 2
    convs = sum(st.within(i, "head.conv") for i in range(len(st.spans))) / 2
    assert convs == 32
    images = 2 * cell.traffic["dual_frames_per_call"]
    assert got["launches_per_call.dpt"] == pytest.approx(per_call)
    assert got["dpt_head_ms.dpt"] == pytest.approx(op_us / 1e3 * head)
    assert got["head_passes_ms.dpt"] == pytest.approx(op_us / 1e3 * (head - convs))
    assert got["vit_roofline.dpt"] == pytest.approx(
        100 * yardstick_dpt.vit_bound_ms(cell.config, images, ctx["peaks"]) / block_ms)
    assert got["attention_roofline.dpt"] == pytest.approx(
        100 * yardstick_dpt.attention_bound_ms(cell.config, images, ctx["peaks"]) / (op_us / 1e3 * 4))
    assert got["mfu.dpt"] == pytest.approx(
        100 * yardstick_dpt.call_flops(cell.config, 4) * 2 / st.window_s / ctx["peaks"].bf16_flops)
