"""The benchmark's Depth Pro cell ``depth_pro_batch8`` driven whole through
``harness.run_cell`` on the CPU, in a copy of the benchmark
(``benchmark/tests/small.py``) whose configuration and traffic files are
cut to a small size: the program passes the committed limits, the faults
of ``benchmark/faults.py`` planted under its serving call and the
mis-merged tiles of ``scripts/depth_pro_controls.py`` served in its place
do not, and a traced run hands the cell's three readers a trace holding
the program's spans, from which they read numbers once the slice has
device ops.

The small size is ``tests/test_torch_depth_pro.py``'s: 128x128 tiles of
patch 16 on a 512x512 input, both encoders 4 blocks of width 64, decoder
width 16, 64x86 frames; 2 dual frames a call, 2 calls kept. The card's
readings at the cell's size, from which the limits were set, are in
PERF.md."""

import json
import os
import time

import pytest
import torch

from benchmark import faults, harness, spans, yardstick, yardstick_depth_pro
from benchmark.tests import small
from benchmark.yardstick_depth_pro import ELEMENTWISE
from benchmark.yardstick_dpt import op_ms
from tests.test_torch_benchmark_dpt import _with_device_ops
from tests.test_torch_depth_pro import SMALL, controls
from tests.torch_port_helpers import torch_threads

WORKLOAD = "depth_pro_batch8"
TRAFFIC = {"depth_pro_batch8": {"dual_frames_per_call": 2, "pool": 2, "kept_calls": 2, "warmup_calls": 1,
                                "traced_calls": 2}}
METRICS = ("mfu.depth_pro", "vit_roofline.depth_pro", "decoder_roofline.depth_pro", "decoder_conv_roofline.depth_pro",
           "decoder_passes_roofline.depth_pro")
DECODER_SPANS = ("depth_pro.upsample", "depth_pro.fusion", "depth_pro.head")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = small.copy(tmp_path_factory.mktemp("bench"), config={}, traffic=TRAFFIC)
    path = os.path.join(dest, "benchmark", "configs", "depth_pro_vitl16_bf16.json")
    cfg = harness.load_json(path)
    cfg.update({k: SMALL[k] for k in ("depth_pro", "input_tactile_image_size", "frame_size")})
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
    assert r["counts"]["frames_checked"] == 4
    # the depth follows the frame by far more than the rounding moves it
    assert r["counts"]["depth_spread_mm"] > 5 * r["counts"]["depth_rmse_mm"]


@pytest.mark.parametrize("fault", ["half_batch", "swapped_answer", "stale_input"])
def test_faults(root, fault):
    with faults.planted(fault):
        assert not run(root)["correct"]


@pytest.mark.parametrize("kind", ["transposed", "shifted"])
def test_mis_merged_controls(root, kind):
    assert not run(root, system=controls.CONTROLS[kind])["correct"]


def test_traced_run_reads_the_depth_pro_metrics(root):
    """On the CPU a traced run's slice has no device ops, so the readers
    read nothing; over made-up device ops (one a span) each reads what the
    spans and the yardstick give."""
    cell = harness.find_cell(WORKLOAD, root)
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert run(root, traced=True)["metrics"] == {}
    r = harness.load_module("loops", "closed_depth_pro", root).run(cell, 3, 0.05, True, torch.device("cpu"))
    names = [s.name for s in r.trace.spans]
    assert names.count(spans.CALL) == 2 and names.count("dpt.block") == 2 * 8
    assert names.count("depth_pro.fusion") == 2 * 5 and names.count("depth_pro.merge") == 2
    op_us = 10.0
    st = _with_device_ops(r.trace, op_us)
    ctx = {"config": cell.config, "traffic": cell.traffic,
           "peaks": yardstick.card_peaks("NVIDIA H100 80GB HBM3")}
    got = {m: harness.load_reader(m, root)(st, ctx) for m in METRICS}
    images = 2 * cell.traffic["dual_frames_per_call"]
    block_ms = op_us / 1e3 * (names.count("dpt.block") + names.count("dpt.attention") + names.count("dpt.mlp")) / 2
    # one op a span: the three decoder spans' own and their head.conv spans'
    decoder_ms = op_us / 1e3 * sum(any(st.within(i, s) for s in DECODER_SPANS) for i in range(len(st.spans))) / 2
    conv_ms = op_us / 1e3 * names.count("head.conv") / 2
    assert names.count("head.conv") == 2 * 50
    assert got["vit_roofline.depth_pro"] == pytest.approx(
        100 * yardstick_depth_pro.vit_bound_ms(cell.config, images, ctx["peaks"]) / block_ms)
    assert got["decoder_roofline.depth_pro"] == pytest.approx(
        100 * yardstick_depth_pro.decoder_bound_ms(cell.config, images, ctx["peaks"]) / decoder_ms)
    ops = yardstick_depth_pro.decoder_ops(cell.config, images)
    conv_bound = sum(op_ms(op, ctx["peaks"]) for op in ops if op.name.rsplit(".", 1)[-1] not in ELEMENTWISE)
    passes_bound = sum(op_ms(op, ctx["peaks"]) for op in ops if op.name.rsplit(".", 1)[-1] in ELEMENTWISE)
    assert got["decoder_conv_roofline.depth_pro"] == pytest.approx(100 * conv_bound / conv_ms)
    assert got["decoder_passes_roofline.depth_pro"] == pytest.approx(100 * passes_bound / (decoder_ms - conv_ms))
    assert got["mfu.depth_pro"] == pytest.approx(
        100 * yardstick_depth_pro.call_flops(cell.config, 2) * 2 / st.window_s / ctx["peaks"].bf16_flops)
