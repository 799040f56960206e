"""The yardstick's arithmetic against the figures the repository has
recorded for the flagship, and the trace reductions and per-layer readers
on made-up traces."""

import json
import os
from types import SimpleNamespace

import pytest

from benchmark import harness, trace, yardstick

ROOT = harness.ROOT
H100 = "NVIDIA H100 80GB HBM3"


def flagship():
    return harness.load_json(os.path.join(ROOT, "benchmark", "configs", "unet_bigdata_int8.json"))


def test_model_flops():
    cfg = flagship()
    assert yardstick.unet_conv_flops(cfg, (160, 213)) / 1e9 == pytest.approx(49.604, abs=5e-4)
    assert yardstick.call_flops(cfg, 64) == pytest.approx(64 * 2 * 49.60444416e9)


def test_train_step_flops():
    assert yardstick.train_step_flops(flagship(), 16) / 1e12 == pytest.approx(2.381, abs=5e-4)


def test_front_end_bytes():
    assert yardstick.preprocess_bytes(64, (320, 427), (160, 213)) == 265_505_280
    peaks = yardstick.card_peaks(H100)
    assert yardstick.preprocess_bound_ms(64, (320, 427), (160, 213), peaks) == pytest.approx(0.0793, abs=5e-5)


@pytest.mark.parametrize("dual_frames,bound_ms", [(64, 3.233), (1, 0.051)])
def test_conv_int8_bound(dual_frames, bound_ms):
    cfg = flagship()
    peaks = yardstick.card_peaks(H100)
    assert yardstick.conv_int8_bound_ms(cfg, 2 * dual_frames, (160, 213), peaks) == pytest.approx(bound_ms, abs=5e-4)


def test_int8_sites():
    sites = yardstick.int8_sites(flagship(), 2, (160, 213))
    assert len(sites) == 17
    assert [s.name for s in sites[:3]] == ["inc/conv2", "down_0/conv1", "down_0/conv2"]
    up0 = next(s for s in sites if s.name == "up_0/conv1")
    # the skip (20x26x512) and the unpadded upconv output (2 x (10x13) x 512)
    assert (up0.h, up0.w, up0.cin) == (20, 26, 1024)
    assert up0.in_elems == 2 * 20 * 26 * 512 + 2 * 20 * 26 * 512
    assert next(s for s in sites if s.name == "down_3/conv2").out_bytes_per_elem == 2


def test_card_peaks():
    assert yardstick.card_peaks(H100) == (3.35e12, 989e12, 1979e12)
    assert yardstick.card_peaks("NVIDIA H100 PCIe").bytes_per_s == 2.0e12
    assert yardstick.card_peaks(H100).compute("int8") == 1979e12
    with pytest.raises(KeyError):
        yardstick.card_peaks("NVIDIA A100-SXM4-80GB")


def fake_trace(device_ops, host_ops=(), units=1, window_s=1e-3):
    """A Trace over made-up events: (name, start us, end us[, thread])."""
    from torch.autograd import DeviceType

    def ev(op, kind):
        name, s, e, *th = op
        return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(start=s, end=e),
                               thread=th[0] if th else 1)

    events = [ev(o, DeviceType.CUDA) for o in device_ops] + [ev(o, DeviceType.CPU) for o in host_ops]
    return trace.Trace(SimpleNamespace(events=lambda: events), units, window_s)


def test_trace_busy_layers_and_gaps():
    t = fake_trace(
        [("void conv2d_int8_wgmma<64>", 0, 100), ("void at::native::elementwise_kernel<add>", 50, 150),
         ("fused_preprocess_dual_kernel", 300, 400), ("sm90_xmma_fprop_cudnn", 600, 700)],
        [("cudaStreamSynchronize", 140, 320), ("cudaLaunchKernel", 410, 420), ("aten::copy_", 400, 500),
         ("cudaLaunchKernel", 450, 460, 2)],
        units=2, window_s=1e-3)
    assert t.busy_s() == pytest.approx(350e-6)
    assert t.idle_pct() == pytest.approx(65.0)
    assert t.layer_ms_per_unit("conv2d_int8") == pytest.approx(0.05)
    assert t.layer_ms_per_unit("aten") == pytest.approx(0.05)
    assert t.layer_ms_per_unit("library") == pytest.approx(0.05)
    assert t.layer_ms_per_unit("fused_preprocess_dual") == pytest.approx(0.05)
    # gap 150-300 (mid 225) under the synchronize; 400-600 (mid 500): the copy
    # still runs at its end (500); the launches ended before
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"cudaStreamSynchronize": 150e-6, "aten::copy_": 200e-6})
    assert t.top_device_ops()[0][1] == pytest.approx(100e-6)


def test_trace_layers():
    assert trace.layer_of("void at::native::vectorized_elementwise_kernel<4, at::native::round_kernel_cuda>") == "aten"
    assert trace.layer_of("void cudnn::engines_precompiled::nchwToNhwcKernel<...>") == "library"
    assert trace.layer_of("Memcpy HtoD (Pageable -> Device)") == "library"


def spec_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("metric", [m["name"] for m in spec_metrics()["per_layer"]])
def test_readers(metric):
    """Every per-layer metric has a reader; on a slice without device ops
    it reads nothing, and on a slice with its kernels a share stays
    within 100%."""
    spec = spec_metrics()
    m = next(x for x in spec["per_layer"] if x["name"] == metric)
    cell = harness.find_cell(m["workloads"][0])
    read = harness.load_reader(metric)
    ctx = {"config": cell.config, "traffic": cell.traffic, "peaks": yardstick.card_peaks(H100)}
    assert read(fake_trace([], units=4, window_s=1.0), ctx) is None
    ops = [("void conv2d_int8_wgmma<64>", 0, 2e5), ("fused_preprocess_dual_kernel", 2e5, 3e5),
           ("void at::native::elementwise_kernel<add>", 3e5, 5e5)]
    value = read(fake_trace(ops, units=4, window_s=1.0), ctx)
    assert value is not None and value > 0
    if m["unit"] == "%":
        assert value <= 100.0
