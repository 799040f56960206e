"""The plain reference held against the port's plain path on the CPU, at
small dims: float32 serving, its bfloat16 computation against the port's
bfloat16 predictor, and the int8 scheme (the port's CPU int8 convs are
its exact plain twin). It checks the reference, not the port."""

import os
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, inputs, serving
from benchmark.reference import serving as ref_serving
from benchmark.tests import small

SMALL = small.CONFIG
CPU = torch.device("cpu")
CONFIG_OF = {"int8_batch64": "unet_bigdata_int8", "bf16_batch64": "unet_bigdata_bf16"}


@pytest.fixture(autouse=True)
def few_threads():
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)


def serving_case(workload, seed, **override):
    config = harness.load_json(os.path.join(harness.ROOT, "benchmark", "configs", f"{CONFIG_OF[workload]}.json"))
    cell = SimpleNamespace(config={**config, **SMALL, **override})
    frames, base, _ = inputs.session(inputs.generator(CPU, seed, inputs.FRAMES), 8, tuple(SMALL["frame_size"]), CPU)
    sd = inputs.serving_weights(cell.config, inputs.generator(CPU, seed, inputs.WEIGHTS), CPU)
    return cell, frames[:4], frames[4:], base, sd


def rmse(a, b):
    return float(torch.sqrt(torch.mean(torch.square(a - b))))


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_float32_serving(seed):
    cell, frames, calib, base, sd = serving_case("int8_batch64", seed, precision="f32", compute_dtype="float32")
    got = serving.serving_system(cell, sd, calib, base, CPU).predict_dual_frames(frames, base, (32, 43))
    want = ref_serving.predict(cell.config, sd, frames, base)
    assert got.shape == want.shape == (4, 2, 32, 43)
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_int8_scheme(seed):
    """The port's int8 graph in a float32 compute dtype against the
    reference's fake quantization: the same scales, and depth apart by a
    few int8 steps that a float32 rounding flips, far less than int8 is
    from float32."""
    cell, frames, calib, base, sd = serving_case("int8_batch64", seed, compute_dtype="float32")
    qpred = serving.serving_system(cell, sd, calib, base, CPU)
    quant = ref_serving.calibrate(cell.config, sd, calib, base, 127)
    for site, scale in quant.act_scale.items():
        assert float(qpred.q.act_scale(site)) == pytest.approx(scale, rel=1e-6)
    got = qpred.predict_dual_frames(frames, base, (32, 43))
    want8 = ref_serving.predict(cell.config, sd, frames, base, quant)
    want32 = ref_serving.predict(cell.config, sd, frames, base)
    assert rmse(got, want8) < 0.25 * rmse(want8, want32)


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_bfloat16_scale(seed):
    """The reference computed in bfloat16 rounds where the port's bfloat16
    predictor does: the two are far closer to each other than either is to
    float32."""
    cell, frames, calib, base, sd = serving_case("bf16_batch64", seed)
    got = serving.serving_system(cell, sd, calib, base, CPU).predict_dual_frames(frames, base, (32, 43))
    want16 = ref_serving.predict(cell.config, sd, frames, base, dtype=torch.bfloat16)
    want32 = ref_serving.predict(cell.config, sd, frames, base)
    assert rmse(got, want16) < 0.6 * rmse(want16, want32)
    assert rmse(got, want32) == pytest.approx(rmse(want16, want32), rel=0.1)
