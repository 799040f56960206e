"""The port's video depth model (``models/dpt.py`` with the temporal head:
Video Depth Anything) and its serving through ``Predictor``, on the CPU
at a small size, against the plain reference ``benchmark/reference/vda.py``
on the benchmark's seeded weights and clips
(``benchmark/loops/closed_vda.py``).

The small size keeps every mechanism of the published configuration: the
encoder of ``tests/test_torch_dpt.py`` (patch 14, 4 blocks of width 64
and 4 heads, every block hooked), features 32, reassembly widths (32, 32,
64, 64) so that GroupNorm's 32 groups divide every temporal width, 8
temporal heads, clips of 4 frames and 8 frames a finger (2 clips); a
56x84 input (a 4x6 grid of patches) from 64x86 frames, large enough that
the GroupNorm of ``layer_4``'s 2x3 map is not all rounding. The
published widths are checked on the meta device."""

import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from benchmark import harness, inputs
from benchmark.loops import closed_vda
from benchmark.reference import dpt as ref_dpt, vda as ref
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.export import export_predictor
from gelslim_depth_tpu_torch.inference import Predictor, StreamingEngine, fused_predict_dual
from gelslim_depth_tpu_torch.models.dpt import DPT, DPTConfig, dpt_state_shapes
from gelslim_depth_tpu_torch.utils import profiling
from tests.torch_port_helpers import torch_threads

PUBLISHED = harness.load_json(os.path.join(harness.ROOT, "benchmark", "configs", "vda_vitl14_bf16.json"))
SMALL = {**PUBLISHED,
         "dpt": {**PUBLISHED["dpt"], "embed_dim": 64, "depth": 4, "num_heads": 4, "hooks": [0, 1, 2, 3],
                 "features": 32, "out_channels": [32, 32, 64, 64], "num_frames": 4},
         "input_tactile_image_size": [56, 84], "frame_size": [64, 86]}
N = 8  # dual frames: 8 frames a finger, 2 clips of 4
FRAME = tuple(SMALL["frame_size"])


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(name, os.path.join(harness.ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


controls = _load("vda_controls", "scripts/vda_controls.py")


def rms(t: torch.Tensor) -> float:
    return float(t.float().pow(2).mean().sqrt())


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def bundle():
    sd = closed_vda.weights(SMALL, inputs.generator("cpu", 5, inputs.WEIGHTS), "cpu")
    frames, base = closed_vda.clip_session(inputs.generator("cpu", 5, inputs.FRAMES), N, 4, FRAME, "cpu")
    x = ref_dpt.network_input(SMALL, frames, base)  # left fingers first
    with torch.no_grad():
        want = ref.forward(SMALL, sd, x, 2)
        want_bf16 = ref.forward(SMALL, sd, x, 2, dtype=torch.bfloat16)
    return {"sd": sd, "frames": frames, "base": base, "x": x, "want": want, "want_bf16": want_bf16,
            "config": GelslimConfig.from_json(json.dumps(SMALL))}


def port(bundle, dtype=torch.float32) -> DPT:
    net = DPT(bundle["config"].dpt_config())
    net.load_state_dict(bundle["sd"])
    return net.to_compute_dtype(dtype)


# float32: as tests/test_torch_dpt.py's tolerance. The port and the
# reference differ by ~1e-5 here (scale ~0.5); leaving a temporal module
# out, reversing a clip, mixing the fingers or dropping the table moves
# the output by 0.1 and more (test_precision_check).
F32_ATOL = 1e-4


def test_float32_against_the_reference(bundle):
    with torch.no_grad():
        got = port(bundle)(bundle["x"], streams=2)
    assert got.dtype == torch.float32 and got.shape == (2 * N, 1, 56, 84)
    torch.testing.assert_close(got, bundle["want"], rtol=0, atol=F32_ATOL)
    assert rms(bundle["want"] - bundle["want"].mean(dim=0)) > 100 * F32_ATOL  # the depth follows the frame


def test_bfloat16_against_the_reference(bundle):
    """As the DPT's: the port's error against the float32 reference within
    1.5x the plain bfloat16 computation's own, and within 2x of it from
    the reference's bfloat16 result."""
    with torch.no_grad():
        got = port(bundle, torch.bfloat16)(bundle["x"], streams=2)
    assert got.dtype == torch.float32
    scale = rms(bundle["want_bf16"] - bundle["want"])
    assert 0 < scale < 0.1 * rms(bundle["want"])
    assert rms(got - bundle["want"]) <= 1.5 * scale
    assert rms(got - bundle["want_bf16"]) <= 2.0 * scale


def _reverse_clips(t):
    """Each 4-frame clip of both fingers' runs, in reverse order (its own
    inverse)."""
    return t.view(2, 2, 4, *t.shape[1:]).flip(2).reshape(t.shape)


def _interleave(t):
    return t.view(2, N, *t.shape[1:]).transpose(0, 1).reshape(t.shape)


def _deinterleave(t):
    return t.view(N, 2, *t.shape[1:]).transpose(0, 1).reshape(t.shape)


@pytest.mark.parametrize("change", ["no module layer3", "no module path3", "reversed frames",
                                    "interleaved fingers", "no positional table"])
def test_precision_check(bundle, change):
    """Each temporal control fails the float32 tolerance, by 100x or more."""
    net = port(bundle)
    x = bundle["x"]
    with torch.no_grad():
        if change.startswith("no module"):
            i = ("layer3", "layer4", "path4", "path3").index(change.split()[-1])
            net.depth_head.motion_modules[i].forward = lambda t, backend: t
            got = net(x, streams=2)
        elif change == "reversed frames":
            got = _reverse_clips(net(_reverse_clips(x), streams=2))
        elif change == "interleaved fingers":
            got = _deinterleave(net(_interleave(x), streams=1))
        else:
            for m in net.modules():
                if hasattr(m, "pe"):
                    m.pe.zero_()
            got = net(x, streams=2)
    assert (got - bundle["want"]).abs().max() > 100 * F32_ATOL


@pytest.mark.parametrize("use_kernel", [False, True])
def test_both_front_ends_serve_the_reference_clips(bundle, use_kernel):
    """``fused_predict_dual``'s composed front end (fingers interleaved as
    it makes them) and the kernel's layout (left fingers first; on the CPU
    the kernel's twin) both hand the network each finger's frames in time
    order, and serve the reference chain's depth."""
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    with torch.inference_mode():
        got = fused_predict_dual(pred.config, pred.net, bundle["frames"], bundle["base"], FRAME,
                                 use_kernel=use_kernel)
    want = ref.predict(SMALL, bundle["sd"], bundle["frames"], bundle["base"])
    assert got.shape == (N, 2, *FRAME)
    torch.testing.assert_close(got, want, rtol=0, atol=3 * F32_ATOL)
    if not use_kernel:
        torch.testing.assert_close(pred.predict_dual_frames(bundle["frames"], bundle["base"], FRAME), got,
                                   rtol=0, atol=0)
    else:  # the routes' float32 resize and normalization orders differ by ~1e-6 of the input
        with torch.inference_mode():
            composed = fused_predict_dual(pred.config, pred.net, bundle["frames"], bundle["base"], FRAME,
                                          use_kernel=False)
        torch.testing.assert_close(got, composed, rtol=0, atol=F32_ATOL)


def test_a_short_last_clip(bundle):
    """6 frames a finger: a clip of 4 and one of 2 that attends over its own
    frames, through both predict entry points."""
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    frames = bundle["frames"][:6]
    got = pred.predict_dual_frames(frames, bundle["base"], FRAME)
    torch.testing.assert_close(got, ref.predict(SMALL, bundle["sd"], frames, bundle["base"]), rtol=0,
                               atol=3 * F32_ATOL)
    images = bundle["frames"][:6, :3]  # one finger's frames, no difference image
    single = pred.predict_depth_from_RGB(images, FRAME)
    x = ref_dpt.network_input({**SMALL, "use_difference_image": False}, bundle["frames"][:6], bundle["base"])[:6]
    with torch.no_grad():
        logits = ref.forward(SMALL, bundle["sd"], x, 1)
    want = ref.ref_serving.depth_mm(SMALL, torch.cat([logits, logits]), 6)[:, 0]
    torch.testing.assert_close(single[:, 0], want, rtol=0, atol=3 * F32_ATOL)


def test_published_widths_on_the_meta_device():
    cfg = GelslimConfig(model_type="dpt", dpt=PUBLISHED["dpt"], input_tactile_image_size=(308, 420))
    dcfg = cfg.dpt_config()
    assert dcfg.temporal and dcfg.num_frames == 32 and dcfg.temporal_heads == 8
    shapes = dpt_state_shapes(dcfg)
    assert shapes == {k: tuple(v) for k, v in ref.state_shapes(PUBLISHED).items()}
    m = "depth_head.motion_modules"
    assert [shapes[f"{m}.{i}.temporal_transformer.proj_in.weight"] for i in range(4)] == [
        (1024, 1024), (1024, 1024), (256, 256), (256, 256)]
    blk = f"{m}.0.temporal_transformer.transformer_blocks.0"
    assert shapes[f"{blk}.ff.net.0.proj.weight"] == (8192, 1024) and shapes[f"{blk}.ff.net.2.weight"] == (1024, 4096)
    assert shapes[f"{blk}.attention_blocks.1.pos_encoder.pe"] == (1, 32, 1024)
    with torch.device("meta"):
        net = DPT(dcfg)
    params = sum(p.numel() for p in net.parameters())
    print(f"Video Depth Anything Large at the published widths: {params:,} parameters")
    assert 383e6 < params < 385e6
    per_frame = sum(p.numel() for k, p in net.named_parameters() if ".motion_modules." not in k)
    assert 334e6 < per_frame < 336e6


def test_spans_nest_and_the_counter_counts(bundle):
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    before = dict(DPT.temporal_attention_calls)
    with profiling.recording() as spans:
        pred.predict_dual_frames(bundle["frames"][:6], bundle["base"], FRAME)
    # two runs of clips (4, then 2): four modules, two attention blocks each
    assert DPT.temporal_attention_calls["FLASH_ATTENTION"] - before.get("FLASH_ATTENTION", 0) == 16

    def path(s):
        out = []
        while s is not None:
            out.append(spans[s].name)
            s = spans[s].parent
        return list(reversed(out))

    names = [(s.name, s.site, path(i)) for i, s in enumerate(spans)]
    head = ["serve.call", "serve.unet", "dpt.head"]
    temporal = [(site, p[:-1]) for name, site, p in names if name == "dpt.temporal"]
    assert temporal == [("layer3", head + ["dpt.reassemble"]), ("layer4", head + ["dpt.reassemble"]),
                        ("path4", head), ("path3", head)]
    attention = [(site, p[-2]) for name, site, p in names if name == "dpt.temporal_attention"]
    assert attention == [("0", "dpt.temporal"), ("1", "dpt.temporal")] * 8
    assert [p[-2] for name, _, p in names if name == "dpt.temporal_ff"] == ["dpt.temporal"] * 8


def test_paths_that_serve_frames_alone_refuse_it(bundle, tmp_path):
    """``quantize``, the ``StreamingEngine`` and ``export_predictor`` refuse
    a temporal configuration, naming it; the per-frame DPT's paths are as
    they were."""
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    with pytest.raises(ValueError, match="temporal configuration.*num_frames=4"):
        pred.quantize(bundle["frames"], bundle["base"])
    with pytest.raises(ValueError, match="StreamingEngine does not take a temporal configuration"):
        StreamingEngine(pred, FRAME, base_frame=bundle["base"])
    with pytest.raises(ValueError, match="export_predictor does not take a temporal configuration"):
        export_predictor(pred, FRAME, path=str(tmp_path / "m.gsx"), batch_sizes=(1,), frame_size=FRAME)
    per_frame = dataclasses.replace(bundle["config"], dpt=dataclasses.replace(bundle["config"].dpt, num_frames=0))
    sd = {k: v for k, v in bundle["sd"].items() if ".motion_modules." not in k}
    StreamingEngine(Predictor(per_frame, sd, device="cpu"), FRAME, base_frame=bundle["base"])


@pytest.mark.parametrize("kind", ["no_temporal", "reversed", "interleaved"])
def test_temporal_controls_serve_other_depth(bundle, kind):
    """``scripts/vda_controls.py``'s temporal controls, which the cell's
    limits are set against on the card, serve depth off the reference's."""
    cell = harness.Cell("vda", 1, SMALL, {}, [], [], {})
    system = controls.CONTROLS[kind](cell, bundle["sd"], None, bundle["base"], torch.device("cpu"))
    got = system.predict_dual_frames(bundle["frames"], bundle["base"], FRAME)
    want = ref.predict(SMALL, bundle["sd"], bundle["frames"], bundle["base"])
    assert got.shape == want.shape
    assert (got - want).abs().max() > 100 * F32_ATOL


def test_config_round_trip(bundle, tmp_path):
    cfg = bundle["config"]
    assert isinstance(cfg.dpt, DPTConfig) and cfg.dpt.num_frames == 4 and cfg.dpt.temporal_heads == 8
    cfg.save_json(str(tmp_path / "c.json"))
    assert GelslimConfig.from_json(str(tmp_path / "c.json")) == cfg
    assert not DPTConfig().temporal and DPTConfig().num_frames == 0
