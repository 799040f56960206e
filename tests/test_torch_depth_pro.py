"""The port's Depth Pro (``models/depth_pro.py``) and its serving through
``Predictor``, on the CPU at a small size, against the plain reference
``benchmark/reference/depth_pro.py`` on the benchmark's seeded weights and
frames (``benchmark/loops/closed_depth_pro.py``).

The small size keeps every mechanism of the published ``dinov2l16_384``
configuration: patch 16 on 128x128 tiles (an 8x8 grid, 65 tokens), so a
512x512 input tiles and merges as the published 1536x1536 does (merge
paddings 1 and 2 at the 8-grid for the published 3 and 6 at the 24-grid)
and the decoder's x16 returns it to 512x512; both encoders 4 blocks of
width 64 and 4 heads, hooks at blocks 1 and 2; reassembly widths (16, 32,
64, 64), decoder width 16, head width 8; 64x86 frames. The published
widths are checked on the meta device."""

import dataclasses
import importlib.util
import json
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, inputs, yardstick_depth_pro
from benchmark.loops import closed_depth_pro
from benchmark.reference import depth_pro as ref
from gelslim_depth_tpu_torch import ops
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.export import export_predictor
from gelslim_depth_tpu_torch.inference import Predictor, StreamingEngine, _preprocess, dual_frames_to_fingers
from gelslim_depth_tpu_torch.models import dpt as dpt_module
from gelslim_depth_tpu_torch.models.depth_pro import (
    SPLITS, DepthPro, DepthProConfig, depth_pro_state_shapes, merge, split_into,
)
from gelslim_depth_tpu_torch.models.dpt import DPT, _bias_relu
from gelslim_depth_tpu_torch.ops.kernels import conv_epilogue as ce
from gelslim_depth_tpu_torch.utils import profiling
from tests.torch_port_helpers import (
    card_route, conv_calls, previous_fusion_block, spy_epilogues, torch_threads,
)

PUBLISHED = harness.load_json(os.path.join(harness.ROOT, "benchmark", "configs", "depth_pro_vitl16_bf16.json"))
SMALL = {**PUBLISHED,
         "depth_pro": {**PUBLISHED["depth_pro"], "embed_dim": 64, "depth": 4, "num_heads": 4, "hooks": [1, 2],
                       "merge_padding": [1, 2], "dims_encoder": [16, 32, 64, 64], "decoder_features": 16,
                       "head_features": 8},
         "input_tactile_image_size": [512, 512], "frame_size": [64, 86]}
N = 2  # dual frames: 4 finger images, 144 encoder sequences
FRAME = tuple(SMALL["frame_size"])

_spec = importlib.util.spec_from_file_location("depth_pro_controls", os.path.join(harness.ROOT, "scripts",
                                                                                  "depth_pro_controls.py"))
controls = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(controls)


def rms(t: torch.Tensor) -> float:
    return float(t.float().pow(2).mean().sqrt())


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def bundle():
    sd = closed_depth_pro.weights(SMALL, inputs.generator("cpu", 5, inputs.WEIGHTS), "cpu")
    frames, base, _ = inputs.session(inputs.generator("cpu", 5, inputs.FRAMES), N, FRAME, "cpu")
    x = ref.network_input(SMALL, frames, base)  # left fingers first
    with torch.no_grad():
        want = ref.forward(SMALL, sd, x)
        want_bf16 = ref.forward(SMALL, sd, x, dtype=torch.bfloat16)
    return {"sd": sd, "frames": frames, "base": base, "x": x, "want": want, "want_bf16": want_bf16,
            "config": GelslimConfig.from_json(json.dumps(SMALL))}


def port(bundle, dtype=torch.float32) -> DepthPro:
    net = DepthPro(bundle["config"].depth_pro_config())
    net.load_state_dict(bundle["sd"])
    return net.to_compute_dtype(dtype)


# float32: the fused SDPA, LayerNorm, linear and conv kernels sum in
# another order than the reference's plain ops, and the 1x1 projections
# run as matrix products on the merged tokens; at these widths the
# outputs (scale ~0.7) then differ by ~7e-6. 1e-4 leaves 15x room and
# stays far below what a mis-merged tile or a missing block moves them,
# 0.05 and more (test_precision_check).
F32_ATOL = 1e-4


def test_float32_against_the_reference(bundle):
    with torch.no_grad():
        got = port(bundle)(bundle["x"])
    assert got.dtype == torch.float32 and got.shape == (2 * N, 1, 512, 512)
    torch.testing.assert_close(got, bundle["want"], rtol=0, atol=F32_ATOL)
    assert rms(bundle["want"] - bundle["want"].mean(dim=0)) > 100 * F32_ATOL  # the depth follows the frame


def test_bfloat16_against_the_reference(bundle):
    """As the DPT's: the bfloat16 port rounds where the reference's
    bfloat16 mode rounds, its kernels in other orders, so its error against
    the float32 reference is held to 1.5x the plain bfloat16 computation's
    own (they read within 1% of each other here), and to the reference's
    bfloat16 result within 2x that scale."""
    with torch.no_grad():
        got = port(bundle, torch.bfloat16)(bundle["x"])
    assert got.dtype == torch.float32
    scale = rms(bundle["want_bf16"] - bundle["want"])
    assert 0 < scale < 0.1 * rms(bundle["want"])
    assert rms(got - bundle["want"]) <= 1.5 * scale
    assert rms(got - bundle["want_bf16"]) <= 2.0 * scale


@pytest.mark.parametrize("change", ["transposed merge", "shifted merge", "no block 2 of the patch encoder",
                                    "no image encoder"])
def test_precision_check(bundle, change):
    """Tiles merged out of order or off their places, a block left out of
    the patch encoder, or the global view zeroed fail the float32
    tolerance, by 100x or more."""
    net = port(bundle)
    if change == "transposed merge":
        net.merge = controls.transposed_merge
    elif change == "shifted merge":
        net.merge = controls.shifted_merge
    elif change.startswith("no block"):
        net.encoder.patch_encoder.blocks[2].forward = (
            lambda x, h, backend, next_norm: (x, None if next_norm is None else next_norm(x)))
    else:
        net.encoder.image_encoder.forward = lambda x, raw=(): [torch.zeros(x.shape[0], 64, 64)]
    with torch.no_grad():
        got = net(bundle["x"])
    assert (got - bundle["want"]).abs().max() > 100 * F32_ATOL


@pytest.mark.parametrize("level", [0, 1])
def test_merge_of_the_split_is_the_map(level):
    """A per-cell map split into the level's overlapping tiles of 8 cells
    (5x5 at overlap 0.25, 3x3 at 0.5) and merged back with the level's
    padding (1, 2) is the map itself, bit for bit, in the port and in the
    reference; both merge the tiles alike."""
    steps, overlap = SPLITS[level]
    g, n, c = 8, 3, 5
    side = (4, 2)[level] * g
    padding = SMALL["depth_pro"]["merge_padding"][level]
    cells = torch.randn(n, c, side, side)
    tiles = torch.empty(steps * steps * n, c, g, g)
    split_into(tiles, cells, g, overlap)
    torch.testing.assert_close(tiles, ref.split(cells, g, overlap), rtol=0, atol=0)
    merged = merge(tiles.permute(0, 2, 3, 1).contiguous(), n, steps, padding)
    assert torch.equal(merged, cells.permute(0, 2, 3, 1))
    assert torch.equal(ref.merge(tiles, n, padding), cells)


def test_pyramid_and_split_match_the_library(bundle):
    """The tiles of the pyramid: x's 5x5 at stride 96, then
    ``F.interpolate``'s half of x in 3x3 at stride 64, then its quarter,
    each cut from the float32 level and rounded once."""
    net = port(bundle, torch.bfloat16)
    x = bundle["x"]
    n = x.shape[0]
    tiles = net._tiles(x)
    assert tiles.shape == (35 * n, 3, 128, 128) and tiles.dtype == torch.bfloat16
    half = F.interpolate(x, scale_factor=0.5, mode="bilinear", align_corners=False)
    quarter = F.interpolate(x, scale_factor=0.25, mode="bilinear", align_corners=False)
    assert torch.equal(tiles[:25 * n], ref.split(x, 128, 0.25).bfloat16())
    assert torch.equal(tiles[6 * n:7 * n], x[..., 96:224, 96:224].bfloat16())  # row 1, column 1 of x's tiles
    assert torch.equal(tiles[25 * n:34 * n], ref.split(half, 128, 0.5).bfloat16())
    assert torch.equal(tiles[34 * n:], quarter.bfloat16())


def test_front_end_upsamples_as_the_library(bundle):
    """The composed front end's bilinear resize of the 64x86 difference
    images to 512x512 is ``F.interpolate(mode="bilinear",
    align_corners=False)``: upsampling, its weights are the same triangle
    at half-pixel centres (edges clamped), each a float32 rounding of
    another formula, so the two differ by ~1e-5 of the 0-255 input."""
    cfg = bundle["config"]
    fingers = dual_frames_to_fingers(cfg, bundle["frames"], bundle["base"])
    got = ops.resize(fingers, (512, 512), cfg.interp_method)
    want = F.interpolate(fingers, size=(512, 512), mode="bilinear", align_corners=False)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    x = _preprocess(cfg, fingers)
    torch.testing.assert_close(x, (want - 127.5) / 127.5, rtol=0, atol=1e-5)


def test_predictor_serves_the_reference_chain(bundle):
    """``Predictor.predict_dual_frames``: the composed front end, Depth Pro
    and the area post, against the reference chain in mm (2.13 mm a
    normalized unit), in float32 and in bfloat16."""
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    assert isinstance(pred.net, DepthPro) and pred.unet_cfg is None
    got = pred.predict_dual_frames(bundle["frames"], bundle["base"], FRAME)
    want = ref.predict(SMALL, bundle["sd"], bundle["frames"], bundle["base"])
    assert got.shape == (N, 2, *FRAME)
    torch.testing.assert_close(got, want, rtol=0, atol=3 * F32_ATOL)
    bf16 = Predictor(bundle["config"], bundle["sd"], compute_dtype=torch.bfloat16, device="cpu")
    got_bf16 = bf16.predict_dual_frames(bundle["frames"], bundle["base"], FRAME)
    scale = rms(ref.predict(SMALL, bundle["sd"], bundle["frames"], bundle["base"], dtype=torch.bfloat16) - want)
    assert rms(got_bf16 - want) <= 1.5 * scale


def test_paths_that_serve_frames_alone_refuse_it(bundle, tmp_path):
    """``quantize``, the ``StreamingEngine`` and ``export_predictor`` refuse
    a Depth Pro configuration, naming it."""
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    for what, attempt in (
            ("quantize", lambda: pred.quantize(bundle["frames"], bundle["base"])),
            ("StreamingEngine", lambda: StreamingEngine(pred, FRAME, base_frame=bundle["base"])),
            ("export_predictor", lambda: export_predictor(pred, FRAME, path=str(tmp_path / "m.gsx"), batch_sizes=(1,),
                                                          frame_size=FRAME))):
        with pytest.raises(ValueError, match=f"{what} does not take a Depth Pro configuration"):
            attempt()


def test_spans_nest_and_the_counters_count(bundle):
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    tiles, calls = DepthPro.tiles, dict(DPT.attention_calls)
    with profiling.recording() as spans:
        pred.predict_dual_frames(bundle["frames"], bundle["base"], FRAME)
    assert DepthPro.tiles - tiles == 36 * 2 * N
    assert DPT.attention_calls["FLASH_ATTENTION"] - calls.get("FLASH_ATTENTION", 0) == 2 * 4

    def parent(s):
        p = spans[s].parent
        return None if p is None else spans[p].name

    names = [(s.name, s.site, parent(i)) for i, s in enumerate(spans)]
    top = [(name, site) for name, site, p in names if p == "serve.unet"]
    assert top == [("depth_pro.pyramid", None), ("depth_pro.patch_encoder", None), ("depth_pro.image_encoder", None),
                   ("depth_pro.merge", None), ("depth_pro.upsample", None)] + [
        ("depth_pro.fusion", f"level{i}") for i in range(4, -1, -1)] + [("depth_pro.head", None)]
    blocks = [p for name, _, p in names if name == "dpt.block"]
    assert blocks == ["depth_pro.patch_encoder"] * 4 + ["depth_pro.image_encoder"] * 4


def test_published_widths_on_the_meta_device():
    cfg = GelslimConfig(model_type="depth_pro", depth_pro=PUBLISHED["depth_pro"],
                        input_tactile_image_size=(1536, 1536))
    dcfg = cfg.depth_pro_config()
    assert (dcfg.tile, dcfg.grid) == (384, 24) and dcfg.vit().grid == (24, 24)
    shapes = depth_pro_state_shapes(dcfg)
    assert shapes == {k: tuple(v) for k, v in ref.state_shapes(PUBLISHED).items()}
    assert shapes["encoder.patch_encoder.pos_embed"] == (1, 577, 1024)
    assert shapes["encoder.upsample_latent0.3.weight"] == (256, 256, 2, 2)
    assert shapes["decoder.convs.4.weight"] == (256, 1024, 3, 3) and "decoder.fusions.0.deconv.weight" not in shapes
    with torch.device("meta"):
        net = DepthPro(dcfg)
    params = sum(p.numel() for p in net.parameters())
    print(f"Depth Pro at the published widths: {params:,} parameters")
    assert 647e6 < params < 649e6
    vit = sum(p.numel() for p in net.encoder.patch_encoder.parameters())
    assert 303e6 < vit < 305e6


def test_yardstick_at_the_published_size():
    """The cell's arithmetic, counted by hand from the layer equations: one
    ViT pass 382.13 GFLOP, 36 a finger image 13.757 TFLOP; the upsample
    blocks 0.209, the decoder 4.300, the head 0.599; 18.865 TFLOP a finger
    image, 301.8 a call of 8 dual frames."""
    cfg = PUBLISHED
    parts = yardstick_depth_pro.image_flops(cfg)
    assert parts["encoders"] / 36 == pytest.approx(382.13e9, rel=1e-4)
    assert parts["encoders"] == pytest.approx(13.757e12, rel=1e-4)
    assert parts["upsample"] == pytest.approx(0.209e12, rel=2e-3)
    assert parts["decoder"] == pytest.approx(4.300e12, rel=1e-3)
    assert parts["head"] == pytest.approx(0.599e12, rel=1e-3)
    assert sum(parts.values()) == pytest.approx(18.865e12, rel=1e-4)
    assert yardstick_depth_pro.call_flops(cfg, 8) == pytest.approx(301.8e12, rel=1e-3)


def test_config_round_trip(bundle, tmp_path):
    cfg = bundle["config"]
    assert isinstance(cfg.depth_pro, DepthProConfig) and cfg.depth_pro.merge_padding == (1, 2)
    assert (cfg.interp_method, cfg.post_interp_method) == ("bilinear", "area")
    cfg.save_json(str(tmp_path / "c.json"))
    assert GelslimConfig.from_json(str(tmp_path / "c.json")) == cfg
    assert GelslimConfig().post_interp_method == "area" and GelslimConfig().depth_pro is None
    with pytest.raises(ValueError, match="not square of four tiles"):
        dataclasses.replace(cfg.depth_pro_config(), image_size=(512, 500)).tile


# -- the decoder's and head's conv biases in conv_epilogue ---------------------------


def _previous_head(net, f):
    """The head as it ran before its convs' biases went into
    ``conv_epilogue``: each conv with its bias."""
    h = net.head
    y = F.conv2d(f, h[0].weight, h[0].bias, padding=1)
    y = F.conv_transpose2d(y, h[1].weight, h[1].bias, stride=2)
    y = _bias_relu(F.conv2d(y, h[2].weight, padding=1), net.head_out_scale, net.head_out_shift)
    return F.conv2d(y, h[4].weight, h[4].bias).float()


def _forward_with_fusions(net, x):
    """net(x), and each fusion block's (inputs, output), level 4 first."""
    calls = []
    hooks = [m.register_forward_hook(lambda m, args, out: calls.append((m, args, out)))
             for m in net.decoder.fusions]
    try:
        out = net(x)
    finally:
        for h in hooks:
            h.remove()
    return out, calls


# as the DPT's (test_torch_dpt.PREVIOUS_ATOL): float32 on the CPU, whose
# conv may add its bias inside the conv
PREVIOUS_ATOL = 2e-6


def test_decoder_and_head_equal_the_previous_composition(bundle, monkeypatch):
    """With the biases in ``conv_epilogue``, the card's route, each fusion
    block (levels 1-4 with the transposed conv) and the head give, on the
    same inputs, what their convs with their biases and the adds after
    them gave."""
    card_route(monkeypatch)
    net = port(bundle)
    with torch.no_grad():
        got, fusions = _forward_with_fusions(net, bundle["x"])
        assert [m for m, _, _ in fusions] == [net.decoder.fusions[i] for i in range(4, -1, -1)]
        for m, args, out in fusions:
            want = previous_fusion_block(m, *args)
            assert out.stride() == want.stride()
            torch.testing.assert_close(out, want, rtol=0, atol=PREVIOUS_ATOL)
        want = _previous_head(net, fusions[-1][2])
    assert rms(want) > 100 * PREVIOUS_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=PREVIOUS_ATOL)


def test_decoder_and_head_convs_leave_their_bias_to_conv_epilogue(bundle, monkeypatch):
    """On the card's route no conv is run with its bias: ``conv_epilogue``
    adds each one, in its residual form at the 9 residual units' second
    convs (one at level 4, two at each other level), its BatchNorm form
    (relu) at their first convs and the head's conv to ``head_features``,
    its bias form at ``upsample_lowres``, the 5 ``out_conv`` and the head's
    other 3. On the CPU's own route those 18 convs take their bias."""
    net = port(bundle)
    forms = spy_epilogues(monkeypatch, dpt_module)
    with conv_calls() as calls, torch.no_grad():
        net(bundle["x"])
    assert sum(bias for _, bias in calls) == 9 + 9 and forms == {"bn": 10}
    card_route(monkeypatch)
    forms.clear()
    with conv_calls() as calls, torch.no_grad():
        got = net(bundle["x"])
    assert len(calls) > 2 * 9 + 5 + 4 and not any(bias for _, bias in calls)
    assert forms == {"residual": 9, "bn": 10, "bias": 9}
    torch.testing.assert_close(got, bundle["want"], rtol=0, atol=F32_ATOL)


@pytest.mark.cuda
def test_cuda_decoder_and_head_equal_aten_chain_bit_for_bit(bundle, monkeypatch):
    """On the card (cuDNN's convs, then PyTorch's own bias add): the bf16
    Depth Pro, whose convs take no bias there, serves the depth that the
    aten chain in ``conv_epilogue``'s place gives, bit for bit, its fusion
    blocks and head what the convs with their biases gave, and a forward
    launches the residual form 9 times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    net = DepthPro(bundle["config"].depth_pro_config())
    net.load_state_dict(bundle["sd"])
    net.to("cuda").to_compute_dtype(torch.bfloat16)
    x = bundle["x"].cuda()
    with torch.no_grad():
        before = ce.conv_epilogue.residual_launches
        with conv_calls() as calls:
            got, fusions = _forward_with_fusions(net, x)
        torch.cuda.synchronize()
        assert ce.conv_epilogue.residual_launches - before == 9
        assert calls and not any(bias for _, bias in calls)
        for m, args, out in fusions:
            assert torch.equal(out, previous_fusion_block(m, *args))
        assert torch.equal(got, _previous_head(net, fusions[-1][2]))
        monkeypatch.setattr(dpt_module, "conv_epilogue", ce.conv_epilogue_reference)
        want = net(x)
    assert torch.isfinite(got).all() and torch.equal(got, want)
