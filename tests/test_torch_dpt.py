"""The port's dense-prediction transformer (``models/dpt.py``) and its
serving through ``Predictor``, on the CPU at a small size, against the
plain reference ``benchmark/reference/dpt.py`` on the benchmark's seeded
weights (``benchmark/loops/closed_dpt.py::weights``).

The small size keeps every mechanism of the published ``vitl``
configuration: patch 14, 4 blocks of width 64 and 4 heads, every block
hooked, features 16, reassembly widths (8, 16, 32, 32), a 28x42 input
(a 2x3 grid of patches, 7 tokens) from 32x43 frames. The published
widths are checked on the meta device."""

import dataclasses
import json
import os

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark import harness, inputs
from benchmark.loops import closed_dpt
from benchmark.reference import dpt as ref
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.models import dpt as dpt_module
from gelslim_depth_tpu_torch.models.dpt import DPT, DPTConfig, FeatureFusionBlock, _bias_relu, dpt_state_shapes
from gelslim_depth_tpu_torch.ops.kernels import conv_epilogue as ce
from gelslim_depth_tpu_torch.utils import profiling
from tests.torch_port_helpers import (
    card_route, conv_calls, previous_fusion_block, previous_residual_unit, spy_epilogues, torch_threads,
)

PUBLISHED = harness.load_json(os.path.join(harness.ROOT, "benchmark", "configs", "dpt_vitl14_bf16.json"))
SMALL = {**PUBLISHED,
         "dpt": {**PUBLISHED["dpt"], "embed_dim": 64, "depth": 4, "num_heads": 4, "hooks": [0, 1, 2, 3],
                 "features": 16, "out_channels": [8, 16, 32, 32]},
         "input_tactile_image_size": [28, 42], "frame_size": [32, 43]}
N = 6  # dual frames: 12 finger images


def rms(t: torch.Tensor) -> float:
    return float(t.float().pow(2).mean().sqrt())


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def bundle():
    sd = closed_dpt.weights(SMALL, inputs.generator("cpu", 5, inputs.WEIGHTS), "cpu")
    frames, base, _ = inputs.session(inputs.generator("cpu", 5, inputs.FRAMES), N, tuple(SMALL["frame_size"]), "cpu")
    x = ref.network_input(SMALL, frames, base)
    with torch.no_grad():
        want = ref.forward(SMALL, sd, x)
        want_bf16 = ref.forward(SMALL, sd, x, dtype=torch.bfloat16)
    return {"sd": sd, "frames": frames, "base": base, "x": x, "want": want, "want_bf16": want_bf16,
            "config": GelslimConfig.from_json(json.dumps(SMALL))}


def port(bundle, dtype=torch.float32) -> DPT:
    net = DPT(bundle["config"].dpt_config())
    net.load_state_dict(bundle["sd"])
    return net.to_compute_dtype(dtype)


# float32: the fused SDPA, LayerNorm and linear kernels sum in another
# order than the reference's plain ops; at these widths the outputs (scale
# ~0.3) then differ by ~2e-6. 1e-4 leaves 50x room, and stays well below
# what an encoder in float16 (10 mantissa bits) moves them, ~1.8e-3, or a
# missing block or LayerScale, 0.2 and more (test_precision_check).
F32_ATOL = 1e-4


def test_float32_against_the_reference(bundle):
    with torch.no_grad():
        got = port(bundle)(bundle["x"])
    assert got.dtype == torch.float32 and got.shape == (2 * N, 1, 28, 42)
    torch.testing.assert_close(got, bundle["want"], rtol=0, atol=F32_ATOL)
    assert rms(bundle["want"] - bundle["want"].mean(dim=0)) > 100 * F32_ATOL  # the depth follows the frame


def test_bfloat16_against_the_reference(bundle):
    """The bfloat16 port rounds where the reference's bfloat16 mode rounds,
    but its fused kernels (flash attention's probabilities, the conv and
    linear kernels' own accumulation) round in other places and orders, so
    the two bfloat16 results are not bit for bit: the port's error against
    the float32 reference is held to 1.5x the plain bfloat16 computation's
    own (the two read within 5% of each other at this size), and the port
    to the reference's bfloat16 result within 2x that scale."""
    with torch.no_grad():
        got = port(bundle, torch.bfloat16)(bundle["x"])
    assert got.dtype == torch.float32
    scale = rms(bundle["want_bf16"] - bundle["want"])
    assert 0 < scale < 0.05
    assert rms(got - bundle["want"]) <= 1.5 * scale
    assert rms(got - bundle["want_bf16"]) <= 2.0 * scale


def _without_block(net, i):
    # a block's forward hands the next block its norm1 of the output
    net.pretrained.blocks[i].forward = lambda x, h, backend, next_norm: (x, None if next_norm is None else next_norm(x))
    return net


def _without_layer_scale(net, i):
    with torch.no_grad():
        net.pretrained.blocks[i].ls2.gamma.fill_(1.0)
    return net


@pytest.mark.parametrize("change", ["no block 2", "no LayerScale 1", "float16 encoder"])
def test_precision_check(bundle, change):
    """Leaving out a block or a LayerScale, or running the encoder in
    float16, fails the float32 tolerance, by 5x or more."""
    net = port(bundle)
    with torch.no_grad():
        if change == "float16 encoder":
            enc = net.pretrained.to(torch.float16)
            got = net.depth_head([h.float() for h in enc(bundle["x"].half())])
        else:
            net = _without_block(net, 2) if change == "no block 2" else _without_layer_scale(net, 1)
            got = net(bundle["x"])
    assert (got - bundle["want"]).abs().max() > 5 * F32_ATOL


def test_predictor_serves_the_reference_chain(bundle):
    """``Predictor.predict_dual_frames``: the composed front end (on the
    CPU; the kernel on the card), the DPT and the post, against the
    reference chain in mm; the front ends' float32 resize and
    normalization orders differ by ~1e-6 of the input, well inside the
    float32 tolerance scaled to mm (2.13 mm a normalized unit)."""
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    assert isinstance(pred.net, DPT) and pred.unet_cfg is None
    got = pred.predict_dual_frames(bundle["frames"], bundle["base"], tuple(SMALL["frame_size"]))
    want = ref.predict(SMALL, bundle["sd"], bundle["frames"], bundle["base"])
    assert got.shape == (N, 2, 32, 43)
    torch.testing.assert_close(got, want, rtol=0, atol=3 * F32_ATOL)
    bf16 = Predictor(bundle["config"], bundle["sd"], compute_dtype=torch.bfloat16, device="cpu")
    got_bf16 = bf16.predict_dual_frames(bundle["frames"], bundle["base"], tuple(SMALL["frame_size"]))
    scale = rms(ref.predict(SMALL, bundle["sd"], bundle["frames"], bundle["base"], dtype=torch.bfloat16) - want)
    assert rms(got_bf16 - want) <= 1.5 * scale


def test_attention_backend_counter(bundle):
    before = dict(DPT.attention_calls)
    with torch.no_grad():
        port(bundle)(bundle["x"][:2])
    assert DPT.attention_calls["FLASH_ATTENTION"] - before.get("FLASH_ATTENTION", 0) == 4
    assert set(DPT.attention_calls) == {"FLASH_ATTENTION"}


def test_published_widths_on_the_meta_device():
    cfg = GelslimConfig(model_type="dpt", dpt=PUBLISHED["dpt"], input_tactile_image_size=(308, 420))
    shapes = dpt_state_shapes(cfg.dpt_config())
    assert shapes == {k: tuple(v) for k, v in ref.state_shapes(PUBLISHED).items()}
    assert sum(k.endswith(".attn.qkv.weight") for k in shapes) == 24
    assert shapes["pretrained.blocks.23.mlp.fc1.weight"] == (4096, 1024)
    assert shapes["pretrained.pos_embed"] == (1, 1 + 22 * 30, 1024)
    assert [shapes[f"depth_head.projects.{i}.weight"] for i in range(4)] == [
        (256, 1024, 1, 1), (512, 1024, 1, 1), (1024, 1024, 1, 1), (1024, 1024, 1, 1)]
    assert [shapes[f"depth_head.scratch.layer{i}_rn.weight"][:2] for i in range(1, 5)] == [
        (256, 256), (256, 512), (256, 1024), (256, 1024)]
    assert 334e6 < sum(torch.Size(s).numel() for s in shapes.values()) < 336e6
    with torch.device("meta"), torch.no_grad():
        hooks = DPT(cfg.dpt_config()).pretrained(torch.empty(2, 3, 308, 420))
    assert [tuple(h.shape) for h in hooks] == [(2, 660, 1024)] * 4


def _spy_residual_norms(monkeypatch):
    """Records (gamma, weight) of every residual_layer_norm call the DPT
    makes, then runs the op."""
    calls = []
    op = dpt_module.residual_layer_norm

    def spy(x, branch, gamma, weight, bias, eps):
        calls.append((gamma, weight))
        return op(x, branch, gamma, weight, bias, eps)

    monkeypatch.setattr(dpt_module, "residual_layer_norm", spy)
    return calls


def test_residual_adds_run_with_the_norms_they_feed(bundle, monkeypatch):
    """Every residual add that a LayerNorm follows goes through
    ``residual_layer_norm``, with the parameters read live from the
    modules: block i's ls1 with its norm2, its ls2 with block i+1's norm1;
    the last block's ls2 add, which the hooks' norm follows, is an
    ``addcmul``. 2 x depth - 1 sites: 7 at the small depth 4, 47 at the
    published depth 24 (on the meta device). The served depth is the
    reference's, as test_float32_against_the_reference holds it."""
    net = port(bundle)
    calls = _spy_residual_norms(monkeypatch)
    with torch.no_grad():
        got = net(bundle["x"])
    blocks = net.pretrained.blocks
    want = []
    for i, b in enumerate(blocks):
        want.append((b.ls1.gamma, b.norm2.weight))
        if i + 1 < len(blocks):
            want.append((b.ls2.gamma, blocks[i + 1].norm1.weight))
    assert len(calls) == len(want) == 7
    assert all(g is wg and w is ww for (g, w), (wg, ww) in zip(calls, want))
    torch.testing.assert_close(got, bundle["want"], rtol=0, atol=F32_ATOL)
    calls.clear()
    cfg = GelslimConfig(model_type="dpt", dpt=PUBLISHED["dpt"], input_tactile_image_size=(308, 420))
    with torch.device("meta"), torch.no_grad():
        DPT(cfg.dpt_config()).pretrained(torch.empty(2, 3, 308, 420))
    assert len(calls) == 2 * 24 - 1 == 47


def test_spans_nest_under_serve_unet(bundle):
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    with profiling.recording() as spans:
        pred.predict_dual_frames(bundle["frames"][:1], bundle["base"], tuple(SMALL["frame_size"]))

    def path(s):
        out = []
        while s is not None:
            out.append(spans[s].name)
            s = spans[s].parent
        return list(reversed(out))

    names = [(s.name, s.site, path(i)) for i, s in enumerate(spans)]
    blocks = [site for name, site, _ in names if name == "dpt.block"]
    assert blocks == [str(i) for i in range(4)]
    within = {name: p[:-1] for name, _, p in names}
    unet = ["serve.call", "serve.unet"]
    assert within["dpt.encoder"] == unet and within["dpt.head"] == unet
    assert within["dpt.block"] == unet + ["dpt.encoder"]
    assert within["dpt.attention"] == within["dpt.mlp"] == unet + ["dpt.encoder", "dpt.block"]
    for name in ("dpt.reassemble", "dpt.fusion", "dpt.output"):
        assert within[name] == unet + ["dpt.head"]
    assert [site for name, site, _ in names if name == "dpt.fusion"] == [f"refinenet{i}" for i in (4, 3, 2, 1)]
    assert sum(name == "dpt.attention" for name, _, _ in names) == 4


def test_unet_paths_refuse_a_dpt_config(bundle, tmp_path):
    pred = Predictor(bundle["config"], bundle["sd"], device="cpu")
    with pytest.raises(ValueError, match="U-Net"):
        pred.quantize(bundle["frames"], bundle["base"])
    with pytest.raises(ValueError, match="U-Net"):
        Predictor.from_torch_checkpoint(str(tmp_path / "none.pth"), bundle["config"], device="cpu")
    with pytest.raises(ValueError, match="model_type"):
        Predictor(dataclasses.replace(bundle["config"], model_type="vit"), bundle["sd"], device="cpu")


def test_config_round_trip(bundle, tmp_path):
    cfg = bundle["config"]
    assert isinstance(cfg.dpt, DPTConfig) and cfg.dpt_config().grid == (2, 3)
    cfg.save_json(str(tmp_path / "c.json"))
    assert GelslimConfig.from_json(str(tmp_path / "c.json")) == cfg
    cfg.emit_python_config(str(tmp_path / "config_c.py"))
    assert GelslimConfig.from_python_module(str(tmp_path / "config_c.py")).dpt == cfg.dpt
    assert json.loads(GelslimConfig().to_json())["dpt"] is None and GelslimConfig().dpt is None
    with pytest.raises(ValueError):
        GelslimConfig().dpt_config()


# -- the head's conv biases in conv_epilogue -------------------------------------


def _previous_head(head, hooks):
    """``DPTHead.forward`` (per frame) as it ran before its convs' biases
    went into ``conv_epilogue``: each conv with its bias, each residual
    unit's skip add after its second conv."""
    cfg, s = head.cfg, head.scratch
    n = hooks[0].shape[0]
    gh, gw = cfg.grid
    maps = []
    for i, (t, proj, resize) in enumerate(zip(hooks, head.projects, head.resize_layers), 1):
        y = F.linear(t, proj.weight.flatten(1), proj.bias).view(n, gh, gw, -1).permute(0, 3, 1, 2)
        if isinstance(resize, nn.ConvTranspose2d):
            y = F.conv_transpose2d(y, resize.weight, resize.bias, stride=resize.stride)
        elif isinstance(resize, nn.Conv2d):
            y = F.conv2d(y, resize.weight, resize.bias, stride=2, padding=1)
        maps.append(F.conv2d(y, getattr(s, f"layer{i}_rn").weight, padding=1))
    l1, l2, l3, l4 = maps
    path = previous_fusion_block(s.refinenet4, l4, None, l3.shape[2:])
    path = previous_fusion_block(s.refinenet3, path, l3, l2.shape[2:])
    path = previous_fusion_block(s.refinenet2, path, l2, l1.shape[2:])
    path = previous_fusion_block(s.refinenet1, path, l1, (2 * l1.shape[2], 2 * l1.shape[3]))
    p = cfg.patch_size
    y = F.conv2d(path, s.output_conv1.weight, s.output_conv1.bias, padding=1)
    y = dpt_module.bilinear_resize(y, (gh * p, gw * p))
    y = _bias_relu(F.conv2d(y, s.output_conv2[0].weight, padding=1), s.output_scale, s.output_shift)
    return F.conv2d(y, s.output_conv2[2].weight, s.output_conv2[2].bias).float()


def _map(g, shape, device="cpu"):
    return torch.randn(shape, generator=g).to(device).contiguous(memory_format=torch.channels_last)


# float32 on the CPU, whose conv may add its bias inside the conv (oneDNN's
# can), where the two compositions round the bias add apart by a float32
# rounding; 2e-6 is ~1/1000 of the outputs' scale (they agree exactly
# where the conv adds its bias apart)
PREVIOUS_ATOL = 2e-6


@pytest.mark.parametrize("module", ["ResidualConvUnit", "FeatureFusionBlock", "FeatureFusionBlock with deconv",
                                    "DPTHead"])
def test_head_modules_equal_the_previous_composition(bundle, module, monkeypatch):
    """With the biases in ``conv_epilogue`` (a residual unit's second conv's
    with its skip add), the card's route, each module gives what its convs
    with their biases and the adds after them gave."""
    card_route(monkeypatch)
    net = port(bundle)
    g = torch.Generator().manual_seed(17)
    block = net.depth_head.scratch.refinenet2
    x, skip = _map(g, (2, 16, 6, 9)), _map(g, (2, 16, 6, 9))
    with torch.no_grad():
        if module == "ResidualConvUnit":
            got, want = block.resConfUnit1(x), previous_residual_unit(block.resConfUnit1, x)
        elif module == "FeatureFusionBlock":
            got, want = block(x, skip, (12, 18)), previous_fusion_block(block, x, skip, (12, 18))
        elif module == "FeatureFusionBlock with deconv":
            torch.manual_seed(17)
            block = FeatureFusionBlock(16, deconv=True)
            got, want = block(x, skip), previous_fusion_block(block, x, skip)
        else:
            hooks = net.pretrained(bundle["x"])
            got, want = net.depth_head(hooks), _previous_head(net.depth_head, hooks)
    assert got.shape == want.shape and got.stride() == want.stride()
    assert rms(want) > 1000 * PREVIOUS_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=PREVIOUS_ATOL)


def test_head_convs_leave_their_bias_to_conv_epilogue(bundle, monkeypatch):
    """On the card's route no head conv is run with its bias:
    ``conv_epilogue`` adds each one, in its residual form at the 7 residual
    units' second convs (one unit in refinenet4, two in each other), its
    BatchNorm form (relu) at their first convs and the ``head_features``
    conv, its bias form at the other 9 (3 resize convs, 4 ``out_conv``,
    ``output_conv1``, the last 1x1). The depth is the reference's, as
    test_float32_against_the_reference holds it."""
    card_route(monkeypatch)
    net = port(bundle)
    forms = spy_epilogues(monkeypatch, dpt_module)
    with conv_calls() as calls, torch.no_grad():
        got = net(bundle["x"])
    assert len(calls) == 4 + 3 + 2 * 7 + 4 + 3
    assert not any(bias for _, bias in calls)
    assert forms == {"residual": 7, "bn": 8, "bias": 9}
    torch.testing.assert_close(got, bundle["want"], rtol=0, atol=F32_ATOL)


def test_cpu_head_convs_keep_their_bias(bundle, monkeypatch):
    """On the CPU the 16 convs with a bias that feeds no ReLU take it (the
    CPU's conv adds it before it rounds, where a bfloat16 add after it
    would round twice), and aten adds the residual units' skips;
    ``conv_epilogue`` runs only where a ReLU follows (8)."""
    net = port(bundle, torch.bfloat16)
    forms = spy_epilogues(monkeypatch, dpt_module)
    with conv_calls() as calls, torch.no_grad():
        net(bundle["x"])
    assert len(calls) == 4 + 3 + 2 * 7 + 4 + 3
    assert sum(bias for _, bias in calls) == 7 + 9
    assert forms == {"bn": 8}


@pytest.mark.cuda
def test_cuda_head_equals_aten_chain_bit_for_bit(bundle, monkeypatch):
    """On the card PyTorch runs a conv with a bias as cuDNN's conv, then
    its own bias add: the bf16 DPT, whose head convs take no bias there,
    serves the depth that the aten chain in ``conv_epilogue``'s place
    gives, bit for bit, its head what the convs with their biases gave, and
    a forward launches the residual form 7 times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    net = DPT(bundle["config"].dpt_config())
    net.load_state_dict(bundle["sd"])
    net.to("cuda").to_compute_dtype(torch.bfloat16)
    x = bundle["x"].cuda()
    with torch.no_grad():
        before = ce.conv_epilogue.residual_launches
        with conv_calls() as calls:
            got = net(x)
        torch.cuda.synchronize()
        assert ce.conv_epilogue.residual_launches - before == 7
        assert len(calls) == 4 + 3 + 2 * 7 + 4 + 3 and not any(bias for _, bias in calls)
        hooks = net.pretrained(x.bfloat16())
        assert torch.equal(net.depth_head(hooks), _previous_head(net.depth_head, hooks))
        monkeypatch.setattr(dpt_module, "conv_epilogue", ce.conv_epilogue_reference)
        want = net(x)
    assert torch.isfinite(got).all() and torch.equal(got, want)
