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

from benchmark import harness, inputs
from benchmark.loops import closed_dpt
from benchmark.reference import dpt as ref
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.models import dpt as dpt_module
from gelslim_depth_tpu_torch.models.dpt import DPT, DPTConfig, dpt_state_shapes
from gelslim_depth_tpu_torch.utils import profiling
from tests.torch_port_helpers import torch_threads

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
