"""The DPT head's bilinear resize as one op (``ops/kernels/bilinear_resize.py``)
against the library's ``F.interpolate(..., mode="bilinear",
align_corners=True)`` it replaces, and the transformer that calls it.

On the CPU the op computes its twin, that library call, and the DPT must
serve what it served with the library call in its place, bit for bit. On
the card (``-m cuda``) the kernel is held to aten's ``F.interpolate`` at
the head's five sites bit for bit, and counts its launches in a DPT
serving call. That case is also the tripwire for a PyTorch upgrade: the
kernel copies the fused multiply-adds of aten's build (the source's
header), and a build that contracts otherwise fails it in float32.
"""

import json
import os

import pytest
import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.models import UNet
from gelslim_depth_tpu_torch.models import dpt as dpt_module
from gelslim_depth_tpu_torch.models.dpt import DPT, DPTConfig
from gelslim_depth_tpu_torch.ops.kernels import bilinear_resize as br

DTYPES = [torch.float32, torch.bfloat16]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_dpt.py's small widths: patch 14, 4 blocks of 64 and 4
# heads, features 16, reassembly (8, 16, 32, 32), a 28x42 input
SMALL_DPT = {"embed_dim": 64, "depth": 4, "num_heads": 4, "hooks": [0, 1, 2, 3], "features": 16,
             "out_channels": [8, 16, 32, 32]}


def library(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def _input(shape, dtype, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device) * 3
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


# (N, C, H, W) -> (Ho, Wo): upsampling by 2, by 4/3, by a ratio that is no
# simple fraction, from a 1-pixel input and to a 1-pixel output
RESIZES = {
    "2x": ((2, 16, 11, 15), (22, 30)),
    "4/3x": ((2, 8, 9, 12), (12, 16)),
    "non-integer": ((2, 12, 22, 30), (37, 53)),
    "1-pixel input": ((2, 8, 1, 1), (5, 7)),
    "1-pixel output": ((2, 8, 6, 9), (1, 1)),
}


# -- the op on the CPU ---------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("resize", list(RESIZES))
def test_twin_is_the_library_call(resize, dtype):
    shape, size = RESIZES[resize]
    x = _input(shape, dtype)
    before = br.bilinear_resize.launches
    got = br.bilinear_resize(x, size)
    want = library(x, size)
    assert br.bilinear_resize.launches == before  # the CPU launches nothing
    assert got.dtype == dtype and got.shape == (*shape[:2], *size) and got.stride() == want.stride()
    assert torch.equal(got, want) and torch.equal(br.bilinear_resize_reference(x, size), want)


@pytest.mark.parametrize("bad", ["3-D tensor", "int dtype", "zero size", "negative size", "one-element size"])
def test_wrapper_raises(bad):
    x = _input((1, 8, 4, 5), torch.float32)
    args = {
        "3-D tensor": (x[0], (8, 10)),
        "int dtype": (x.to(torch.int32), (8, 10)),
        "zero size": (x, (0, 10)),
        "negative size": (x, (8, -1)),
        "one-element size": (x, (8,)),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        br.bilinear_resize(*args)


def _small_dpt(dtype, device="cpu"):
    torch.manual_seed(0)
    net = DPT(DPTConfig.from_dict({**SMALL_DPT, "image_size": (28, 42)}))
    net.load_state_dict(net.state_dict())  # folds the epilogues' vectors from the biases
    return net.to(device).to_compute_dtype(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_small_dpt_serves_what_the_library_call_served(dtype, monkeypatch):
    """The head's five resizes through the op serve, on the CPU, exactly
    what the head served with ``F.interpolate`` at those sites."""
    net = _small_dpt(dtype)
    x = torch.randn((4, 3, 28, 42), generator=torch.Generator().manual_seed(1))
    calls = []
    op = br.bilinear_resize

    def counted(t, size):
        calls.append((tuple(t.shape), tuple(size)))
        return op(t, size)

    with torch.no_grad(), monkeypatch.context() as m:
        m.setattr(dpt_module, "bilinear_resize", counted)
        got = net(x)
        m.setattr(dpt_module, "bilinear_resize", library)
        want = net(x)
    assert [s for _, s in calls] == [(2, 3), (4, 6), (8, 12), (16, 24), (28, 42)]
    assert torch.isfinite(got).all() and torch.equal(got, want)


# -- the kernel on the card ----------------------------------------------------

# the head's five sites at the flagship's widths and grids (N = 2 here; 128
# finger images in a serving call), and C = 12 for the channels that take
# no 16-B vector
CUDA_SITES = {
    "refinenet4": ((2, 256, 11, 15), (22, 30)),
    "refinenet3": ((2, 256, 22, 30), (44, 60)),
    "refinenet2": ((2, 256, 44, 60), (88, 120)),
    "refinenet1": ((2, 256, 88, 120), (176, 240)),
    "output": ((2, 128, 176, 240), (308, 420)),
    "c12": ((2, 12, 9, 11), (20, 31)),
}


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("site", list(CUDA_SITES))
def test_cuda_kernel_equals_aten(site, dtype):
    _needs_cuda()
    shape, size = CUDA_SITES[site]
    x = _input(shape, dtype, "cuda", seed=sum(shape))
    before = br.bilinear_resize.launches
    got = br.bilinear_resize(x, size)
    want = library(x, size)
    torch.cuda.synchronize()
    assert br.bilinear_resize.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    differ = int((got != want).sum())
    assert differ == 0, f"{differ} of {want.numel()} elements differ from aten's"


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take():
    _needs_cuda()
    x = _input((2, 16, 5, 7), torch.bfloat16, "cuda")
    with pytest.raises(ValueError, match="channels-last"):
        br.bilinear_resize(x.contiguous(), (9, 13))
    with pytest.raises(TypeError):
        br.bilinear_resize(x.half(), (9, 13))
    with pytest.raises(RuntimeError, match="no backward"):  # it would cut the graph
        br.bilinear_resize(x.requires_grad_(), (9, 13))
    with torch.no_grad():
        assert br.bilinear_resize(x, (9, 13)).shape == (2, 16, 9, 13)


def _config(model_type):
    with open(os.path.join(REPO, "benchmark", "configs", "dpt_vitl14_bf16.json")) as f:
        published = json.load(f)
    if model_type == "unet":
        return GelslimConfig(CNN_dimensions=(8, 16), input_tactile_image_size=(28, 42),
                             depth_normalization_parameters=(-1.9, 0.0))
    return GelslimConfig.from_json(json.dumps({**published, "dpt": {**published["dpt"], **SMALL_DPT},
                                               "input_tactile_image_size": [28, 42]}))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_dpt_serving_launches_five(dtype, monkeypatch):
    """One DPT serving call launches the kernel at its five sites and serves
    the depth the library call served there; a U-Net call launches none."""
    _needs_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.rand((2, 6, 32, 43), generator=g, device="cuda") * 255
    base = torch.rand((6, 32, 43), generator=g, device="cuda") * 255
    dpt_cfg, unet_cfg = _config("dpt"), _config("unet")
    torch.manual_seed(0)
    dpt_sd = DPT(dpt_cfg.dpt_config()).state_dict()
    unet_sd = UNet(unet_cfg.unet_config()).state_dict()
    for cfg, sd, want_launches in ((dpt_cfg, dpt_sd, 5), (unet_cfg, unet_sd, 0)):
        pred = Predictor(cfg, sd, compute_dtype=dtype)
        before = br.bilinear_resize.launches
        got = pred.predict_dual_frames(frames, base, (32, 43))
        torch.cuda.synchronize()
        assert br.bilinear_resize.launches - before == want_launches, cfg.model_type
        if want_launches:
            with monkeypatch.context() as m:
                m.setattr(dpt_module, "bilinear_resize", library)
                want = pred.predict_dual_frames(frames, base, (32, 43))
            torch.cuda.synchronize()
            assert br.bilinear_resize.launches - before == want_launches
            assert torch.isfinite(got).all() and torch.equal(got, want)
