"""A ViT block's LayerScale residual add and the LayerNorm after it as one op
(``ops/kernels/residual_layer_norm.py``), against the ``torch.addcmul``
and ``F.layer_norm`` it replaces.

On the CPU the op computes its twin, that chain, bit for bit. On the card
(``-m cuda``) the kernel's ``x_new`` is held to aten's ``addcmul`` bit for
bit, and its ``y`` to aten's LayerNorm of that ``x_new`` within the
rounding that the statistics' summation order moves (the tolerances
below), at the serving shape (128 images of 661 tokens of 1024), at
ragged row counts and at other widths; and a DPT serving call launches it
2 x depth - 1 times.
"""

import json
import os

import pytest
import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.models.dpt import DPT
from gelslim_depth_tpu_torch.ops.kernels import residual_layer_norm as rln

DTYPES = [torch.float32, torch.bfloat16]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-6  # DINOv2's


def library(x, branch, gamma, weight, bias, eps=EPS):
    x_new = torch.addcmul(x, branch, gamma)
    return x_new, F.layer_norm(x_new, (x.shape[-1],), weight, bias, eps)


def _inputs(shape, dtype, device="cpu", seed=0):
    """x with a mean of its own a row, a branch, a LayerScale gamma near
    DINOv2's trained scale, weight near 1 and bias near 0."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=device)

    d = shape[-1]
    x = 2 * randn(*shape) + randn(*shape[:-1], 1)
    return tuple(t.to(dtype) for t in (x, randn(*shape), 0.1 * randn(d), 1 + 0.1 * randn(d), 0.1 * randn(d)))


# -- the op on the CPU ---------------------------------------------------------

# the encoder's rows of 1024 (2 images of 661 tokens) and a narrow row
# count that no block of warps divides
CPU_SHAPES = {"D 1024": (2, 661, 1024), "D 24, 37 rows": (37, 24)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", list(CPU_SHAPES))
def test_twin_is_the_library_chain(shape, dtype):
    args = _inputs(CPU_SHAPES[shape], dtype)
    before = rln.residual_layer_norm.launches
    got = rln.residual_layer_norm(*args, EPS)
    want = library(*args)
    assert rln.residual_layer_norm.launches == before  # the CPU launches nothing
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == args[0].shape
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(rln.residual_layer_norm_reference(*args, EPS), want))


def test_twin_takes_parameters_that_need_a_gradient_under_no_grad():
    x, branch, *params = _inputs((5, 16), torch.float32)
    params = [torch.nn.Parameter(p) for p in params]
    with torch.no_grad():
        got = rln.residual_layer_norm(x, branch, *params, EPS)
        want = library(x, branch, *params)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


REFUSALS = ["int dtype", "mixed dtypes", "D 12", "D 4096", "non-contiguous x", "branch shape", "gamma length",
            "needs a gradient"]


@pytest.mark.parametrize("bad", REFUSALS)
def test_wrapper_raises(bad):
    x, branch, gamma, weight, bias = _inputs((6, 16), torch.float32)
    args = {
        "int dtype": lambda: tuple(t.to(torch.int32) for t in (x, branch, gamma, weight, bias)),
        "mixed dtypes": lambda: (x, branch.to(torch.bfloat16), gamma, weight, bias),
        "D 12": lambda: _inputs((6, 12), torch.float32),
        "D 4096": lambda: _inputs((2, 4096), torch.float32),
        "non-contiguous x": lambda: (torch.cat([x, x], 1)[:, ::2], branch, gamma, weight, bias),
        "branch shape": lambda: (x, branch[:5], gamma, weight, bias),
        "gamma length": lambda: (x, branch, gamma[:8], weight, bias),
        "needs a gradient": lambda: (x.requires_grad_(), branch, gamma, weight, bias),
    }[bad]()
    with pytest.raises((TypeError, ValueError, RuntimeError)) as e:
        rln.residual_layer_norm(*args, EPS)
    assert (e.type is RuntimeError) == (bad == "needs a gradient")


# -- the kernel on the card ----------------------------------------------------

# (rows, D) and dtype: the serving shape, 128 finger images of 661 tokens;
# ragged row counts; D 24 (a vector of 8 in each of three lanes), 1536 (six
# vectors a lane, two lanes' last masked) and 2048, the most it takes
CUDA_CASES = {
    "serving bf16": ((128 * 661, 1024), torch.bfloat16),
    "ragged bf16": ((1003, 1024), torch.bfloat16),
    "ragged float32": ((1003, 1024), torch.float32),
    "D 24 bf16": ((77, 24), torch.bfloat16),
    "D 24 float32": ((77, 24), torch.float32),
    "D 1536 bf16": ((65, 1536), torch.bfloat16),
    "D 2048 float32": ((33, 2048), torch.float32),
}


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each |v| (8 significant bits), in float32."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def assert_y_close(y: torch.Tensor, want: torch.Tensor) -> None:
    """The kernel sums the mean and the variance in its own order (a lane's
    elements, then a butterfly across the warp); aten runs Welford's update.
    The float32 statistics then differ in their last bits, which moves the
    float32 value of y before its rounding by a few float32 ulps of the
    row's scale. In float32 that is held by rtol = atol = 1e-5 (|y| is at
    most ~8 here; a variance over D - 1 instead of D reads 5e-4 off). In
    bfloat16 the value rounds to aten's or to a neighbour: y is held within
    one bf16 ulp of aten's y, the ulp taken at 2^-10 at least (near 0, y is
    a small difference of weight * n and bias, and the two float32 values
    differ by ~1e-7 of the row's scale, not of y), and at most one element
    in a thousand may differ at all (a statistic off by 5e-4 moves ~1 in 8)."""
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        return
    diff = (y.float() - want.float()).abs()
    tol = bf16_ulp(torch.clamp(want.float().abs(), min=2.0 ** -10))
    assert bool((diff <= tol).all()), f"max |diff| over tolerance {float((diff / tol).max())} ulps"
    differ = int((diff > 0).sum())
    assert differ <= want.numel() // 1000, f"{differ} of {want.numel()} elements differ from aten's"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_kernel_against_aten(case):
    _needs_cuda()
    shape, dtype = CUDA_CASES[case]
    args = _inputs(shape, dtype, "cuda", seed=sum(shape))
    before = rln.residual_layer_norm.launches
    x_new, y = rln.residual_layer_norm(*args, EPS)
    want_x, _ = library(*args)
    want_y = F.layer_norm(x_new, (shape[-1],), args[3], args[4], EPS)
    torch.cuda.synchronize()
    assert rln.residual_layer_norm.launches == before + 1
    assert x_new.dtype == y.dtype == dtype and x_new.shape == y.shape == args[0].shape
    differ = int((x_new != want_x).sum())
    assert differ == 0, f"x_new: {differ} of {want_x.numel()} elements differ from addcmul's"
    assert_y_close(y, want_y)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take():
    _needs_cuda()
    x, branch, gamma, weight, bias = _inputs((6, 16), torch.bfloat16, "cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rln.residual_layer_norm(*(t.half() for t in (x, branch, gamma, weight, bias)), EPS)
    shifted = torch.empty(6 * 16 + 4, dtype=torch.bfloat16, device="cuda")[4:].view(6, 16)  # 8 B off
    with pytest.raises(ValueError, match="aligned"):
        rln.residual_layer_norm(shifted, branch, gamma, weight, bias, EPS)
    with pytest.raises(RuntimeError, match="no backward"):  # it would cut the graph
        rln.residual_layer_norm(x, branch, torch.nn.Parameter(gamma), weight, bias, EPS)
    with torch.no_grad():
        assert rln.residual_layer_norm(x, branch, torch.nn.Parameter(gamma), weight, bias, EPS)[1].shape == (6, 16)
    empty = torch.empty((0, 16), dtype=torch.bfloat16, device="cuda")
    before = rln.residual_layer_norm.launches
    assert rln.residual_layer_norm(empty, empty, gamma, weight, bias, EPS)[0].shape == (0, 16)
    assert rln.residual_layer_norm.launches == before


# tests/test_torch_dpt.py's small widths: 4 blocks of 64 and 4 heads
SMALL_DPT = {"embed_dim": 64, "depth": 4, "num_heads": 4, "hooks": [0, 1, 2, 3], "features": 16,
             "out_channels": [8, 16, 32, 32]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_dpt_serving_launches_two_a_block_but_one(dtype):
    """One DPT serving call launches the kernel 2 x depth - 1 times and
    serves finite depth."""
    _needs_cuda()
    with open(os.path.join(REPO, "benchmark", "configs", "dpt_vitl14_bf16.json")) as f:
        published = json.load(f)
    cfg = GelslimConfig.from_json(json.dumps({**published, "dpt": {**published["dpt"], **SMALL_DPT},
                                              "input_tactile_image_size": [28, 42]}))
    g = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.rand((2, 6, 32, 43), generator=g, device="cuda") * 255
    base = torch.rand((6, 32, 43), generator=g, device="cuda") * 255
    torch.manual_seed(0)
    pred = Predictor(cfg, DPT(cfg.dpt_config()).state_dict(), compute_dtype=dtype)
    before = rln.residual_layer_norm.launches
    got = pred.predict_dual_frames(frames, base, (32, 43))
    torch.cuda.synchronize()
    assert rln.residual_layer_norm.launches - before == 2 * SMALL_DPT["depth"] - 1
    assert got.shape == (2, 2, 32, 43) and bool(torch.isfinite(got).all())
