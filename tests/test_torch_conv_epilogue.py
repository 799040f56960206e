"""The float convs' epilogue as one op (``ops/kernels/conv_epilogue.py``:
bias or folded BatchNorm, activation, rounding to the compute dtype, int8
quantization) against the chain of aten ops it replaces, and the U-Net's
two serving graphs that call it.

Bar: ``torch.equal`` everywhere. On the CPU the op computes that chain op
for op, and the forwards must not move by a single bit. On the card
(``-m cuda``) the kernel is held to its plain twin bit for bit at the
flagship's shapes, and the flagship's served depth, bf16 and int8, to the
same predictors with the twin in the kernel's place.
"""

import importlib.util
import io
import os
import zipfile
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.export import export_predictor
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.models import UNet, UNetConfig
from gelslim_depth_tpu_torch.models import quantize as pq
from gelslim_depth_tpu_torch.models import unet as unet_module
from gelslim_depth_tpu_torch.models.unet import Activation, full_precision
from gelslim_depth_tpu_torch.ops.kernels import conv_epilogue as ce
from gelslim_depth_tpu_torch.ops.kernels.conv_int8 import ACTIVATIONS, quant_act
from gelslim_depth_tpu_torch.utils import profiling

_spec = importlib.util.spec_from_file_location(
    "torch_fixture", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixture.py"))
_fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixture)

DTYPES = [torch.float32, torch.bfloat16]
DIMS = (8, 16, 32)


def _nhwc(v):
    return v.permute(0, 2, 3, 1).contiguous()


def aten_chain(y, *, bias=None, bn_mul=None, bn_add=None, act="none", q_scale=None):
    """The passes the U-Net ran before the op, written out: a DoubleConv's
    ``act(y * bn_scale + bn_shift).to(dtype)`` with (1, C, 1, 1) buffers,
    or an upconv's ``y + bias`` with the bias in the compute dtype, then
    the int8 graph's ``quant_act`` of the NHWC result."""
    c = (1, -1, 1, 1)
    if bias is not None:
        v = y + bias.view(c)
    else:
        v = Activation(act)(y * bn_mul.view(c) + bn_add.view(c)).to(y.dtype)
    return v if q_scale is None else quant_act(_nhwc(v), q_scale)


def _inputs(g, shape, dtype, layout, mode, device="cpu"):
    """y from a conv-like spread, the layout asked; the bias in the compute
    dtype as the U-Net stores it; BN vectors as folded ones."""
    n, c, h, w = shape
    y = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    if layout == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last)
    vec = lambda lo, hi: torch.rand(c, generator=g, device=device) * (hi - lo) + lo  # noqa: E731
    if mode == "bias":
        return y, dict(bias=vec(-1, 1).to(dtype))
    return y, dict(bn_mul=vec(0.2, 1.8), bn_add=vec(-0.5, 0.5))


# -- the op on the CPU ---------------------------------------------------------


# the two forms the U-Net calls: an upconv's bias with no activation, a
# BatchNorm with its activation; and the pairings it never calls
FORMS = [("bias", "none")] + [("bn", a) for a in ACTIVATIONS if a != "none"]
OTHER_FORMS = [("bias", a) for a in ACTIVATIONS if a != "none"] + [("bn", "none")]


@pytest.mark.parametrize("mode,act", FORMS)
@pytest.mark.parametrize("out", ["float", "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_cpu_op_equals_aten_chain(layout, dtype, out, mode, act):
    g = torch.Generator().manual_seed(zlib.crc32(f"{layout} {dtype} {out} {mode} {act}".encode()))
    y, kw = _inputs(g, (2, 16, 7, 13), dtype, layout, mode)
    q = dict(q_scale=torch.tensor(0.021)) if out == "int8" else {}
    got = ce.conv_epilogue(y, act=act, **kw, **q)
    want = aten_chain(y, act=act, **kw, **q)
    assert got.dtype == want.dtype and got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(got, want)
    if out == "int8":
        assert got.shape == (2, 7, 13, 16) and got.is_contiguous()
        assert got.min() >= -127 and got.max() <= 127
    else:
        assert got.dtype == dtype and got.stride() == y.stride()


@pytest.mark.parametrize("mode,act", OTHER_FORMS)
@pytest.mark.parametrize("out", ["float", "int8"])
def test_cpu_op_rejects_the_forms_the_unet_does_not_call(out, mode, act):
    g = torch.Generator().manual_seed(zlib.crc32(f"{out} {mode} {act}".encode()))
    y, kw = _inputs(g, (2, 16, 7, 13), torch.bfloat16, "nchw", mode)
    q = dict(q_scale=torch.tensor(0.021)) if out == "int8" else {}
    with pytest.raises(ValueError, match="takes"):
        ce.conv_epilogue(y, act=act, **kw, **q)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_int8_rounds_half_to_even_and_saturates(dtype):
    """v / s lands on every half step and beyond +-127: ties go to the even
    integer, and both ends clamp, as quant_act does."""
    s = torch.tensor(0.25)
    steps = torch.arange(-140, 141, dtype=torch.float32) * 0.5  # v / s = steps: ties at odd halves
    y = (steps * 0.25).to(dtype).view(1, 1, 1, -1).repeat(1, 8, 1, 1)
    kw = dict(bias=torch.zeros(8, dtype=dtype))
    got = ce.conv_epilogue(y, q_scale=s, **kw)
    want = torch.from_numpy(np.clip(np.round(steps.numpy()), -127, 127).astype(np.int8))
    assert torch.equal(got[0, 0, :, 0], want) and torch.equal(got, aten_chain(y, q_scale=s, **kw))


@pytest.mark.parametrize("form", ["bn_float", "bn_int8", "bias_float", "bias_int8", "channels_last"])
def test_opcheck_conv_epilogue(form):
    g = torch.Generator().manual_seed(3)
    layout = "channels_last" if form == "channels_last" else "nchw"
    y, kw = _inputs(g, (2, 8, 5, 6), torch.bfloat16, layout, "bias" if form.startswith("bias") else "bn")
    q = torch.tensor([0.05]) if form.endswith("int8") else None
    act = "none" if form.startswith("bias") else "relu"
    args = (y, kw.get("bias"), kw.get("bn_mul"), kw.get("bn_add"), act, q)
    torch.library.opcheck(torch.ops.gelslim.conv_epilogue.default, args)


def test_rejects_bad_arguments():
    y = torch.zeros(1, 4, 3, 3)
    v = torch.ones(4)
    with pytest.raises(ValueError, match="either bias"):
        ce.conv_epilogue(y)
    with pytest.raises(ValueError, match="either bias"):
        ce.conv_epilogue(y, bias=v, bn_mul=v, bn_add=v)
    with pytest.raises(ValueError, match="bn_mul must be a contiguous torch.float32"):
        ce.conv_epilogue(y, bn_mul=torch.ones(3), bn_add=torch.ones(3), act="relu")
    with pytest.raises(ValueError, match="bn_add must be a contiguous"):
        ce.conv_epilogue(y, bn_mul=v, bn_add=torch.ones(8)[::2], act="relu")
    with pytest.raises(ValueError, match="bias must be a contiguous torch.bfloat16"):
        ce.conv_epilogue(y.bfloat16(), bias=v)
    with pytest.raises(ValueError, match="act"):
        ce.conv_epilogue(y, bias=v, act="gelu")
    with pytest.raises(ValueError, match="one-element"):
        ce.conv_epilogue(y, bias=v, q_scale=torch.ones(2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ce.conv_epilogue(y.double(), bias=v)
    with pytest.raises(ValueError, match="NCHW-contiguous or channels-last"):
        ce.conv_epilogue(y.transpose(2, 3)[:, :, :, :2], bias=v)
    assert ce.conv_epilogue(y[:0], bias=v, q_scale=torch.ones(1)).shape == (0, 3, 3, 4)


# -- the residual form (the transformers' residual units) ---------------------------


def _residual_inputs(g, shape, dtype, layout, device="cpu"):
    """y and a bias as ``_inputs`` makes them, and a residual of y's shape,
    dtype and layout."""
    y, kw = _inputs(g, shape, dtype, layout, "bias", device)
    x = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    return y, kw["bias"], x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_cpu_residual_form_equals_aten_chain(layout, dtype):
    """A residual unit's second conv's bias add, then its skip add: the
    reference, and the op (which computes it on the CPU), equal aten's two
    adds in y's dtype and layout bit for bit; in bfloat16 that is two
    roundings, which one rounded float32 sum would not give."""
    g = torch.Generator().manual_seed(zlib.crc32(f"residual {layout} {dtype}".encode()))
    y, bias, x = _residual_inputs(g, (2, 16, 7, 13), dtype, layout)
    want = (y + bias.view(1, -1, 1, 1)) + x
    for got in (ce.conv_epilogue_reference(y, bias=bias, residual=x), ce.conv_epilogue(y, bias=bias, residual=x)):
        assert got.dtype == dtype and got.stride() == y.stride() == want.stride()
        assert torch.equal(got, want)
    if dtype == torch.bfloat16:
        assert not torch.equal(want, (y.float() + bias.float().view(1, -1, 1, 1) + x.float()).to(dtype))


RESIDUAL_REFUSALS = {
    "shape": ("the residual must be", lambda y, b, x: dict(bias=b, residual=x[:, :, :, :-1])),
    "dtype": ("the residual must be", lambda y, b, x: dict(bias=b, residual=x.float())),
    "layout": ("laid out as y", lambda y, b, x: dict(bias=b, residual=x.contiguous())),
    "bn vectors": ("a residual takes a bias", lambda y, b, x: dict(
        bn_mul=torch.ones(8), bn_add=torch.zeros(8), act="relu", residual=x)),
    "activation": ("a residual takes a bias", lambda y, b, x: dict(bias=b, act="relu", residual=x)),
    "q_scale": ("no q_scale", lambda y, b, x: dict(bias=b, q_scale=torch.ones(1), residual=x)),
}


@pytest.mark.parametrize("case", list(RESIDUAL_REFUSALS))
def test_residual_form_rejects_bad_arguments(case):
    """A residual of another shape, dtype or layout than y's, or beside
    BatchNorm vectors, an activation or an int8 output, raises."""
    y = torch.zeros(2, 8, 5, 6, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    match, kw = RESIDUAL_REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        ce.conv_epilogue(y, **kw(y, torch.zeros(8, dtype=torch.bfloat16), torch.zeros_like(y)))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_fake_agrees_with_the_op_on_the_residual_form(layout):
    """The op's fake (what ``torch.export`` traces) gives the output's
    shape, dtype and strides as the op does; ``opcheck`` holds the op's
    registrations to one another."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(7)
    y, bias, x = _residual_inputs(g, (2, 8, 5, 6), torch.bfloat16, layout)
    args = (y, bias, None, None, "none", None, x)
    real = torch.ops.gelslim.conv_epilogue(*args)
    with FakeTensorMode() as mode:
        fake = torch.ops.gelslim.conv_epilogue(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride()) == (
        y.shape, y.dtype, y.stride())
    torch.library.opcheck(torch.ops.gelslim.conv_epilogue.default, args)


# -- the destination form (the bf16 U-Net's concat buffers) -------------------------


def _buffer(y, channels, rows=0, cols=0, fill=float("nan")):
    """A channels-last (N, channels, H + rows, W + cols) buffer of y's
    dtype, filled with ``fill`` so that what a store leaves shows."""
    n, _, h, w = y.shape
    return torch.full((n, channels, h + rows, w + cols), fill, dtype=y.dtype).contiguous(
        memory_format=torch.channels_last)


def _destinations(y, case):
    """(the NaN-filled buffers of the case's destinations, the
    destinations): y's own tensor; two destinations (an own tensor and a
    concat buffer's lower channels); a channel offset (the upper channels
    of a buffer 16 + C wide); a spatial offset besides (one row and one
    column in, the pad's offset)."""
    c = y.shape[1]
    if case == "one":
        return [], [torch.empty_like(y)]
    if case == "two":
        buf = _buffer(y, c + 16)
        return [buf], [torch.empty_like(y), buf[:, :c]]
    buf = _buffer(y, 16 + c, *((1, 2) if case == "spatial_offset" else (0, 0)))
    top, left = (1, 1) if case == "spatial_offset" else (0, 0)
    return [buf], [buf[:, 16:, top:top + y.shape[2], left:left + y.shape[3]]]


INTO_CASES = ["one", "two", "channel_offset", "spatial_offset"]


@pytest.mark.parametrize("case", INTO_CASES)
@pytest.mark.parametrize("mode,act", [("bias", "none"), ("bn", "relu")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_into_equals_reference_then_copy(dtype, mode, act, case):
    """The destination form stores, into each destination, what
    ``conv_epilogue_reference`` returns, bit for bit, returns None and
    writes nothing else of the buffers it was given views of; the twin,
    given the same destinations, stores the same bits."""
    g = torch.Generator().manual_seed(zlib.crc32(f"into {dtype} {mode} {case}".encode()))
    y, kw = _inputs(g, (2, 16, 5, 7), dtype, "channels_last", mode)
    want = ce.conv_epilogue_reference(y, act=act, **kw)
    buffers, into = _destinations(y, case)
    assert ce.conv_epilogue(y, act=act, **kw, into=into) is None
    assert all(torch.equal(d, want) for d in into)
    for buf in buffers:  # y is finite: what is not NaN was stored, one destination's worth
        assert int((~buf.isnan()).sum()) == y.numel()
    _, twin = _destinations(y, case)
    assert ce.conv_epilogue_reference(y, act=act, **kw, into=twin) is None
    assert all(torch.equal(a, b) for a, b in zip(into, twin))


INTO_REFUSALS = {
    "nchw destination": ("channels-last", lambda y, buf: dict(into=[torch.empty(y.shape, dtype=y.dtype)])),
    "dtype": ("tensor of y's shape", lambda y, buf: dict(into=[torch.empty_like(y, dtype=torch.float32)])),
    "shape": ("tensor of y's shape", lambda y, buf: dict(into=[buf[:, :8, :, :-1]])),
    "channel offset": ("multiple of 8", lambda y, buf: dict(into=[buf[:, 4:12]])),
    "overlap": ("overlap", lambda y, buf: dict(into=[buf[:, :8].as_strided(y.shape, (0, 1, 0, 0))])),
    "three": ("one or two", lambda y, buf: dict(into=[buf[:, :8]] * 3)),
    "nchw y": ("channels-last y", lambda y, buf: dict(y=y.contiguous(), into=[buf[:, :8]])),
    "residual": ("no residual", lambda y, buf: dict(residual=torch.zeros_like(y), into=[buf[:, :8]])),
    "q_scale": ("no q_scale", lambda y, buf: dict(q_scale=torch.ones(1), into=[buf[:, :8]])),
}


@pytest.mark.parametrize("case", list(INTO_REFUSALS))
def test_into_rejects_bad_destinations(case):
    """An NCHW destination, another dtype or shape, channels that start off
    a multiple of 8 within their pixel, overlapping strides, three
    destinations, an NCHW y, and ``into`` beside a residual or an int8
    output raise, in the op's wrapper and in its twin."""
    y = torch.zeros(2, 8, 5, 6, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    match, make = INTO_REFUSALS[case]
    kw = dict(bias=torch.zeros(8, dtype=torch.bfloat16), **make(y, _buffer(y, 16, fill=0.0)))
    y = kw.pop("y", y)
    for fn in (ce.conv_epilogue, ce.conv_epilogue_reference):
        with pytest.raises(ValueError, match=match):
            fn(y, **kw)


@pytest.mark.parametrize("case", INTO_CASES)
def test_opcheck_conv_epilogue_into(case):
    """``opcheck`` holds the destination form's op (its schema's mutated
    ``into``, its fake, its dispatch) to its CPU implementation."""
    g = torch.Generator().manual_seed(5)
    y, kw = _inputs(g, (2, 8, 5, 6), torch.bfloat16, "channels_last", "bn")
    _, into = _destinations(y, case)
    torch.library.opcheck(torch.ops.gelslim.conv_epilogue_into.default,
                          (y, None, kw["bn_mul"], kw["bn_add"], "relu", into))


# -- the U-Net's two serving graphs on the CPU -------------------------------------


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(23)
    net = UNet(UNetConfig(layer_dimensions=DIMS))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in _fixture.make_state_dict(rng, DIMS).items()})
    calib = torch.from_numpy(rng.uniform(0, 1, (3, 3, 27, 37)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 27, 37)).astype(np.float32))
    return net, pq.quantize_unet(net, calib), x


def _aten_unet_forward(net, x):
    """``UNet.forward`` as it ran before the op: every DoubleConv's two BN +
    activation + cast chains and every upconv's bias add as aten ops."""
    dtype = net.compute_dtype

    def dc(m, h):
        conv1, _, act, conv2, _, _ = m.double_conv
        y = F.conv2d(h.to(dtype), conv1.weight, padding=1)
        y = act(y * m.bn0_scale + m.bn0_shift).to(dtype)
        y = F.conv2d(y, conv2.weight, padding=1)
        return act(y * m.bn1_scale + m.bn1_shift).to(dtype)

    with torch.no_grad(), full_precision(dtype):
        skips = [dc(net.inc, x)]
        for down in net.down:
            pool, m = down.maxpool_conv
            skips.append(dc(m, pool(skips[-1])))
        h = skips[-1]
        for j, up in enumerate(net.up):
            skip = skips[-2 - j]
            y = F.conv_transpose2d(h.to(dtype), up.up.weight, stride=up.stride) + up.up.bias.view(1, -1, 1, 1)
            dy, dx = skip.shape[2] - y.shape[2], skip.shape[3] - y.shape[3]
            y = F.pad(y, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
            h = dc(up.conv, torch.cat([skip.to(dtype), y], dim=1))
        out = F.conv2d(h.to(dtype), net.outc.conv.weight) + net.outc.conv.bias.view(1, -1, 1, 1)
        return out.float()


def _epilogue_spans(fn):
    with profiling.recording() as spans:
        out = fn()
    return out, [(s.name, s.site) for s in spans if s.name == "unet.epilogue"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_unet_forward_equals_aten_chain(nets, dtype, layout):
    """The float graph: 2 epilogues a DoubleConv and one an upconv, each in
    its ``unet.epilogue`` span, and the logits of the aten chain."""
    net = UNet(nets[0].cfg)
    net.load_state_dict(nets[0].state_dict())
    net.to_compute_dtype(dtype)
    x = nets[2] if layout == "nchw" else nets[2].contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got, spans = _epilogue_spans(lambda: net(x))
    assert torch.equal(got, _aten_unet_forward(net, x))
    L = len(DIMS)
    assert len(spans) == 2 * (2 * L - 1) + (L - 1)
    assert spans.count(("unet.epilogue", "upconv")) == L - 1


@pytest.mark.parametrize("upconvs", [False, True])
def test_quantized_forward_launches_its_epilogues(nets, upconvs):
    """The int8 graph: inc/conv1 and each float upconv, one epilogue each,
    the int8 upconvs none; the logits as the op's twin gives them."""
    net, _, x = nets
    q = pq.quantize_unet(net, x, quantize_upconvs=upconvs)
    got, spans = _epilogue_spans(lambda: q(x, torch.bfloat16))
    L = len(DIMS)
    assert spans == [("unet.epilogue", "conv1")] + [("unet.epilogue", "upconv")] * (0 if upconvs else L - 1)
    assert torch.isfinite(got).all()


def test_unet_backpropagates_through_the_aten_chain(nets):
    """With grad enabled and parameters that require it, the forward keeps
    the aten chain (no epilogue span), equals the no-grad forward, and every
    conv's weight and the upconvs' biases get a gradient (the BatchNorms
    run folded, from buffers)."""
    net = UNet(nets[0].cfg)
    net.load_state_dict(nets[0].state_dict())
    x = nets[2]
    out, spans = _epilogue_spans(lambda: net(x))
    assert spans == [] and out.requires_grad
    with torch.no_grad():
        assert torch.equal(out.detach(), net(x))
    out.square().mean().backward()
    used = [p for m in net.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
            for p in m.parameters()]
    assert len(used) == 2 * (2 * len(DIMS) - 1) + 2 * (len(DIMS) - 1) + 2
    assert all(p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0 for p in used)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unet_forward_reads_the_upconv_bias_live(nets, dtype):
    """The epilogue takes each upconv's bias as it is, in the compute
    dtype: an in-place change to it moves the no-grad forward at once, to
    what the aten chain gives."""
    net = UNet(nets[0].cfg)
    net.load_state_dict(nets[0].state_dict())
    net.to_compute_dtype(dtype)
    x = nets[2]
    with torch.no_grad():
        before = net(x)
        for up in net.up:
            up.up.bias.add_(0.25)
        got = net(x)
    assert not torch.equal(got, before)
    assert torch.equal(got, _aten_unet_forward(net, x))


def _op_nodes(program, op):
    """The graph's calls of op: direct, or (where the export functionalized
    a mutating op) through ``auto_functionalized``."""
    return [n for n in program.graph.nodes
            if n.target is op or (n.args and n.args[0] is op and "auto_functionalized" in str(n.target))]


@pytest.mark.parametrize("kind", ["float", "int8", "bf16"])
def test_export_keeps_the_op_in_the_graph(kind, tmp_path):
    """``torch.export`` of the predictor traces through the op: each graph
    holds one ``gelslim::conv_epilogue`` an epilogue of the forward; the
    bf16 graph's levels and upconvs store into their up blocks' concat
    buffers through ``gelslim::conv_epilogue_into``, 2 (L - 1) of them."""
    kw = dict(CNN_dimensions=DIMS, input_tactile_image_size=(16, 22), image_normalization_method="0_255_to_0_1",
              depth_normalization_method="min_max_to_0_-1", depth_normalization_parameters=(-1.9, 0.0),
              norm_scale=0.9, use_difference_image=True)
    rng = np.random.RandomState(5)
    frame = (32, 43)
    pred = Predictor(GelslimConfig(**kw), _fixture.make_state_dict(rng, DIMS), device="cpu",
                     **({"compute_dtype": torch.bfloat16} if kind == "bf16" else {}))
    if kind == "int8":
        pred = pred.quantize(rng.uniform(0, 255, (2, 6, *frame)).astype(np.float32),
                             rng.uniform(0, 255, (6, *frame)).astype(np.float32))
    path = export_predictor(pred, frame, path=str(tmp_path / "p.gsx"), batch_sizes=(2,), frame_size=frame)
    with zipfile.ZipFile(path) as zf:
        program = torch.export.load(io.BytesIO(zf.read("graph_b2.pt2")))
    ops = _op_nodes(program, torch.ops.gelslim.conv_epilogue.default)
    into = _op_nodes(program, torch.ops.gelslim.conv_epilogue_into.default)
    L = len(DIMS)
    stored = 2 * (L - 1) if kind == "bf16" else 0
    assert len(ops) == (L if kind == "int8" else 2 * (2 * L - 1) + (L - 1) - stored)
    assert len(into) == stored


# -- on the card only ------------------------------------------------------------

# (N, C, H, W, layout, dtype, mode, act, int8 out): the flagship's epilogue
# sites at N = 1 and 128 finger images (the int8 graph's channels-last
# inc/conv1 and upconvs, the float graph's NCHW BatchNorm sites and
# upconvs: rows 213, 212, 106, 53, 52, 26 and 13 wide), then the shapes and
# epilogues the flagship does not reach
CUDA_CASES = [
    (n, 64, 160, 213, "channels_last", torch.bfloat16, "bn", "relu", True) for n in (1, 128)] + [
    (n, c, h, w, "channels_last", torch.bfloat16, "bias", "none", True)
    for n in (1, 128) for c, h, w in ((512, 20, 26), (256, 40, 52), (128, 80, 106), (64, 160, 212))] + [
    (n, c, h, w, "nchw", torch.bfloat16, "bn", "relu", False)
    for n in (1, 128) for c, h, w in ((64, 160, 213), (128, 80, 106), (256, 40, 53), (512, 20, 26),
                                      (1024, 10, 13))] + [
    (n, c, h, w, "nchw", torch.bfloat16, "bias", "none", False)
    for n in (1, 128) for c, h, w in ((512, 20, 26), (64, 160, 212))] + [
    (2, 64, 160, 213, "channels_last", torch.float32, "bn", "relu", True),
    (2, 64, 160, 213, "nchw", torch.float32, "bn", "relu", False),
    (2, 128, 80, 106, "channels_last", torch.float32, "bias", "none", True),
    (2, 1024, 10, 13, "nchw", torch.bfloat16, "bn", "relu", True),  # NCHW in, int8 NHWC out
    (2, 64, 20, 26, "channels_last", torch.bfloat16, "bias", "none", False),
    (2, 12, 9, 11, "channels_last", torch.bfloat16, "bn", "relu", True),  # C % 8: one element a thread
    (3, 5, 2, 3, "nchw", torch.float32, "bn", "relu", False),  # planes of 6 < 8
    (3, 5, 7, 9, "nchw", torch.bfloat16, "bias", "none", False),  # 945 elements: a tail of 1
    (2, 64, 17, 23, "channels_last", torch.bfloat16, "bn", "tanh", True),
    (2, 64, 17, 23, "nchw", torch.float32, "bn", "tanh", False),
    (2, 64, 17, 23, "channels_last", torch.bfloat16, "bn", "mish", False),
    (2, 64, 17, 23, "nchw", torch.float32, "bn", "mish", True),
    (2, 32, 17, 23, "nchw", torch.float32, "bias", "none", True),
    (2, 32, 17, 23, "channels_last", torch.float32, "bias", "none", False),
]


def _same(a, b):
    """Bit for bit where finite; NaN where the other is NaN."""
    if a.dtype != torch.int8:
        nan = torch.isnan(a.float())
        if not torch.equal(nan, torch.isnan(b.float())):
            return False
        a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,layout,dtype,mode,act,int8", CUDA_CASES)
def test_cuda_conv_epilogue_matches_twin(n, c, h, w, layout, dtype, mode, act, int8):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(n + c + h + w)
    y, kw = _inputs(g, (n, c, h, w), dtype, layout, mode, device="cuda")
    if y.numel() > 64:  # NaN and infinities among finite values
        flat = y.view(-1) if y.is_contiguous() else y.permute(0, 2, 3, 1).reshape(-1)
        flat[[5, 17, 40]] = torch.tensor([float("nan"), float("inf"), -float("inf")], device="cuda").to(dtype)
    q = dict(q_scale=torch.full((1,), 0.05, device="cuda")) if int8 else {}
    before = ce.conv_epilogue.launches
    got = ce.conv_epilogue(y, act=act, **kw, **q)
    want = ce.conv_epilogue_reference(y, act=act, **kw, **q)
    torch.cuda.synchronize()
    assert ce.conv_epilogue.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape and got.stride() == want.stride()
    assert _same(got, want)


# (N, C, H, W, layout, dtype) of the residual form: the DPT's and Depth
# Pro's residual units (bf16, channels-last), then the layouts, dtypes and
# sizes they do not reach
RESIDUAL_CUDA_CASES = [
    (128, 256, 22, 30, "channels_last", torch.bfloat16),  # the DPT's refinenet4
    (16, 256, 48, 48, "channels_last", torch.bfloat16),  # Depth Pro's level 4
    (2, 256, 44, 60, "nchw", torch.bfloat16),
    (2, 64, 17, 23, "channels_last", torch.float32),
    (2, 64, 17, 23, "nchw", torch.float32),
    (2, 12, 9, 11, "channels_last", torch.bfloat16),  # C % 8: one element a thread
    (3, 5, 7, 9, "nchw", torch.bfloat16),  # a tail of 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,layout,dtype", RESIDUAL_CUDA_CASES)
def test_cuda_residual_form_matches_aten_chain(n, c, h, w, layout, dtype):
    """The residual form on the card against aten's bias add and skip add:
    one launch, counted as a residual one, y's layout, bit for bit (NaN
    where aten has NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(n + c + h + w)
    y, bias, x = _residual_inputs(g, (n, c, h, w), dtype, layout, device="cuda")
    flat = y.view(-1) if y.is_contiguous() else y.permute(0, 2, 3, 1).reshape(-1)
    flat[[5, 17, 40]] = torch.tensor([float("nan"), float("inf"), -float("inf")], device="cuda").to(dtype)
    before = ce.conv_epilogue.launches, ce.conv_epilogue.residual_launches
    got = ce.conv_epilogue(y, bias=bias, residual=x)
    want = (y + bias.view(1, -1, 1, 1)) + x
    torch.cuda.synchronize()
    assert (ce.conv_epilogue.launches, ce.conv_epilogue.residual_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == want.dtype and got.stride() == want.stride()
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_cuda_epilogue_past_2_32_elements(residual):
    """Depth Pro's transposed conv to 1536 x 1536 x 128 is 4.8 G elements
    at 16 images: the kernel's 32-bit indices take it in runs of whole
    images. At 15 images (4.5 G, runs of 14 and 1), bf16 channels-last,
    the bias form and the residual form equal aten's adds bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = (15, 128, 1536, 1536)
    assert torch.Size(shape).numel() > 2 ** 32
    g = torch.Generator(device="cuda").manual_seed(11)
    y = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bias = torch.randn(128, generator=g, device="cuda", dtype=torch.bfloat16)
    x = torch.randn_like(y) if residual else None
    got = ce.conv_epilogue(y, bias=bias, residual=x)
    want = y.add_(bias.view(1, -1, 1, 1))  # y is not read again
    if residual:
        want.add_(x)
    torch.cuda.synchronize()
    assert got.stride() == want.stride() and torch.equal(got, want)


# (N, C, H, W, dtype, mode, buffer channels, pad rows, pad columns, two
# destinations): the flagship's up_3 at 2 finger images (inc/conv2 into its
# own skip and the concat buffer's lower half; the upconv into the upper
# half, left of the pad column), up_0's deepest pair, float32, then C % 8
# (one element a thread) and a buffer whose pixel stride is no multiple of 8
INTO_CUDA_CASES = [
    (2, 64, 160, 213, torch.bfloat16, "bn", 128, 0, 0, True),
    (2, 64, 160, 212, torch.bfloat16, "bias", 128, 0, 1, False),
    (2, 512, 20, 26, torch.bfloat16, "bn", 1024, 0, 0, True),
    (2, 512, 20, 26, torch.bfloat16, "bias", 1024, 0, 0, False),
    (2, 64, 17, 22, torch.float32, "bn", 128, 1, 1, True),
    (2, 16, 9, 10, torch.bfloat16, "bn", 20, 1, 1, True),
    (2, 12, 9, 11, torch.bfloat16, "bn", 24, 0, 0, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,dtype,mode,width,rows,cols,two", INTO_CUDA_CASES)
def test_cuda_into_matches_twin(n, c, h, w, dtype, mode, width, rows, cols, two):
    """The destination form on the card against its twin (the reference,
    then a copy into each destination): the buffer's upper channels hold
    the bias form at the pad offset, the lower ones and an own tensor the
    BatchNorm form; bit for bit (NaN where the twin has NaN), nothing else
    of the buffer written, one launch counted as an into one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(n + c + h + w)
    y, kw = _inputs(g, (n, c, h, w), dtype, "channels_last", mode, device="cuda")
    y.permute(0, 2, 3, 1).reshape(-1)[[5, 17, 40]] = torch.tensor(
        [float("nan"), float("inf"), -float("inf")], device="cuda").to(dtype)
    act = "relu" if mode == "bn" else "none"
    bufs = [torch.full((n, width, h + rows, w + cols), 7.0, dtype=dtype, device="cuda").contiguous(
        memory_format=torch.channels_last) for _ in range(2)]
    lo = width - c if mode == "bias" else 0
    top, left = rows // 2, cols // 2

    def views(buf, own):
        half = buf[:, lo:lo + c, top:top + h, left:left + w]
        return [own, half] if two else [half]

    owns = [torch.empty_like(y), torch.empty_like(y)]
    before = ce.conv_epilogue.launches, ce.conv_epilogue.into_launches
    assert ce.conv_epilogue(y, act=act, **kw, into=views(bufs[0], owns[0])) is None
    ce.conv_epilogue_reference(y, act=act, **kw, into=views(bufs[1], owns[1]))
    torch.cuda.synchronize()
    assert (ce.conv_epilogue.launches, ce.conv_epilogue.into_launches) == (before[0] + 1, before[1] + 1)
    assert _same(bufs[0], bufs[1])
    assert not two or _same(owns[0], owns[1])


def _flagship_predictors():
    from gelslim_depth_tpu_torch.entry import flagship_config

    cfg = flagship_config()
    gen = torch.Generator().manual_seed(0)
    sd = {}
    for k, shape in unet_module.unet_state_shapes(cfg.unet_config()).items():
        if len(shape) == 4:  # He-normal convs keep the activations' scale through the depth
            fan_in = shape[1] * shape[2] * shape[3]
            sd[k] = torch.randn(shape, generator=gen) * ((0.3 if k.startswith("outc.") else 2.0 ** 0.5) / fan_in ** 0.5)
        elif k.endswith("running_var") or k.endswith(".weight"):  # BN scales and variances
            sd[k] = torch.rand(shape, generator=gen) * 0.4 + 0.8
        else:  # biases, BN shifts and means
            sd[k] = torch.randn(shape, generator=gen) * 0.1
    g = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.rand((8, 6, 320, 427), generator=g, device="cuda") * 255
    base = torch.rand((6, 320, 427), generator=g, device="cuda") * 255
    bf16 = Predictor(cfg, sd, compute_dtype=torch.bfloat16)
    return cfg, {"bf16": bf16, "int8": bf16.quantize(frames[:4], base)}, frames, base


@pytest.mark.cuda
def test_cuda_flagship_served_depth_equals_aten_chain(monkeypatch):
    """Both cells' predictors (the flagship U-Net, bf16 and int8) serve the
    same depth with the kernel as with its twin, the aten chain, in its
    place; a call launches 22 epilogues in bf16 and 5 in int8, of which
    the bf16 call's 8 store into its up blocks' concat buffers (4 levels'
    last epilogues, 4 upconvs) and the int8 call's none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, preds, frames, base = _flagship_predictors()
    for kind, want_launches, want_into in (("bf16", 22, 8), ("int8", 5, 0)):
        pred = preds[kind]
        before = ce.conv_epilogue.launches, ce.conv_epilogue.into_launches
        got = pred.predict_dual_frames(frames, base, (320, 427))
        torch.cuda.synchronize()
        assert ce.conv_epilogue.launches - before[0] == want_launches, kind
        assert ce.conv_epilogue.into_launches - before[1] == want_into, kind
        with monkeypatch.context() as m:
            m.setattr(unet_module, "conv_epilogue", ce.conv_epilogue_reference)
            m.setattr(pq, "conv_epilogue", ce.conv_epilogue_reference)
            want = pred.predict_dual_frames(frames, base, (320, 427))
        torch.cuda.synchronize()
        assert ce.conv_epilogue.launches - before[0] == want_launches, kind
        assert torch.isfinite(got).all() and torch.equal(got, want), kind
