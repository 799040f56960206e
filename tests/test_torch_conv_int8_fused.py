"""The fused int8 epilogue of ``conv2d_int8`` (int8 outputs at their
consumers' scales, the two-source concat read in place) and the fused
``QuantizedUNet`` forward, against the unfused composition they replace,
on the CPU.

Bar: ``torch.equal`` everywhere. The fused functions are the old
composition by construction (conv, dequant, round to the compute dtype,
then ``quant_act``; pad + concat; quantize then max-pool, exact because
quantization is monotone), so nothing may move by a single bit.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch.models import UNet, UNetConfig
from gelslim_depth_tpu_torch.models import quantize as pq
from gelslim_depth_tpu_torch.models.unet import _no_cudnn_tf32
from gelslim_depth_tpu_torch.ops.kernels.conv_int8 import Epilogue, conv2d_int8, conv2d_int8_reference

_spec = importlib.util.spec_from_file_location(
    "torch_fixture", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixture.py"))
_fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixture)

DTYPES = [torch.float32, torch.bfloat16]


def _conv_inputs(rng, n, h, w, cin, cout, k=3, lo=-127, hi=128):
    qx = torch.from_numpy(rng.randint(lo, hi, (n, h, w, cin)).astype(np.int8))
    wt = torch.from_numpy(rng.randint(lo, hi, (cout, k, k, cin)).astype(np.int8))
    vec = [torch.from_numpy(rng.uniform(a, b, cout).astype(np.float32)) for a, b in
           ((1e-5, 1e-4), (0.5, 1.5), (-0.5, 0.5))]
    return qx, wt, vec


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_q,store_float", [(1, False), (2, False), (1, True), (2, True)])
def test_int8_outputs_equal_quant_act_of_float(dtype, n_q, store_float):
    rng = np.random.RandomState(n_q + 2 * store_float)
    qx, wt, (scale, bm, ba) = _conv_inputs(rng, 2, 9, 11, 16, 12)
    q_scales = tuple(torch.tensor([s], dtype=torch.float32) for s in (0.0123, 0.031)[:n_q])
    base = Epilogue(bn_mul=bm, bn_add=ba, act="relu", out_dtype=dtype)
    want_y = conv2d_int8_reference(qx, wt, pad=1, scale=scale, epilogue=base)
    got = conv2d_int8(qx, wt, pad=1, scale=scale,
                      epilogue=base._replace(q_scales=q_scales, store_float=store_float))
    assert isinstance(got, tuple) and len(got) == n_q + store_float
    for q, s in zip(got, q_scales):
        assert q.dtype == torch.int8 and q.shape == want_y.shape
        assert torch.equal(q, pq.quant_act(want_y, s))
        assert q.min() >= -127 and 0 < q.abs().max() <= 127  # both ends of the range are reached
    if store_float:
        assert got[-1].dtype == dtype and torch.equal(got[-1], want_y)


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_output_ties_round_half_to_even(dtype):
    """scale = s_q / 2 with small sums: v / s_q = acc / 2 exactly (bf16
    holds every |acc| < 256), so every odd sum is a tie."""
    rng = np.random.RandomState(4)
    qx = torch.from_numpy(rng.randint(-2, 3, (1, 6, 7, 4)).astype(np.int8))
    wt = torch.from_numpy(rng.randint(-2, 3, (3, 3, 3, 4)).astype(np.int8))
    s_q = torch.tensor([0.25])
    scale = torch.full((3,), 0.125)
    acc = conv2d_int8_reference(qx, wt, pad=1, scale=torch.ones(3))
    assert acc.abs().max() < 256 and (acc.remainder(2) == 1).sum() > 20
    (q,) = conv2d_int8(qx, wt, pad=1, scale=scale, epilogue=Epilogue(out_dtype=dtype, q_scales=(s_q,), store_float=False))
    want = torch.from_numpy(np.round(acc.numpy() / 2.0).astype(np.int8))  # numpy rounds half to even
    assert torch.equal(q, want)


@pytest.mark.parametrize("offset", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_source_equals_pad_and_concat(offset, dtype):
    """up_j/conv1's skip and upconv output read in place equal the padded
    concat of the unfused graph (F.pad at dy // 2, dx // 2, then cat)."""
    rng = np.random.RandomState(7 + offset[0] * 2 + offset[1])
    skip, wt, (scale, bm, ba) = _conv_inputs(rng, 2, 9, 11, 8, 10, k=3)
    wt = torch.from_numpy(rng.randint(-127, 128, (10, 3, 3, 16)).astype(np.int8))
    dy, dx = 2 * offset[0] + (offset[0] == 0), 2 * offset[1]  # pads of (oy, dy - oy), (ox, dx - ox)
    up = torch.from_numpy(rng.randint(-127, 128, (2, 9 - dy, 11 - dx, 8)).astype(np.int8))
    assert (dy // 2, dx // 2) == offset
    ep = Epilogue(bn_mul=bm, bn_add=ba, act="relu", out_dtype=dtype)
    cat = torch.cat([skip, F.pad(up, [0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])], dim=-1)
    want = conv2d_int8_reference(cat, wt, pad=1, scale=scale, epilogue=ep)
    assert torch.equal(conv2d_int8(skip, wt, pad=1, scale=scale, epilogue=ep, qx2=up, offset=offset), want)
    s = torch.tensor([0.02])
    (q,) = conv2d_int8(skip, wt, pad=1, scale=scale, epilogue=ep._replace(q_scales=(s,), store_float=False),
                       qx2=up, offset=offset)
    assert torch.equal(q, pq.quant_act(want, s))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,p", [((2, 9, 11, 8), 2), ((1, 8, 13, 4), 2), ((2, 10, 7, 3), 3), ((1, 3, 5, 5), 2)])
def test_max_pool_int8_equals_quantized_float_pool(dtype, shape, p):
    rng = np.random.RandomState(sum(shape) + p)
    h = torch.from_numpy(rng.uniform(-3, 3, shape).astype(np.float32)).to(dtype)
    s = torch.tensor(0.021)
    want = pq.quant_act(F.max_pool2d(h.permute(0, 3, 1, 2), p).permute(0, 2, 3, 1).contiguous(), s)
    got = pq.max_pool_int8(pq.quant_act(h, s), p)
    assert got.dtype == torch.int8 and torch.equal(got, want)


def test_fused_wrapper_rejects_bad_arguments():
    qx = torch.zeros(1, 6, 6, 8, dtype=torch.int8)
    w = torch.zeros(3, 3, 3, 16, dtype=torch.int8)
    s = torch.ones(3)
    up = torch.zeros(1, 5, 5, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="inside"):
        conv2d_int8(qx, w, pad=1, scale=s, qx2=up, offset=(2, 0))
    with pytest.raises(ValueError, match="input channels"):
        conv2d_int8(qx, w[..., :8].contiguous(), pad=1, scale=s, qx2=up)
    one = torch.ones(1)
    with pytest.raises(ValueError, match="int8 outputs"):
        conv2d_int8(qx, w, pad=1, scale=s, qx2=up, epilogue=Epilogue(q_scales=(one, one, one)))
    with pytest.raises(ValueError, match="int8 outputs"):
        conv2d_int8(qx, w, pad=1, scale=s, qx2=up, epilogue=Epilogue(store_float=False))
    with pytest.raises(ValueError, match="one-element"):
        conv2d_int8(qx, w, pad=1, scale=s, qx2=up, epilogue=Epilogue(q_scales=(torch.ones(2),)))
    (q,) = conv2d_int8(qx[:0], w, pad=1, scale=s, qx2=up[:0], epilogue=Epilogue(q_scales=(one,), store_float=False))
    assert q.shape == (0, 6, 6, 3) and q.dtype == torch.int8


# -- the whole forward -------------------------------------------------------


@torch.no_grad()
def _unfused_forward(q, x, dtype):
    """The int8 forward as separate passes: each conv stores the compute
    dtype, each consumer quantizes it (the skips too), the max-pool runs in
    the compute dtype, and up_j/conv1 reads a padded concat."""
    cfg, L = q.cfg, q.cfg.num_levels
    ws = q._float_weights(dtype)

    def nhwc(y):
        return y.permute(0, 2, 3, 1).contiguous()

    def nchw(h):
        return h.permute(0, 3, 1, 2)

    def conv(site, qx):
        block, c = site.split("/")
        dc = pq._double_conv(q.net, block)
        i = int(c[-1]) - 1
        return conv2d_int8_reference(qx, q.w8(site), pad=1, scale=q._escale(site), epilogue=Epilogue(
            bn_mul=getattr(dc, f"bn{i}_scale").view(-1), bn_add=getattr(dc, f"bn{i}_shift").view(-1),
            act=cfg.activation, out_dtype=dtype))

    def block(name, h):
        h = conv(f"{name}/conv1", pq.quant_act(h, q.act_scale(f"{name}/conv1")))
        return conv(f"{name}/conv2", pq.quant_act(h, q.act_scale(f"{name}/conv2")))

    with _no_cudnn_tf32() if dtype == torch.float32 else contextlib.nullcontext():
        inc = q.net.inc
        y = F.conv2d(x.to(dtype).contiguous(memory_format=torch.channels_last), ws["inc"], padding=1)
        h = nhwc(inc.double_conv[2](y * inc.bn0_scale + inc.bn0_shift).to(dtype))
        h = conv("inc/conv2", pq.quant_act(h, q.act_scale("inc/conv2")))
        skips = []
        for i in range(L - 1):
            skips.append(pq.quant_act(h, q.act_scale(f"up_{L - 2 - i}/conv1")))
            h = block(f"down_{i}", nhwc(F.max_pool2d(nchw(h), cfg.maxpool_size)))
        for j in range(L - 1):
            name, skip = f"up_{j}", skips[L - 2 - j]
            if f"{name}/upconv" in q.sites:
                y = conv2d_int8_reference(
                    pq.quant_act(h, q.act_scale(f"{name}/upconv")), q.w8(f"{name}/upconv"), pad=0,
                    scale=q._escale(f"{name}/upconv"),
                    epilogue=Epilogue(bias=q.get_buffer(pq._buffer_name("bias", name)), out_dtype=dtype,
                                      shuffle=q._up(name).stride))
            else:
                y = nhwc(F.conv_transpose2d(nchw(h).to(dtype), ws[name], stride=q._up(name).stride) + ws[f"{name}_b"])
            dy, dx = skip.shape[1] - y.shape[1], skip.shape[2] - y.shape[2]
            yq = F.pad(pq.quant_act(y, q.act_scale(f"{name}/conv1")),
                       [0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
            h = conv(f"{name}/conv1", torch.cat([skip, yq], dim=-1))
            h = conv(f"{name}/conv2", pq.quant_act(h, q.act_scale(f"{name}/conv2")))
        return (F.conv2d(nchw(h), ws["outc"]) + ws["outc_b"]).float().contiguous()


@pytest.fixture(scope="module")
def quantized_models():
    rng = np.random.RandomState(17)
    cfg = UNetConfig(layer_dimensions=(8, 16, 32))
    net = UNet(cfg)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in _fixture.make_state_dict(rng, (8, 16, 32)).items()})
    calib = torch.from_numpy(rng.uniform(0, 1, (3, 3, 27, 37)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 27, 37)).astype(np.float32))
    return {up: pq.quantize_unet(net, calib, quantize_upconvs=up) for up in (False, True)}, x


@pytest.mark.parametrize("upconvs", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_forward_equals_unfused(quantized_models, upconvs, dtype):
    """27 x 37 input: 13 x 18 and 6 x 9 below it, so up_0's and up_1's
    upconv outputs are a row (and a column) short of their skips."""
    models, x = quantized_models
    q = models[upconvs]
    assert q.has_int8_upconvs == upconvs
    got = q(x, dtype)
    want = _unfused_forward(q, x, dtype)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 27, 37)
    assert torch.equal(got, want)


@pytest.mark.parametrize("upconvs", [False, True])
def test_serving_launches_match_forward(quantized_models, upconvs, monkeypatch):
    """serving_launches (what chip_smoke times and the card tests check)
    describes the launches the forward makes, site by site."""
    models, x = quantized_models
    q = models[upconvs]
    seen = []

    def record(qx, w, *, pad, scale, epilogue=Epilogue(), qx2=None, offset=(0, 0)):
        if epilogue.shuffle == 1:
            seen.append((tuple(qx.shape), None if qx2 is None else tuple(qx2.shape), tuple(offset), w.shape[0],
                         w.shape[1], len(epilogue.q_scales), epilogue.store_float))
        return conv2d_int8(qx, w, pad=pad, scale=scale, epilogue=epilogue, qx2=qx2, offset=offset)

    monkeypatch.setattr(pq, "conv2d_int8", record)
    q(x, torch.bfloat16)
    want = [(s.x_shape, s.x2_shape, s.offset, s.cout, s.k, s.n_q, s.store_float)
            for s in pq.serving_launches(q.cfg, 2, (27, 37), int8_upconvs=upconvs)]
    assert seen == want
    assert any(s[1] is not None and s[1][1:3] != s[0][1:3] for s in seen)  # an upconv output short of its skip
