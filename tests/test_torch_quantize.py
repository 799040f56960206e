"""The port's int8 quantization (gelslim_depth_tpu_torch/models/quantize.py,
and the plain twin of ops/kernels/conv_int8.py) against the JAX package's
models/quantize.py, on the same weights and inputs, on the CPU.

Bars:
- weight quantization, the row-split pack and activation quantization are
  bit-identical: the same float32 divisions and round-half-to-even;
- calibrated scales: rtol 1e-5, since the two float32 forwards sum their
  convs in different orders;
- the int8 forward of one quantized model, carried across by
  quantized_from_jax: RMSE(port - JAX) <= 0.05 * float_delta + 1e-6. A ulp
  of difference at a requantization point may flip one int8 step;
- the plain conv twin against JAX's s8 conv: int32 sums equal, dequantized
  outputs within 1e-6 relative;
- float_delta of two independent quantizations: within 10%.

XLA's CPU backend skips the bfloat16 rounding of a conv output that its
consumer reads in float32 (``--xla_allow_excess_precision``, on by default),
so in-process JAX bf16 results do not round where unet_apply_int8 says; with
the flag off the JAX bf16 graph rounds there, as the port does. The bf16
reference therefore runs in a subprocess with that flag off.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.inference import QuantizedPredictor as JaxQuantizedPredictor
from gelslim_depth_tpu.models import quantize as jq
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.models.unet import UNetConfig as JaxUNetConfig
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import QuantizedPredictor
from gelslim_depth_tpu_torch.models import UNet, UNetConfig, params_from_jax, quantized_from_jax
from gelslim_depth_tpu_torch.models import quantize as pq
from gelslim_depth_tpu_torch.ops.kernels.conv_int8 import (
    Epilogue,
    conv2d_int8,
    conv2d_int8_accumulate,
)
from gelslim_depth_tpu_torch.train.checkpoint import load_quantized
from tests.torch_fixture import make_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (dims, kernel_size): the second has k=5 encoder convs, 3x3 decoder convs
# and no int8 upconvs (its upconv kernel 4 is not its stride 2)
CASES = {"d8_k3": ((8, 16, 32), 3), "d4_k5": ((4, 8), 5)}
UPCONV_CASES = [("d8_k3", False), ("d8_k3", True), ("d4_k5", False)]


@pytest.fixture(scope="module")
def models():
    """Per case: the state dict, JAX (cfg, params, stats), the port's
    float32 UNet, a calibration batch and an eval batch, from one seed."""
    rng = np.random.RandomState(7)
    out = {}
    for name, (dims, k) in CASES.items():
        sd = make_state_dict(rng, dims, k=k)
        jcfg = JaxUNetConfig(layer_dimensions=dims, kernel_size=k)
        params, stats = import_torch_state_dict(sd, jcfg)
        cfg = UNetConfig(layer_dimensions=dims, kernel_size=k)
        net = UNet(cfg)
        net.load_state_dict(params_from_jax(params, stats, cfg))
        out[name] = dict(
            sd=sd, jcfg=jcfg, params=params, stats=stats, net=net,
            calib=rng.uniform(0, 1, (4, 3, 24, 33)).astype(np.float32),
            x=rng.uniform(0, 1, (2, 3, 24, 33)).astype(np.float32),
        )
    return out


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def test_quantized_sites_match(models):
    for m in models.values():
        assert pq._quantized_sites(m["net"].cfg) == jq._quantized_sites(m["jcfg"])
        assert pq._upconv_sites(m["net"].cfg) == jq._upconv_sites(m["jcfg"])
    assert len(pq._quantized_sites(UNetConfig())) == 17


@pytest.mark.parametrize("name", list(CASES))
def test_quantized_site_shapes_match_forward(models, name):
    """serving_launches' meta-device shapes are those each site's conv sees
    in a real CPU forward (at up_j/conv1 the skip and the upconv output
    together), and its weight's Cout and kernel size."""
    net = models[name]["net"]
    seen = {}
    net(torch.from_numpy(models[name]["x"]), probe=lambda site, h: seen.setdefault(site, tuple(h.shape)))
    launches = pq.serving_launches(net.cfg, 2, (24, 33))
    assert [s.site for s in launches] == [f"{b}/{c}" for b, c in pq._quantized_sites(net.cfg)]
    for s in launches:
        n, h, w, c = s.x_shape
        assert seen[s.site] == (n, c + (s.x2_shape[3] if s.x2_shape else 0), h, w)
        block, conv = s.site.split("/")
        weight = pq._double_conv(net, block).double_conv[0 if conv == "conv1" else 3].weight
        assert (s.cout, s.k) == (weight.shape[0], weight.shape[2])


def test_quantized_site_shapes_flagship():
    shapes = {s.site: (s.x_shape, s.x2_shape, s.offset, s.cout, s.k)
              for s in pq.serving_launches(UNetConfig(), 128, (160, 213))}
    assert len(shapes) == 17
    assert shapes["inc/conv2"] == ((128, 160, 213, 64), None, (0, 0), 64, 3)
    assert shapes["down_3/conv2"] == ((128, 10, 13, 1024), None, (0, 0), 1024, 3)
    assert shapes["up_0/conv1"] == ((128, 20, 26, 512), (128, 20, 26, 512), (0, 0), 512, 3)
    assert shapes["up_3/conv1"] == ((128, 160, 213, 64), (128, 160, 212, 64), (0, 0), 64, 3)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (5, 5, 4, 8), (3, 3, 24, 5), (1, 1, 32, 4)])
def test_quantize_weight_bit_identical(shape):
    rng = np.random.RandomState(sum(shape))
    w = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    w[..., 1] = 0.0  # a zero output channel: scale 1, all-zero int8
    qj, sj = jq.quantize_weight(jnp.asarray(w))
    qp, sp = pq.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    assert qp.dtype == torch.int8 and tuple(qp.shape) == (shape[3], shape[0], shape[1], shape[2])
    np.testing.assert_array_equal(pq.hwio_from_ohwi(qp).numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    assert sp[1] == 1.0
    np.testing.assert_array_equal(pq.ohwi_from_hwio(torch.from_numpy(np.array(qj))).numpy(), qp.numpy())


@pytest.mark.parametrize("cin,cout", [(8, 4), (16, 8), (32, 16)])
def test_upconv_pack_and_quantize_bit_identical(cin, cout):
    rng = np.random.RandomState(cin + cout)
    w_ref = rng.uniform(-0.2, 0.2, (cin, cout, 2, 2)).astype(np.float32)  # (in, out, k, k)
    w_ref[:, 2] = 0.0
    w_jax = w_ref.transpose(2, 3, 1, 0)  # (k, k, out, in)
    pack_p = pq.pack_upconv_rowsplit(torch.from_numpy(w_ref))
    assert tuple(pack_p.shape) == (4 * cout, 1, 1, cin)
    np.testing.assert_array_equal(pq.rowsplit_to_jax(pack_p, 2).numpy(), np.asarray(jq.pack_upconv_rowsplit(jnp.asarray(w_jax))))
    qj, sj = jq.quantize_upconv_weight(jnp.asarray(w_jax))
    qp, sp = pq.quantize_upconv_weight(torch.from_numpy(w_ref))
    np.testing.assert_array_equal(pq.rowsplit_to_jax(qp, 2).numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(pq.rowsplit_from_jax(torch.from_numpy(np.array(qj))).numpy(), qp.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_act_bit_identical_with_ties(dtype):
    rng = np.random.RandomState(3)
    s = np.float32(0.25)  # a power of two: x / s is exact, so k + 0.5 stays a tie
    ties = ((np.arange(-140, 140) + 0.5) * s).astype(np.float32)
    x = np.concatenate([ties, rng.uniform(-40, 40, 2000).astype(np.float32)])
    for scale in (s, np.float32(0.0371)):
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        xp = torch.from_numpy(x).to(getattr(torch, dtype))
        got = pq.quant_act(xp, torch.tensor(scale))
        want = np.asarray(jq._quant_act(xj, scale))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    assert pq.quant_act(torch.tensor([0.5, 1.5, 2.5, -0.5, 300.0]), torch.tensor(1.0)).tolist() == [0, 2, 2, 0, 127]


@pytest.mark.parametrize("case,upconvs", UPCONV_CASES)
@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_calibrate_act_scales(models, case, upconvs, percentile):
    m = models[case]
    want = jq.calibrate_act_scales(
        m["jcfg"], m["params"], m["stats"], jnp.asarray(m["calib"]),
        percentile=percentile, quantize_upconvs=upconvs,
    )
    got = pq.calibrate_act_scales(
        m["net"], torch.from_numpy(m["calib"]), percentile=percentile, quantize_upconvs=upconvs
    )
    assert sorted(got) == sorted(want)
    assert any(k.endswith("/upconv") for k in got) == (upconvs and case == "d8_k3")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_percentile_past_torch_quantile_limit():
    """torch.quantile refuses inputs over 2^24 elements; the port's
    percentile takes them and interpolates as jnp.percentile does."""
    rng = np.random.RandomState(11)
    a = rng.standard_normal(2 ** 24 + 5).astype(np.float32)
    for q in (99.9, 50.0, 0.0):
        got = float(pq._percentile(torch.from_numpy(a), q))
        np.testing.assert_allclose(got, float(jnp.percentile(jnp.asarray(a), q)), rtol=1e-6)


@pytest.mark.parametrize("case,upconvs", UPCONV_CASES)
def test_unet_apply_int8_f32_same_model(models, case, upconvs):
    m = models[case]
    qj = jq.quantize_unet(m["jcfg"], m["params"], m["stats"], jnp.asarray(m["calib"]), quantize_upconvs=upconvs)
    qp = quantized_from_jax(jax.device_get(qj))
    assert qp.has_int8_upconvs == (upconvs and case == "d8_k3")
    want = np.asarray(jq.unet_apply_int8(qj, jnp.asarray(m["x"]), compute_dtype=jnp.float32))
    got = pq.unet_apply_int8(qp, torch.from_numpy(m["x"]), compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rmse(got.numpy(), want) <= 0.05 * float(qj.float_delta) + 1e-6


_JAX_BF16_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import jax.numpy as jnp
    from gelslim_depth_tpu.config import GelslimConfig
    from gelslim_depth_tpu.models.quantize import quantize_unet, unet_apply_int8
    from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
    from gelslim_depth_tpu.train.checkpoint import save_quantized

    root = sys.argv[1]
    spec = json.load(open(os.path.join(root, "spec.json")))
    out = {}
    for key, (dims, k, upconvs) in spec.items():
        z = np.load(os.path.join(root, f"{key}.npz"))
        sd = {n[3:]: z[n] for n in z.files if n.startswith("sd/")}
        cfg = GelslimConfig(CNN_dimensions=tuple(dims), kernel_size=k, weights_name=key)
        params, stats = import_torch_state_dict(sd, cfg.unet_config())
        q = quantize_unet(cfg.unet_config(), params, stats, jnp.asarray(z["calib"]), quantize_upconvs=upconvs)
        save_quantized(os.path.join(root, key), cfg, q)
        y = unet_apply_int8(q, jnp.asarray(z["x"]), compute_dtype=jnp.bfloat16)
        np.save(os.path.join(root, f"{key}_y.npy"), np.asarray(y))
        out[key] = float(q.float_delta)
    json.dump(out, open(os.path.join(root, "float_delta.json"), "w"))
    print("JAX-BF16-OK")
    """
)


@pytest.fixture(scope="module")
def jax_bf16(models, tmp_path_factory):
    """JAX's quantize_unet and bf16 unet_apply_int8, in a subprocess where
    XLA rounds at the bf16 points: per case, its quantized artifact (JAX's
    save_quantized), its bf16 output and its float_delta."""
    root = tmp_path_factory.mktemp("jax_bf16")
    spec = {}
    for case, upconvs in UPCONV_CASES:
        key = f"{case}_{'up8' if upconvs else 'upf'}"
        m = models[case]
        spec[key] = (list(m["jcfg"].layer_dimensions), m["jcfg"].kernel_size, upconvs)
        np.savez(root / f"{key}.npz", calib=m["calib"], x=m["x"], **{f"sd/{k}": v for k, v in m["sd"].items()})
    (root / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", _JAX_BF16_SCRIPT, str(root)], capture_output=True,
                       text=True, env=env, cwd=str(root), timeout=600)
    assert "JAX-BF16-OK" in r.stdout, r.stderr[-3000:]
    return root, json.loads((root / "float_delta.json").read_text())


@pytest.mark.parametrize("case,upconvs", UPCONV_CASES)
def test_unet_apply_int8_bf16_same_model(models, jax_bf16, case, upconvs):
    """JAX's artifact, read by the port's load_quantized, runs the same bf16
    forward in both packages."""
    root, deltas = jax_bf16
    key = f"{case}_{'up8' if upconvs else 'upf'}"
    _, qp = load_quantized(str(root / key))
    got = qp(torch.from_numpy(models[case]["x"]), torch.bfloat16)
    want = np.load(root / f"{key}_y.npy")
    assert _rmse(got.numpy(), want) <= 0.05 * deltas[key] + 1e-6
    assert abs(float(qp.float_delta) - deltas[key]) == 0.0


@pytest.mark.parametrize("case,upconvs", UPCONV_CASES)
def test_float_delta_matches_jax(models, jax_bf16, case, upconvs):
    _, deltas = jax_bf16
    m = models[case]
    q = pq.quantize_unet(m["net"], torch.from_numpy(m["calib"]), quantize_upconvs=upconvs)
    want = deltas[f"{case}_{'up8' if upconvs else 'upf'}"]
    assert 0 < float(q.float_delta) and abs(float(q.float_delta) - want) <= 0.1 * want


@pytest.mark.parametrize("cin", [4, 8, 16, 24, 32])
@pytest.mark.parametrize("k", [3, 5])
def test_conv_twin_matches_jax_s8_conv(cin, k):
    rng = np.random.RandomState(cin * k)
    cout = 12
    qx = rng.randint(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w_hwio = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    w_scale = rng.uniform(1e-4, 1e-3, cout).astype(np.float32)
    in_scale = np.float32(0.0173)
    pad = [(1, 1), (1, 1)]
    acc_j = lax.conv_general_dilated(
        jnp.asarray(qx), jnp.asarray(w_hwio), (1, 1), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    w = pq.ohwi_from_hwio(torch.from_numpy(w_hwio))
    acc_p = conv2d_int8_accumulate(torch.from_numpy(qx), w, 1)
    np.testing.assert_array_equal(acc_p.numpy(), np.asarray(acc_j))
    want = np.asarray(jq._conv_int8_pre(jnp.asarray(qx), in_scale, jnp.asarray(w_hwio), jnp.asarray(w_scale), pad))
    scale = torch.tensor(in_scale) * torch.from_numpy(w_scale)
    got = conv2d_int8(torch.from_numpy(qx), w, pad=1, scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_conv_twin_matches_jax_rowsplit_upconv():
    rng = np.random.RandomState(5)
    cin, cout = 16, 6
    h = rng.uniform(-2, 2, (2, 5, 7, cin)).astype(np.float32)
    w_ref = rng.uniform(-0.3, 0.3, (cin, cout, 2, 2)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, cout).astype(np.float32)
    in_scale = np.float32(2.0 / 127)
    q_pack, s_col = jq.quantize_upconv_weight(jnp.asarray(w_ref.transpose(2, 3, 1, 0)))
    want = np.asarray(jq._upconv_int8(jnp.asarray(h), in_scale, q_pack, s_col, jnp.asarray(bias)))
    qw, sc = pq.quantize_upconv_weight(torch.from_numpy(w_ref))
    qx = pq.quant_act(torch.from_numpy(h), torch.tensor(in_scale))
    got = conv2d_int8(
        qx, qw, pad=0, scale=(torch.tensor(in_scale) * sc).repeat(2),
        epilogue=Epilogue(bias=torch.from_numpy(bias).repeat(4), shuffle=2),
    )
    assert tuple(got.shape) == want.shape == (2, 10, 14, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "tanh", "mish"])
def test_conv_twin_epilogue_order(act):
    """The twin's epilogue: scale, bias, BN, activation, store; the
    kernel's order, spelled out as separate float32 ops."""
    from gelslim_depth_tpu_torch.models.unet import Activation

    rng = np.random.RandomState(2)
    qx = torch.from_numpy(rng.randint(-127, 128, (1, 6, 7, 8)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (5, 3, 3, 8)).astype(np.int8))
    vec = [torch.from_numpy(rng.uniform(lo, hi, 5).astype(np.float32)) for lo, hi in
           ((1e-5, 1e-4), (-1, 1), (0.5, 1.5), (-0.5, 0.5))]
    for dtype in (torch.float32, torch.bfloat16):
        got = conv2d_int8(qx, w, pad=1, scale=vec[0], epilogue=Epilogue(
            bias=vec[1], bn_mul=vec[2], bn_add=vec[3], act=act, out_dtype=dtype))
        acc = conv2d_int8_accumulate(qx, w, 1).float()
        want = Activation(act)((acc * vec[0] + vec[1]) * vec[2] + vec[3]).to(dtype)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_conv_wrapper_rejects_bad_arguments():
    qx = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    w = torch.zeros(3, 3, 3, 8, dtype=torch.int8)
    s = torch.ones(3)
    with pytest.raises(TypeError):
        conv2d_int8(qx.float(), w, pad=1, scale=s)
    with pytest.raises(ValueError, match="input channels"):
        conv2d_int8(qx, w[..., :4].contiguous(), pad=1, scale=s)
    with pytest.raises(ValueError, match="scale"):
        conv2d_int8(qx, w, pad=1, scale=torch.ones(4))
    with pytest.raises(ValueError, match="shuffle"):
        conv2d_int8(qx, w, pad=1, scale=s, epilogue=Epilogue(shuffle=2))
    with pytest.raises(ValueError, match="act"):
        conv2d_int8(qx, w, pad=1, scale=s, epilogue=Epilogue(act="gelu"))
    assert conv2d_int8(qx[:0], w, pad=1, scale=s).shape == (0, 4, 4, 3)


@pytest.mark.parametrize("method,params", [
    ("min_max_to_0_-1", (-1.9180814027786255, 0.0)),
    ("mean_std", (-1.2, 0.1, 0.3, 0.45)),
])
def test_delta_mm_both_methods(models, method, params):
    m = models["d8_k3"]
    qj = jq.quantize_unet(m["jcfg"], m["params"], m["stats"], jnp.asarray(m["calib"]))
    kw = dict(CNN_dimensions=(8, 16, 32), depth_normalization_method=method,
              depth_normalization_parameters=params, norm_scale=0.9)
    want = JaxQuantizedPredictor(JaxConfig(**kw), qj).delta_mm
    got = QuantizedPredictor(GelslimConfig(**kw), quantized_from_jax(jax.device_get(qj)), device="cpu").delta_mm
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
