"""The port's int8 serving (``Predictor.quantize`` -> ``QuantizedPredictor``)
and its checkpoints against the JAX package's, on the same weights and
calibration frames, on the CPU; and, on the card only, ``conv2d_int8``
against its plain twin.

Bars: served depth within RMSE 0.05 * delta_mm + 1e-6 mm of the JAX
package's (a ulp at a requantization point may flip one int8 step);
artifacts crossing between the packages keep every array bit-equal. On the
CPU every quantized conv is the kernel's plain twin.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.inference import Predictor as JaxPredictor
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.models.torch_import import load_torch_checkpoint as jax_load_pth
from gelslim_depth_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from gelslim_depth_tpu.train.checkpoint import load_quantized as jax_load_quantized
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor, QuantizedPredictor, fused_predict_dual
from gelslim_depth_tpu_torch.models import params_to_jax
from gelslim_depth_tpu_torch.models import UNetConfig
from gelslim_depth_tpu_torch.models.quantize import hwio_from_ohwi, rowsplit_to_jax, serving_launches
from gelslim_depth_tpu_torch.ops.kernels.conv_int8 import PATHS, Epilogue, conv2d_int8, conv2d_int8_reference
from gelslim_depth_tpu_torch.train.checkpoint import load_checkpoint, load_quantized, save_weights

# by path: where an installed package owns the name `tests` (as on the card's
# machine), `from tests.torch_fixture import ...` finds that package instead
_spec = importlib.util.spec_from_file_location(
    "torch_fixture", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixture.py"))
_fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixture)
make_state_dict = _fixture.make_state_dict

DIMS = (8, 16, 32)
CFG_KW = dict(
    CNN_dimensions=DIMS,
    input_tactile_image_size=(32, 43),
    image_normalization_method="0_255_to_0_1",
    depth_normalization_method="min_max_to_0_-1",
    depth_normalization_parameters=(-1.9, 0.0),
    norm_scale=0.9,
    use_difference_image=True,
    weights_name="unet_q",
)
FRAME = (64, 86)


@pytest.fixture(scope="module")
def bundle():
    rng = np.random.RandomState(21)
    sd = make_state_dict(rng, DIMS)
    jcfg = JaxConfig(**CFG_KW)
    params, stats = import_torch_state_dict(sd, jcfg.unet_config())
    return dict(
        sd=sd, params=params, stats=stats,
        jax=JaxPredictor(jcfg, params, stats),
        port=Predictor(GelslimConfig(**CFG_KW), sd, device="cpu"),
        frames=rng.uniform(0, 255, (4, 6, *FRAME)).astype(np.float32),
        frames2=rng.uniform(0, 160, (4, 6, *FRAME)).astype(np.float32),
        base=rng.uniform(0, 255, (6, *FRAME)).astype(np.float32),
        held=rng.uniform(0, 255, (2, 6, *FRAME)).astype(np.float32),
        images=rng.uniform(0, 255, (2, 3, *FRAME)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def quantized(bundle):
    """JAX's and the port's quantization of the same float model on the
    same calibration frames, with and without int8 upconvs."""
    return {
        up: (bundle["jax"].quantize(bundle["frames"], bundle["base"], quantize_upconvs=up),
             bundle["port"].quantize(bundle["frames"], bundle["base"], quantize_upconvs=up))
        for up in (False, True)
    }


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


@pytest.mark.parametrize("upconvs", [False, True])
def test_quantized_predictor_matches_jax(bundle, quantized, upconvs):
    qj, qp = quantized[upconvs]
    assert isinstance(qp, QuantizedPredictor) and qp.compute_dtype == torch.float32
    assert qp.q.has_int8_upconvs == upconvs
    assert 0 < qp.delta_mm < 0.05
    bar = 0.05 * qj.delta_mm + 1e-6
    held, base = bundle["held"], bundle["base"]
    want = np.asarray(qj.predict_dual_frames(held, base, FRAME))
    got = qp.predict_dual_frames(held, base, FRAME)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 2, *FRAME)
    assert _rmse(got.numpy(), want) <= bar
    # the kernel front end's route (its plain twin on the CPU)
    with torch.no_grad():
        got_k = fused_predict_dual(qp.config, qp._net(), torch.from_numpy(held), torch.from_numpy(base),
                                   FRAME, use_kernel=True)
    assert _rmse(got_k.numpy(), want) <= bar
    want = np.asarray(qj.predict_depth_from_RGB(bundle["images"], (32, 43)))
    got = qp.predict_depth_from_RGB(bundle["images"], (32, 43))
    assert _rmse(got.numpy(), want) <= bar
    multi = qp.predict_dual_frames_multi([held[:1], held[1:]], base, FRAME)
    np.testing.assert_allclose(multi.numpy(), qp.predict_dual_frames(held, base, FRAME).numpy(), rtol=1e-6, atol=1e-6)


def test_bf16_quantized_predictor(bundle):
    """The bf16 predictor calibrates from the float32 weights and serves
    int8 within the parity gate of the float graph."""
    pred16 = Predictor(GelslimConfig(**CFG_KW), bundle["sd"], device="cpu", compute_dtype=torch.bfloat16)
    q16 = pred16.quantize(bundle["frames"], bundle["base"])
    assert q16.compute_dtype == torch.bfloat16
    assert q16.q.net.compute_dtype == torch.float32 and pred16.net.compute_dtype == torch.bfloat16
    q32 = bundle["port"].quantize(bundle["frames"], bundle["base"])
    assert q16.q.act_scales() == q32.q.act_scales()
    assert q16.delta_mm == q32.delta_mm < 0.05
    y = q16.predict_dual_frames(bundle["held"], bundle["base"], FRAME)
    y_f = bundle["port"].predict_dual_frames(bundle["held"], bundle["base"], FRAME)
    assert torch.isfinite(y).all() and _rmse(y.numpy(), y_f.numpy()) < 0.05


@pytest.mark.parametrize("upconvs", [False, True])
def test_jax_artifact_serves_in_port(bundle, quantized, upconvs, tmp_path):
    qj, _ = quantized[upconvs]
    qj.save(str(tmp_path))
    qp = QuantizedPredictor.from_checkpoint(str(tmp_path), device="cpu", compute_dtype=torch.float32)
    assert qp.q.has_int8_upconvs == upconvs
    assert dataclasses.asdict(qp.config) == dataclasses.asdict(GelslimConfig(**CFG_KW))
    np.testing.assert_allclose(qp.delta_mm, qj.delta_mm, rtol=1e-6)
    want = np.asarray(qj.predict_dual_frames(bundle["held"], bundle["base"], FRAME))
    got = qp.predict_dual_frames(bundle["held"], bundle["base"], FRAME).numpy()
    assert _rmse(got, want) <= 0.05 * qj.delta_mm + 1e-6


def _port_arrays(q):
    """What the port's artifact must hold, in the JAX package's layouts."""
    params, stats = params_to_jax(q.net.state_dict(), q.cfg)
    w8 = {s: (rowsplit_to_jax(q.w8(s), 2) if s.endswith("upconv") else hwio_from_ohwi(q.w8(s))).numpy()
          for s in q.sites}
    return params, stats, w8, {s: q.w_scale(s).numpy() for s in q.sites}


@pytest.mark.parametrize("upconvs", [False, True])
def test_port_artifact_read_by_jax(quantized, upconvs, tmp_path):
    _, qp = quantized[upconvs]
    path = qp.save(str(tmp_path))
    assert os.path.basename(path) == "unet_q_int8.npz" and (tmp_path / "unet_q_int8.json").exists()
    config, qj = jax_load_quantized(str(tmp_path))
    assert dataclasses.asdict(config) == dataclasses.asdict(JaxConfig(**CFG_KW))
    params, stats, w8, w_scale = _port_arrays(qp.q)
    for tree_j, tree_p in ((qj.params, params), (qj.batch_stats, stats)):
        assert sorted(tree_j) == sorted(tree_p)
        for block in tree_p:
            for k, v in tree_p[block].items():
                np.testing.assert_array_equal(np.asarray(tree_j[block][k]), v)
    got_sites = {f"{b}/{c}" for b in qj.w8 for c in qj.w8[b]}
    assert got_sites == set(qp.q.sites)
    for site in qp.q.sites:
        b, c = site.split("/")
        assert np.asarray(qj.w8[b][c]).dtype == np.int8
        np.testing.assert_array_equal(np.asarray(qj.w8[b][c]), w8[site])
        np.testing.assert_array_equal(np.asarray(qj.w_scale[b][c]), w_scale[site])
    assert {k: float(v) for k, v in qj.act_scale.items()} == qp.q.act_scales()
    assert float(qj.float_delta) == float(qp.q.float_delta)
    # and the port reads its own artifact back
    _, q2 = load_quantized(str(tmp_path))
    assert q2.sites == qp.q.sites and q2.act_scales() == qp.q.act_scales()
    for site in qp.q.sites:
        assert torch.equal(q2.w8(site), qp.q.w8(site))


def test_legacy_json_fallback(quantized, tmp_path):
    """Artifacts written before the <name>_int8.json rename keep their
    config in <name>.json."""
    _, qp = quantized[False]
    qp.save(str(tmp_path))
    os.rename(tmp_path / "unet_q_int8.json", tmp_path / "unet_q.json")
    config, q = load_quantized(str(tmp_path))
    assert config.weights_name == "unet_q" and q.act_scales() == qp.q.act_scales()
    jax_load_quantized(str(tmp_path))


@pytest.mark.parametrize("drop", ["w_scale/down_0/conv2", "w8/up_1/conv1", "act_scale_json"])
def test_truncated_artifact_raises_key_error(quantized, tmp_path, drop):
    _, qp = quantized[False]
    path = qp.save(str(tmp_path))
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != drop}
    if drop.startswith("w8/"):  # the w8 array and its scale both gone
        flat.pop("w_scale/" + drop[3:])
    np.savez(path, **flat)
    match = {"w_scale/down_0/conv2": "carries w8/down_0/conv2 but not",
             "w8/up_1/conv1": "missing int8 weight arrays",
             "act_scale_json": "act_scale_json"}[drop]
    with pytest.raises(KeyError, match=match):
        load_quantized(str(tmp_path))
    with pytest.raises(KeyError, match=match):
        jax_load_quantized(str(tmp_path))


def test_quantized_artifact_name_resolution(quantized, tmp_path):
    with pytest.raises(FileNotFoundError):
        load_quantized(str(tmp_path))
    _, qp = quantized[False]
    qp.save(str(tmp_path))
    qp.save(str(tmp_path), name="other")
    with pytest.raises(ValueError, match="ambiguous"):
        load_quantized(str(tmp_path))
    config, _ = load_quantized(str(tmp_path), "other")
    assert config.weights_name == "unet_q"


def test_save_weights_read_by_jax(bundle, tmp_path):
    cfg = GelslimConfig(**CFG_KW)
    path = save_weights(str(tmp_path), cfg, bundle["port"].state_dict)
    assert path == str(tmp_path / "unet_q.npz")
    config, params, stats = jax_load_checkpoint(str(tmp_path))
    assert dataclasses.asdict(config) == dataclasses.asdict(JaxConfig(**CFG_KW))
    for tree_j, tree_w in ((params, bundle["params"]), (stats, bundle["stats"])):
        for block in tree_w:
            for k, v in tree_w[block].items():
                np.testing.assert_array_equal(np.asarray(tree_j[block][k]), np.asarray(v))
    p_pth, s_pth = jax_load_pth(str(tmp_path / "unet_q.pth"), config.unet_config())
    np.testing.assert_array_equal(np.asarray(p_pth["up_1"]["upconv_w"]), np.asarray(bundle["params"]["up_1"]["upconv_w"]))
    np.testing.assert_array_equal(np.asarray(s_pth["inc"]["bn2_var"]), np.asarray(bundle["stats"]["inc"]["bn2_var"]))
    assert dataclasses.asdict(JaxConfig.from_python_module(str(tmp_path / "config_unet_q.py"))) == dataclasses.asdict(config)
    # the port reads it back and serves the same depth
    _, p2, s2 = load_checkpoint(str(tmp_path))
    pred = Predictor.from_checkpoint(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(
        pred.predict_dual_frames(bundle["held"], bundle["base"], FRAME).numpy(),
        bundle["port"].predict_dual_frames(bundle["held"], bundle["base"], FRAME).numpy(),
    )


def test_recalibrate_in_place(bundle):
    qj = bundle["jax"].quantize(bundle["frames"], bundle["base"])
    qp = bundle["port"].quantize(bundle["frames"], bundle["base"])
    q = qp.q
    ptrs = {s: q.act_scale(s).data_ptr() for s in q.act_sites}
    before, delta_before = q.act_scales(), float(q.float_delta)
    assert qp.recalibrate(bundle["frames2"], bundle["base"], percentile=99.5) is qp
    assert qp.q is q and {s: q.act_scale(s).data_ptr() for s in q.act_sites} == ptrs
    after = q.act_scales()
    assert after != before and float(q.float_delta) != delta_before
    qj.recalibrate(bundle["frames2"], bundle["base"], percentile=99.5)
    for s, v in qj.q.act_scale.items():
        np.testing.assert_allclose(after[s], float(v), rtol=1e-5, err_msg=s)
    want = np.asarray(qj.predict_dual_frames(bundle["held"], bundle["base"], FRAME))
    got = qp.predict_dual_frames(bundle["held"], bundle["base"], FRAME).numpy()
    assert _rmse(got, want) <= 0.05 * qj.delta_mm + 1e-6


# -- on the card only --------------------------------------------------------

# (n, h, w, cin, cout, k, pad, act, out dtype, shuffle, int8 outputs, store
# the float one, second source (h2, w2, cin2, oy, ox) or None): flagship site
# shapes at N=1, one at N=8, M and N tails, the concat read in place at
# offsets, ragged Cin, k=5 with pad 1, the row-split upconv mode
CUDA_CASES = [
    (1, 160, 213, 64, 64, 3, 1, "relu", torch.bfloat16, 1, 2, False, None),     # inc/conv2
    (1, 80, 106, 64, 128, 3, 1, "relu", torch.bfloat16, 1, 1, False, None),     # down_0/conv1
    (1, 10, 13, 1024, 1024, 3, 1, "relu", torch.bfloat16, 1, 0, True, None),    # down_3/conv2
    (1, 20, 26, 512, 512, 3, 1, "relu", torch.bfloat16, 1, 1, False, (20, 26, 512, 0, 0)),  # up_0/conv1
    (1, 160, 213, 64, 64, 3, 1, "relu", torch.bfloat16, 1, 1, False, (160, 212, 64, 0, 0)),  # up_3/conv1
    (1, 160, 213, 128, 64, 3, 1, "relu", torch.bfloat16, 1, 0, True, None),
    (8, 40, 53, 256, 256, 3, 1, "relu", torch.float32, 1, 2, True, None),      # down_1/conv2 at N=8
    (3, 7, 9, 64, 96, 3, 1, "relu", torch.float32, 1, 1, True, None),          # M and N tails
    (2, 17, 23, 64, 200, 3, 1, "relu", torch.bfloat16, 1, 2, False, (16, 21, 64, 1, 1)),
    (2, 17, 23, 128, 72, 3, 1, "relu", torch.float32, 1, 1, True, (15, 23, 64, 1, 0)),
    (2, 17, 23, 64, 64, 3, 1, "relu", torch.bfloat16, 1, 1, False, (17, 22, 64, 0, 1)),
    (2, 17, 23, 4, 8, 3, 1, "relu", torch.float32, 1, 0, True, None),
    (2, 17, 23, 8, 16, 3, 1, "relu", torch.float32, 1, 2, True, None),
    (2, 17, 23, 24, 40, 3, 1, "relu", torch.bfloat16, 1, 1, False, (17, 22, 8, 0, 1)),
    (2, 17, 23, 16, 24, 5, 1, "relu", torch.float32, 1, 1, True, None),
    (2, 17, 23, 32, 70, 3, 1, "tanh", torch.float32, 1, 0, True, None),
    (2, 17, 23, 64, 64, 3, 1, "tanh", torch.bfloat16, 1, 1, True, None),
    (2, 17, 23, 32, 64, 3, 1, "mish", torch.bfloat16, 1, 0, True, None),
    (2, 17, 23, 64, 64, 3, 1, "mish", torch.float32, 1, 2, True, None),
    (1, 10, 13, 1024, 2048, 1, 0, "none", torch.bfloat16, 2, 1, False, None),   # up_0/upconv, row-split
    (2, 80, 106, 128, 256, 1, 0, "none", torch.bfloat16, 2, 1, True, None),     # up_3/upconv
    (2, 9, 11, 24, 24, 1, 0, "none", torch.float32, 2, 1, True, None),
]


def _card_inputs(g, n, h, w, cin, cout, k, x2):
    def ints(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    qx = ints((n, h, w, cin))
    qx2, offset = (ints((n, *x2[:3])), x2[3:]) if x2 else (None, (0, 0))
    wt = ints((cout, k, k, cin + (x2[2] if x2 else 0)))
    return qx, wt, dict(qx2=qx2, offset=offset)


def _card_epilogue(g, cout, act, dtype, shuffle, n_q, store_float):
    def vec(lo, hi):
        return torch.rand(cout, generator=g, device="cuda") * (hi - lo) + lo

    q = dict(q_scales=tuple(torch.full((1,), v, device="cuda") for v in (0.05, 0.11)[:n_q]), store_float=store_float)
    if shuffle > 1:
        return Epilogue(bias=vec(-1, 1), act=act, out_dtype=dtype, shuffle=shuffle, **q)
    return Epilogue(bn_mul=vec(0.5, 1.5), bn_add=vec(-0.5, 0.5), act=act, out_dtype=dtype, **q)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _fast_path(cin, x2):
    """The shape route: every Cin (and second-source C) a multiple of 64."""
    return cin % 64 == 0 and (x2 is None or x2[2] % 64 == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,k,pad,act,dtype,shuffle,n_q,store_float,x2", CUDA_CASES)
def test_cuda_conv2d_int8_matches_twin(n, h, w, cin, cout, k, pad, act, dtype, shuffle, n_q, store_float, x2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(cin + cout + k)
    qx, wt, src = _card_inputs(g, n, h, w, cin, cout, k, x2)
    scale = torch.rand(cout, generator=g, device="cuda") * 9e-5 + 1e-5
    ep = _card_epilogue(g, cout, act, dtype, shuffle, n_q, store_float)
    before, by_path = conv2d_int8.launches, dict(conv2d_int8.launches_by_path)
    got = _as_tuple(conv2d_int8(qx, wt, pad=pad, scale=scale, epilogue=ep, **src))
    assert conv2d_int8.launches == before + 1
    path = PATHS[-1] if _fast_path(cin, x2) else "bytes"
    assert conv2d_int8.launches_by_path[path] == by_path[path] + 1
    want = _as_tuple(conv2d_int8_reference(qx, wt, pad=pad, scale=scale, epilogue=ep, **src))
    ones = torch.ones(cout, device="cuda")
    acc = conv2d_int8(qx, wt, pad=pad, scale=ones, epilogue=Epilogue(shuffle=shuffle), **src)
    acc_want = conv2d_int8_reference(qx, wt, pad=pad, scale=ones, epilogue=Epilogue(shuffle=shuffle), **src)
    torch.cuda.synchronize()
    assert [(a.shape, a.dtype) for a in got] == [(b.shape, b.dtype) for b in want]
    assert len(got) == n_q + store_float and got[-1].dtype == (dtype if store_float else torch.int8)
    torch.testing.assert_close(acc, acc_want, rtol=0, atol=0)  # the int32 sums (< 2^24 here)
    for a, b in zip(got, want):
        if act in ("relu", "none"):
            assert torch.equal(a, b)
        elif a.dtype == torch.int8:  # a float ulp may move one int8 step
            assert (a.int() - b.int()).abs().max() <= 1
        else:
            # libm's tanh/exp/log1p against PyTorch's: 1e-6, or one bf16 ulp
            torch.testing.assert_close(a.float(), b.float(), atol=1e-6,
                                       rtol=0 if dtype == torch.float32 else 2.0 ** -8)


@pytest.mark.cuda
@pytest.mark.parametrize("n_img", [1, 128])
@pytest.mark.parametrize("i", range(17))
def test_cuda_conv2d_int8_flagship_site(n_img, i):
    """Each of the flagship's 17 quantized convs at 1 and 64 dual frames,
    with its serving epilogue: bit for bit against the twin, on the fast
    mainloop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    launch = serving_launches(UNetConfig(), n_img, (160, 213))[i]
    g = torch.Generator(device="cuda").manual_seed(i)
    x2 = launch.x2_shape and (*launch.x2_shape[1:], *launch.offset)
    qx, wt, src = _card_inputs(g, *launch.x_shape, launch.cout, launch.k, x2)
    scale = torch.rand(launch.cout, generator=g, device="cuda") * 9e-5 + 1e-5
    ep = _card_epilogue(g, launch.cout, "relu", torch.bfloat16, 1, launch.n_q, launch.store_float)
    fast = conv2d_int8.launches_by_path[PATHS[-1]]
    got = _as_tuple(conv2d_int8(qx, wt, pad=1, scale=scale, epilogue=ep, **src))
    assert conv2d_int8.launches_by_path[PATHS[-1]] == fast + 1
    want = _as_tuple(conv2d_int8_reference(qx, wt, pad=1, scale=scale, epilogue=ep, **src))
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_conv2d_int8_past_2_31_elements():
    """up_3/conv1 at 250 dual frames: input and output pass 2^31 elements;
    the first and last images match the twin run on them alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    n, h, w, cin, cout = 500, 160, 213, 128, 64
    assert n * h * w * cin > 2 ** 31
    qx = torch.randint(-127, 128, (n, h, w, cin), generator=g, device="cuda", dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, 3, 3, cin), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.rand(cout, generator=g, device="cuda") * 1e-4
    ep = Epilogue(act="relu", out_dtype=torch.bfloat16, q_scales=(torch.full((1,), 0.05, device="cuda"),))
    fast = conv2d_int8.launches_by_path[PATHS[-1]]
    got_q, got = conv2d_int8(qx, wt, pad=1, scale=scale, epilogue=ep)
    assert conv2d_int8.launches_by_path[PATHS[-1]] == fast + 1
    for sl in (slice(0, 1), slice(n - 2, n)):
        want_q, want = conv2d_int8_reference(qx[sl], wt, pad=1, scale=scale, epilogue=ep)
        torch.testing.assert_close(got[sl], want, rtol=0, atol=0)
        assert torch.equal(got_q[sl], want_q)


@pytest.mark.cuda
def test_cuda_quantized_predictor_matches_cpu(bundle):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qp = bundle["port"].quantize(bundle["frames"], bundle["base"], quantize_upconvs=True)
    want = qp.predict_dual_frames(bundle["held"], bundle["base"], FRAME).numpy()
    on_card = QuantizedPredictor(qp.config, qp.q, compute_dtype=torch.float32)
    before = conv2d_int8.launches
    got = on_card.predict_dual_frames(bundle["held"], bundle["base"], FRAME).cpu().numpy()
    assert conv2d_int8.launches == before + 9 + 2  # 9 quantized sites + 2 int8 upconvs
    assert on_card.predict_dual_frames(bundle["held"], bundle["base"], FRAME).cpu().numpy().tobytes() == got.tobytes()
    assert _rmse(got, want) <= 0.05 * qp.delta_mm + 1e-6
