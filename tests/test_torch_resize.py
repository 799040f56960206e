"""The port's 'bilinear' and 'nearest' resizes (``ops.resize``) against
``jax.image.resize`` ('linear', antialiased when it downsamples, and
'nearest'), which the JAX package's ``ops.resize`` calls: on the serving
path's 320x427 -> 160x213, on upsampling, on axes that go both ways, in a
bake, and through ``fused_predict_dual``, whose non-area route is the
composed front end (it launches no kernel: the kernel hard-wires the area
resize) and matches the JAX package's XLA path.

Bar: rtol/atol 1e-6 on [0, 1] inputs (float32 contractions summed in
another order; the weight matrices are JAX's, bit for bit but for the
rounding of their normalizing sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.data.dataset import bake_dataset as jax_bake
from gelslim_depth_tpu.inference import fused_predict_dual as jax_fused_predict_dual
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.ops.resize import resize as jax_resize
from gelslim_depth_tpu_torch import GelslimConfig, Predictor, bake_dataset, inference, ops
from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object
from gelslim_depth_tpu_torch.ops.kernels import fused_preprocess_dual
from tests.torch_fixture import make_state_dict
from tests.torch_port_helpers import torch_threads

TOL = dict(rtol=1e-6, atol=1e-6)
METHODS = ("bilinear", "nearest")
SHAPES = [((2, 3, 320, 427), (160, 213)), ((1, 1, 160, 213), (320, 427)), ((2, 2, 33, 50), (70, 21))]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape,size", SHAPES, ids=["down_320x427", "up_160x213", "mixed"])
def test_resize_matches_jax_image_resize(method, shape, size):
    x = np.random.RandomState(0).uniform(0, 1, shape).astype(np.float32)
    got = ops.resize(torch.from_numpy(x), size, method).numpy()
    want = jax.image.resize(jnp.asarray(x), shape[:2] + size, "linear" if method == "bilinear" else "nearest")
    assert got.shape == shape[:2] + size and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_resize(jnp.asarray(x), size, method)), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_non_area_bake_matches_jax(method):
    objs = [make_synthetic_object(np.random.RandomState(2), n=4, image_size=(32, 43)) for _ in range(2)]
    kw = dict(use_difference_image=True, image_normalization_method="0_255_to_0_1", norm_scale=0.9,
              interp_method=method)
    got = bake_dataset(preloaded=objs, device="cpu", **kw)
    want = jax_bake(preloaded=objs, **kw)
    np.testing.assert_allclose(got.tactile_image.numpy(), np.asarray(want.tactile_image), **TOL)
    np.testing.assert_allclose(got.depth_image.numpy(), np.asarray(want.depth_image), **TOL)
    np.testing.assert_allclose(got.depth_normalization_parameters, want.depth_normalization_parameters, **TOL)
    for a, b in zip(got.image_normalization_parameters, want.image_normalization_parameters):
        np.testing.assert_allclose(a, b, **TOL)


def _bilinear_setup():
    cfg = dict(CNN_dimensions=(8, 16, 32), input_tactile_image_size=(40, 53), image_normalization_method="0_255_to_0_1",
               depth_normalization_method="min_max_to_0_-1", depth_normalization_parameters=(-1.9, 0.0),
               norm_scale=0.9, use_difference_image=True, interp_method="bilinear")
    rng = np.random.RandomState(9)
    sd = make_state_dict(rng, (8, 16, 32))
    frames = rng.uniform(0, 255, (2, 6, 80, 107)).astype(np.float32)
    return cfg, sd, frames, frames[0] * 0.5


def test_bilinear_serving_takes_the_composed_route_and_matches_jax(monkeypatch):
    cfg, sd, frames, base = _bilinear_setup()
    pred = Predictor(GelslimConfig(**cfg), sd, device="cpu")

    def no_kernel(*a, **k):
        raise AssertionError("the kernel front end hard-wires the area resize")

    monkeypatch.setattr(inference, "kernel_front_end", no_kernel)
    with torch.no_grad():
        got = inference.fused_predict_dual(pred.config, pred.net, torch.from_numpy(frames), torch.from_numpy(base),
                                           (80, 107), use_kernel=True).numpy()
    jcfg = JaxConfig(**cfg)
    params, stats = import_torch_state_dict(sd, jcfg.unet_config())
    want = jax_fused_predict_dual(jcfg, jcfg.unet_config(), params, stats, jnp.asarray(frames), jnp.asarray(base),
                                  (80, 107), use_pallas=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)  # the serving bar (test_inference.py)


@pytest.mark.cuda
def test_bilinear_serving_launches_no_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, sd, frames, base = _bilinear_setup()
    pred = Predictor(GelslimConfig(**cfg), sd, device="cuda")
    before = fused_preprocess_dual.launches
    got = pred.predict_dual_frames(frames, base, (80, 107))
    torch.cuda.synchronize()
    assert fused_preprocess_dual.launches == before
    want = Predictor(GelslimConfig(**cfg), sd, device="cpu").predict_dual_frames(frames, base, (80, 107))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
