"""The port's NHWC (``channels_last``) layout against its NCHW default and
against the JAX package's NHWC, on the same weights and inputs made with
numpy from a seed, on the CPU: ``unet_apply`` (eval and train), the NHWC
bake, the NHWC Trainer, its layout-mismatch refusal, and the int8 graph
(``unet_apply_int8``, ``calibrate_act_scales``, ``quantize_unet``).

Bars: the U-Net at JAX's NHWC bar, rtol/atol 1e-5 (tests/test_unet.py:85);
the Trainer's losses at JAX's NHWC-training bar, rtol 1e-5 / atol 1e-7
(tests/test_trainer.py:297), against the port's NCHW run and, at the
port-vs-JAX Trainer bar of tests/test_torch_trainer.py (rtol 1e-4: float32
training in another summation order), against JAX's NHWC run; the bake
bit for bit to JAX's; the int8 graph NHWC bit for bit to NCHW, and within
the port-vs-JAX int8 bar of tests/test_torch_quantize.py (RMSE <= 0.05 *
float_delta + 1e-6) of JAX's NHWC int8 graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.data.dataset import bake_dataset as jax_bake
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.models.unet import UNetConfig as JaxUNetConfig
from gelslim_depth_tpu.models.unet import unet_apply as jax_unet_apply
from gelslim_depth_tpu.models.quantize import unet_apply_int8 as jax_unet_apply_int8
from gelslim_depth_tpu.train import Trainer as JaxTrainer
from gelslim_depth_tpu_torch import GelslimConfig, Trainer, bake_dataset
from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object
from gelslim_depth_tpu_torch.models import UNet
from gelslim_depth_tpu_torch.models.quantize import calibrate_act_scales, quantize_unet, unet_apply_int8
from gelslim_depth_tpu_torch.models.unet import UNetConfig, split_state_dict, unet_apply
from tests.test_torch_parallel_serving import _jax_quantized
from tests.torch_fixture import make_state_dict
from tests.torch_port_helpers import torch_threads

DIMS = (8, 16, 32)
CFG = UNetConfig(layer_dimensions=DIMS)
JCFG = JaxUNetConfig(layer_dimensions=DIMS)
TOL = dict(rtol=1e-5, atol=1e-5)
BAKE = dict(use_difference_image=True, image_normalization_method="0_255_to_0_1", norm_scale=0.9)
TRAIN_CFG = dict(weights_name="nhwc", CNN_dimensions=(8, 16), batch_size=8, input_tactile_image_size=(16, 21),
                 image_normalization_method="0_255_to_0_1", depth_normalization_method="min_max_to_0_-1",
                 norm_scale=0.9, use_difference_image=True, training_learning_rate=3e-3)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.RandomState(5)
    sd = make_state_dict(rng, DIMS)
    x = rng.uniform(0, 1, (2, 3, 24, 33)).astype(np.float32)
    return sd, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unet_apply_nhwc_matches_nchw_and_jax(weights, train):
    sd, x = weights
    params, stats = split_state_dict(sd)
    y_cf, s_cf = unet_apply(CFG, params, stats, torch.from_numpy(x), train=train)
    y_cl, s_cl = unet_apply(CFG, params, stats, torch.from_numpy(_nhwc(x)), train=train, channels_last=True)
    assert tuple(y_cl.shape) == (2, 24, 33, 1)
    np.testing.assert_allclose(y_cl.permute(0, 3, 1, 2).numpy(), y_cf.numpy(), **TOL)
    for k in s_cf:
        np.testing.assert_allclose(s_cl[k].numpy(), s_cf[k].numpy(), **TOL)
    jp, js = import_torch_state_dict(sd, JCFG)
    want, _ = jax_unet_apply(JCFG, jp, js, jnp.asarray(_nhwc(x)), train=train, channels_last=True)
    np.testing.assert_allclose(y_cl.numpy(), np.asarray(want), **TOL)


def test_nhwc_bake_matches_jax():
    objs = [make_synthetic_object(np.random.RandomState(6), n=4, image_size=(32, 43)) for _ in range(2)]
    got = bake_dataset(preloaded=objs, device="cpu", channels_last=True, **BAKE)
    want = jax_bake(preloaded=objs, channels_last=True, **BAKE)
    assert got.channels_last and want.channels_last and tuple(got.tactile_image.shape) == (16, 16, 21, 3)
    np.testing.assert_array_equal(got.tactile_image.numpy(), np.asarray(want.tactile_image))
    np.testing.assert_array_equal(got.depth_image.numpy(), np.asarray(want.depth_image))
    nchw = bake_dataset(preloaded=objs, device="cpu", **BAKE)
    assert torch.equal(got.tactile_image, nchw.tactile_image.permute(0, 2, 3, 1))


def _splits(channels_last, bake=bake_dataset, **kw):
    rng = np.random.RandomState(3)
    objs = [make_synthetic_object(rng, n=8, image_size=(32, 43)) for _ in range(2)]
    val_objs = [make_synthetic_object(rng, n=4, image_size=(32, 43))]
    train = bake(preloaded=objs, channels_last=channels_last, **BAKE, **kw)
    val = bake(preloaded=val_objs, channels_last=channels_last, **BAKE, **kw,
               depth_normalization_parameters=train.depth_normalization_parameters,
               image_normalization_parameters=train.image_normalization_parameters)
    return train, val


def test_nhwc_trainer_matches_nchw_and_jax(tmp_path):
    sd = make_state_dict(np.random.RandomState(1), (8, 16))
    start = {k: torch.from_numpy(v) for k, v in sd.items()}
    hist = {}
    for cl in (False, True):
        train, val = _splits(cl, device="cpu")
        tr = Trainer(GelslimConfig(**TRAIN_CFG), train, val, val, output_dir=str(tmp_path / f"port{cl}"),
                     device="cpu", starting_weights=start, enable_plots=False, log_fn=lambda m: None)
        assert tr.channels_last == cl
        hist[cl] = tr.fit(max_epochs=3)
    for k in ("train_loss", "validation_loss"):
        np.testing.assert_allclose(hist[True][k], hist[False][k], rtol=1e-5, atol=1e-7, err_msg=k)
    train, val = _splits(True, bake=jax_bake)
    jcfg = JaxConfig(**TRAIN_CFG)
    jtr = JaxTrainer(jcfg, train, val, val, output_dir=str(tmp_path / "jax"), enable_plots=False,
                     starting_weights=import_torch_state_dict(sd, jcfg.unet_config()), log_fn=lambda m: None)
    want = jtr.fit(max_epochs=3)
    for k in ("train_loss", "validation_loss"):
        np.testing.assert_allclose(hist[True][k], want[k], rtol=1e-4, err_msg=k)


def test_layout_mismatch_refused(tmp_path):
    train, _ = _splits(True, device="cpu")
    _, val = _splits(False, device="cpu")
    with pytest.raises(ValueError, match="val split layout"):
        Trainer(GelslimConfig(**TRAIN_CFG), train, val, train, output_dir=str(tmp_path), device="cpu",
                enable_plots=False, log_fn=lambda m: None)


def test_int8_graph_nhwc(weights):
    sd, x = weights
    net = UNet(CFG)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    x_cf, x_cl = torch.from_numpy(x), torch.from_numpy(_nhwc(x))
    assert calibrate_act_scales(net, x_cl, channels_last=True) == calibrate_act_scales(net, x_cf)
    q_cl, q_cf = quantize_unet(net, x_cl, channels_last=True), quantize_unet(net, x_cf)
    assert q_cl.act_scales() == q_cf.act_scales() and float(q_cl.float_delta) == float(q_cf.float_delta)
    for dtype in (torch.float32, torch.bfloat16):
        got = unet_apply_int8(q_cl, x_cl, channels_last=True, compute_dtype=dtype)
        assert tuple(got.shape) == (2, 24, 33, 1)
        assert torch.equal(got.permute(0, 3, 1, 2), unet_apply_int8(q_cf, x_cf, compute_dtype=dtype))
    got = unet_apply_int8(q_cl, x_cl, channels_last=True, compute_dtype=torch.float32).numpy()
    want = np.asarray(jax_unet_apply_int8(_jax_quantized(q_cl, JCFG), jnp.asarray(_nhwc(x)), channels_last=True,
                                          compute_dtype=jnp.float32))
    assert float(np.sqrt(np.mean(np.square(got - want)))) <= 0.05 * float(q_cl.float_delta) + 1e-6
