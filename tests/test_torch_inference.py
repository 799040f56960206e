"""The port's Predictor against the JAX package's Predictor, given the same
weights, plus the checkpoint and config files crossing between packages.

Bars: mm RMSE < 0.05 and rtol/atol 1e-3 against JAX, those of
tests/test_inference.py; 1e-5 between the port's kernel route and composed
route, which differ only in the front end's float32 summation order.
On the CPU the kernel route computes the kernel's plain twin.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.inference import Predictor as JaxPredictor
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.train.checkpoint import save_weights
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor, fused_predict_dual, predict_depth_from_RGB
from tests.torch_fixture import make_state_dict

DIMS = (8, 16, 32)
CFG_KW = dict(
    CNN_dimensions=DIMS,
    input_tactile_image_size=(40, 53),
    depth_normalization_parameters=(-1.9180814027786255, 0.0),
    image_normalization_method="0_255_to_0_1",
    depth_normalization_method="min_max_to_0_-1",
    norm_scale=0.9,
)
OUT = (80, 107)


@pytest.fixture(scope="module")
def bundle():
    rng = np.random.RandomState(42)
    sd = make_state_dict(rng, DIMS)
    jcfg = JaxConfig(**CFG_KW)
    params, stats = import_torch_state_dict(sd, jcfg.unet_config())
    cfg = GelslimConfig(**CFG_KW)
    return {
        "rng": rng,
        "sd": sd,
        "jax": JaxPredictor(jcfg, params, stats),
        "port": Predictor(cfg, sd, device="cpu"),
        "params": params,
        "stats": stats,
    }


def _routes(pred, frames, base):
    """(kernel route, composed route): on the CPU, Predictor takes the
    composed route; the kernel route is asked of fused_predict_dual."""
    b = None if base is None else torch.from_numpy(base)
    with torch.no_grad():
        k = fused_predict_dual(pred.config, pred.net, torch.from_numpy(frames), b, OUT, use_kernel=True)
    return k.numpy(), pred.predict_dual_frames(frames, base, OUT).numpy()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse < 0.05, f"mm RMSE {rmse} exceeds the parity gate"
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_dual_frames_shared_base_both_routes(bundle):
    rng = bundle["rng"]
    frames = rng.uniform(0, 255, (3, 6, *OUT)).astype(np.float32)
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    want = bundle["jax"].predict_dual_frames(frames, base, OUT)
    got_k, got_c = _routes(bundle["port"], frames, base)
    assert got_k.shape == (3, 2, *OUT)
    _close(got_k, want)
    _close(got_c, want)
    np.testing.assert_allclose(got_k, got_c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("base_kind", ["batched", "none"])
def test_dual_frames_batched_or_missing_base(bundle, base_kind):
    rng = bundle["rng"]
    frames = rng.uniform(0, 255, (2, 6, *OUT)).astype(np.float32)
    base = rng.uniform(0, 255, (2, 6, *OUT)).astype(np.float32) if base_kind == "batched" else None
    want = bundle["jax"].predict_dual_frames(frames, base, OUT)
    got_k, got_c = _routes(bundle["port"], frames, base)
    _close(got_k, want)
    np.testing.assert_allclose(got_k, got_c, rtol=1e-5, atol=1e-5)


def test_predict_depth_from_rgb(bundle):
    rng = bundle["rng"]
    images = rng.uniform(0, 255, (2, 3, *OUT)).astype(np.float32)
    want = bundle["jax"].predict_depth_from_RGB(images, (40, 53))
    got = bundle["port"].predict_depth_from_RGB(images, (40, 53))
    _close(got.numpy(), want)
    wrapped = predict_depth_from_RGB(images, bundle["port"], (40, 53))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


def test_dual_frames_multi(bundle):
    rng = bundle["rng"]
    frames = [rng.uniform(0, 255, (1, 6, *OUT)).astype(np.float32) for _ in range(3)]
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    want = bundle["jax"].predict_dual_frames_multi(frames, base, OUT)
    got = bundle["port"].predict_dual_frames_multi(frames, base, OUT).numpy()
    assert got.shape == (3, 2, *OUT)
    _close(got, want)
    one = bundle["port"].predict_dual_frames(frames[1], base, OUT).numpy()
    np.testing.assert_allclose(got[1:2], one, rtol=1e-6, atol=1e-6)


def test_bf16_dual_frames(bundle):
    rng = bundle["rng"]
    frames = rng.uniform(0, 255, (2, 6, *OUT)).astype(np.float32)
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    jcfg = JaxConfig(**CFG_KW)
    want = JaxPredictor(
        jcfg, bundle["params"], bundle["stats"], compute_dtype=jnp.bfloat16
    ).predict_dual_frames(frames, base, OUT)
    got = Predictor(
        GelslimConfig(**CFG_KW), bundle["sd"], device="cpu", compute_dtype=torch.bfloat16
    ).predict_dual_frames(frames, base, OUT)
    assert got.dtype == torch.float32
    rmse = float(np.sqrt(np.mean((got.numpy() - np.asarray(want)) ** 2)))
    assert rmse < 0.05, f"bf16 mm RMSE {rmse} exceeds the parity gate"


def test_jax_checkpoint_dir_loads(bundle, tmp_path):
    """A save_weights directory (npz + json, and its torch .pth) written by
    the JAX package serves the same depth through the port."""
    rng = bundle["rng"]
    jcfg = JaxConfig(weights_name="unet_t", **CFG_KW)
    save_weights(str(tmp_path), jcfg, bundle["params"], bundle["stats"])
    frames = rng.uniform(0, 255, (1, 6, *OUT)).astype(np.float32)
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    want = JaxPredictor.from_checkpoint(str(tmp_path)).predict_dual_frames(frames, base, OUT)
    pred = Predictor.from_checkpoint(str(tmp_path), device="cpu")
    assert dataclasses.asdict(pred.config) == dataclasses.asdict(GelslimConfig(weights_name="unet_t", **CFG_KW))
    _close(pred.predict_dual_frames(frames, base, OUT).numpy(), want)
    pred_pth = Predictor.from_torch_checkpoint(str(tmp_path / "unet_t.pth"), pred.config, device="cpu")
    _close(pred_pth.predict_dual_frames(frames, base, OUT).numpy(), want)


def test_checkpoint_name_resolution(tmp_path):
    from gelslim_depth_tpu.train.checkpoint import _resolve_checkpoint_name as jax_resolve
    from gelslim_depth_tpu_torch.train.checkpoint import _resolve_checkpoint_name

    for names in (["unet"], ["unet", "unet_epoch200"], ["unet_epoch5", "unet_epoch40"]):
        d = tmp_path / "_".join(names)
        d.mkdir()
        for n in names:
            (d / f"{n}.json").write_text("{}")
        assert _resolve_checkpoint_name(str(d)) == jax_resolve(str(d))
    d = tmp_path / "ambiguous"
    d.mkdir()
    for n in ("a", "b"):
        (d / f"{n}.json").write_text("{}")
    with pytest.raises(ValueError):
        _resolve_checkpoint_name(str(d))


def test_config_files_cross_between_packages(tmp_path):
    kw = dict(CFG_KW, image_normalization_method="mean_std",
              image_normalization_parameters=((1.0, 2.0, 3.0), (250.0, 240.0, 230.0), (100.0,), (30.0,)),
              exclude_objects=["cube"], activation_func="mish")
    jcfg, pcfg = JaxConfig(**kw), GelslimConfig(**kw)
    jcfg.save_json(str(tmp_path / "jax.json"))
    pcfg.save_json(str(tmp_path / "port.json"))
    assert dataclasses.asdict(GelslimConfig.from_json(str(tmp_path / "jax.json"))) == dataclasses.asdict(pcfg)
    assert dataclasses.asdict(JaxConfig.from_json(str(tmp_path / "port.json"))) == dataclasses.asdict(jcfg)
    pcfg.emit_python_config(str(tmp_path / "config_port.py"))
    assert dataclasses.asdict(JaxConfig.from_python_module(str(tmp_path / "config_port.py"))) == dataclasses.asdict(jcfg)
    assert pcfg.tactile_normalization_method == "mean_std"
    assert pcfg.unet_config().activation == "mish"
