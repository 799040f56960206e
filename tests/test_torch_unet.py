"""The port's U-Net against the JAX package's ``unet_apply`` (eval mode),
on the same weights, carried across by ``params_from_jax``.

float32: both sides run full-precision float32 convs in another summation
order; 1e-4 is the bar tests/test_unet.py holds unet_apply to against torch.
bfloat16: both sides round at the same places, but the convs' internal
accumulation order differs, so a bf16 ulp can flip; the bar is that of
tests/test_unet.py::test_bf16_compute_close_to_f32, max error under 0.05 of
the output scale, held both against the float32 result and across packages.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.models.unet import UNetConfig as JaxUNetConfig, unet_apply
from gelslim_depth_tpu_torch.models import UNet, UNetConfig, load_torch_checkpoint, params_from_jax
from tests.torch_fixture import make_state_dict

DIMS = (8, 16, 32)


def _pair(rng, activation="relu", k=3):
    """Shared weights: (JAX cfg, params, stats) and the port's UNet."""
    sd = make_state_dict(rng, DIMS, k=k)
    jcfg = JaxUNetConfig(layer_dimensions=DIMS, kernel_size=k, activation=activation)
    params, stats = import_torch_state_dict(sd, jcfg)
    cfg = UNetConfig(layer_dimensions=DIMS, kernel_size=k, activation=activation)
    net = UNet(cfg)
    net.load_state_dict(params_from_jax(params, stats, cfg))
    return jcfg, params, stats, net, sd


@pytest.mark.parametrize(
    "activation,k", [("relu", 3), ("tanh", 3), ("mish", 3), ("relu", 5)]
)
def test_f32_matches_unet_apply(rng, activation, k):
    jcfg, params, stats, net, _ = _pair(rng, activation, k)
    x = rng.uniform(0, 1, (2, 3, 40, 53)).astype(np.float32)
    want, _ = unet_apply(jcfg, params, stats, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == np.asarray(want).shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("activation", ["relu", "tanh", "mish"])
def test_bf16_matches_unet_apply_bf16(rng, activation):
    jcfg, params, stats, net, _ = _pair(rng, activation)
    x = rng.uniform(0, 1, (2, 3, 32, 48)).astype(np.float32)
    y32, _ = unet_apply(jcfg, params, stats, jnp.asarray(x))
    y16, _ = unet_apply(jcfg, params, stats, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = net.to_compute_dtype(torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    scale = np.abs(np.asarray(y32)).max() + 1e-6
    assert np.abs(got - np.asarray(y32)).max() / scale < 0.05
    assert np.abs(got - np.asarray(y16)).max() / scale < 0.05


def test_reference_state_dict_loads_directly(rng, tmp_path):
    """A reference-layout state dict loads with load_state_dict (and from a
    torch.save file, num_batches_tracked included) and gives the output of
    import_torch_state_dict + unet_apply."""
    sd = make_state_dict(rng, DIMS)
    jcfg = JaxUNetConfig(layer_dimensions=DIMS)
    params, stats = import_torch_state_dict(sd, jcfg)
    x = rng.uniform(0, 1, (1, 3, 24, 33)).astype(np.float32)
    want, _ = unet_apply(jcfg, params, stats, jnp.asarray(x))

    cfg = UNetConfig(layer_dimensions=DIMS)
    net = UNet(cfg)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    path = str(tmp_path / "ref.pth")
    torch.save(net.state_dict(), path)
    net2 = UNet(cfg)
    net2.load_state_dict(load_torch_checkpoint(path, cfg))
    with torch.no_grad():
        for m in (net, net2):
            np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_params_from_jax_is_the_exact_inverse_of_import(rng):
    sd = make_state_dict(rng, DIMS)
    cfg = UNetConfig(layer_dimensions=DIMS)
    params, stats = import_torch_state_dict(sd, JaxUNetConfig(layer_dimensions=DIMS))
    back = params_from_jax(params, stats, cfg)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])


def test_load_torch_checkpoint_rejects_another_architecture(rng, tmp_path):
    sd = make_state_dict(rng, (4, 8))
    path = str(tmp_path / "small.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    with pytest.raises(ValueError):
        load_torch_checkpoint(path, UNetConfig(layer_dimensions=DIMS))


@pytest.mark.parametrize("dtype,user_flag", [
    (torch.float32, True), (torch.float32, False), (torch.bfloat16, True), (torch.bfloat16, False),
])
def test_float32_forward_turns_tf32_off_for_its_convs(rng, monkeypatch, dtype, user_flag):
    """float32 convs run with cudnn TF32 off whatever the caller set, as the
    JAX package runs them at Precision.HIGHEST; bfloat16 leaves the flag
    alone. The caller's flag is restored after the forward."""
    *_, net, _ = _pair(rng)
    net.to_compute_dtype(dtype)
    seen = []
    conv2d = F.conv2d

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*a, **kw)

    monkeypatch.setattr(F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", user_flag)
    with torch.no_grad():
        net(torch.zeros((1, 3, 16, 21)))
    assert seen and set(seen) == {user_flag and dtype != torch.float32}
    assert torch.backends.cudnn.allow_tf32 == user_flag


def test_folded_batch_norm_follows_load_and_is_not_saved(rng):
    """The eval BN fold is recomputed by load_state_dict and stays out of
    the state dict, which keeps the reference's keys."""
    sd = make_state_dict(rng, DIMS)
    net = UNet(UNetConfig(layer_dimensions=DIMS))
    assert set(net.state_dict()) == set(sd) | {
        k.replace("running_mean", "num_batches_tracked") for k in sd if k.endswith("running_mean")
    }
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    bn = net.inc.double_conv[4]
    inv = torch.rsqrt(bn.running_var + 1e-5) * bn.weight
    torch.testing.assert_close(net.inc.bn1_scale.view(-1), inv, rtol=0, atol=0)
    torch.testing.assert_close(net.inc.bn1_shift.view(-1), bn.bias - bn.running_mean * inv, rtol=0, atol=0)
