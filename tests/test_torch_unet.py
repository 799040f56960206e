"""The port's U-Net against the JAX package's ``unet_apply`` (eval mode),
on the same weights, carried across by ``params_from_jax``.

float32: both sides run full-precision float32 convs in another summation
order; 1e-4 is the bar tests/test_unet.py holds unet_apply to against torch.
bfloat16: both sides round at the same places, but the convs' internal
accumulation order differs, so a bf16 ulp can flip; the bar is that of
tests/test_unet.py::test_bf16_compute_close_to_f32, max error under 0.05 of
the output scale, held both against the float32 result and across packages.
"""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.models.unet import UNetConfig as JaxUNetConfig, unet_apply
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.export import ExportedPredictor, export_predictor
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.models import UNet, UNetConfig, load_torch_checkpoint, params_from_jax
from gelslim_depth_tpu_torch.models import unet as unet_module
from gelslim_depth_tpu_torch.models.unet import is_batch_stat, unet_apply as torch_unet_apply
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


def _layout(t: torch.Tensor) -> str:
    if t.is_contiguous():
        return "nchw"
    return "channels_last" if t.is_contiguous(memory_format=torch.channels_last) else "strided"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_layout_follows_the_compute_dtype(rng, monkeypatch, dtype):
    """bfloat16 runs channels-last end to end: every conv site's input and
    every conv and upconv weight cuDNN gets; float32 stays NCHW. At 42x53
    the decoder's Up blocks pad. Both return NCHW-contiguous float32 logits
    within the bar of their dtype against the JAX graph."""
    jcfg, params, stats, net, _ = _pair(rng)
    net.to_compute_dtype(dtype)
    want_layout = "channels_last" if dtype == torch.bfloat16 else "nchw"
    seen, convs = {}, []
    for name in ("conv2d", "conv_transpose2d"):
        fn = getattr(F, name)

        def spy(x, w, *a, _fn=fn, _name=name, **kw):
            convs.append((_name, _layout(x), _layout(w)))
            return _fn(x, w, *a, **kw)

        monkeypatch.setattr(F, name, spy)
    x = rng.uniform(0, 1, (2, 3, 42, 53)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x), probe=lambda site, h: seen.setdefault(site, (_layout(h), h.dtype)))

    assert len(seen) == 12 and set(seen.values()) == {(want_layout, dtype)}
    assert [c[0] for c in convs].count("conv_transpose2d") == 2 and len(convs) == 13
    # the head's (1, 8, 1, 1) weight is both; every other weight is the layout's
    assert {c[1:] for c in convs[:-1]} == {(want_layout, want_layout)} and convs[-1][1] == want_layout
    assert got.dtype == torch.float32 and got.shape == (2, 1, 42, 53) and got.is_contiguous()
    got = got.numpy()
    y32, _ = unet_apply(jcfg, params, stats, jnp.asarray(x))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, np.asarray(y32), rtol=1e-4, atol=1e-4)
    else:
        y16, _ = unet_apply(jcfg, params, stats, jnp.asarray(x), compute_dtype=jnp.bfloat16)
        scale = np.abs(np.asarray(y32)).max() + 1e-6
        assert np.abs(got - np.asarray(y32)).max() / scale < 0.05
        assert np.abs(got - np.asarray(y16)).max() / scale < 0.05


def test_bf16_channels_last_weights_keep_the_state_dict(rng, tmp_path):
    """The bf16 net's channels-last weights are the reference's state dict:
    its keys and shapes, the values of a fresh load cast to bfloat16. A
    plain NCHW state dict loads into it, the weights stay channels-last and
    the logits do not move; ``export_predictor`` serves them as the live
    predictor does."""
    *_, net, sd = _pair(rng)
    fresh = UNet(net.cfg)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    net.to_compute_dtype(torch.bfloat16)
    got, ref = net.state_dict(), fresh.state_dict()
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    convs = {f"{name}.{p}" for name, m in net.named_modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
             for p in ("weight", "bias") if getattr(m, p) is not None}
    assert len(convs) == 5 * 2 + 2 * 2 + 2  # DoubleConvs, upconvs with their biases, the head
    for k, v in got.items():
        assert v.dtype == (torch.bfloat16 if k in convs else ref[k].dtype), k
        torch.testing.assert_close(v, ref[k].to(v.dtype), rtol=0, atol=0, msg=k)
        assert v.ndim != 4 or v.is_contiguous(memory_format=torch.channels_last), k

    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 24, 33)).astype(np.float32))
    with torch.no_grad():
        before = net(x)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        after = net(x)
    assert all(v.is_contiguous(memory_format=torch.channels_last) for v in net.state_dict().values() if v.ndim == 4)
    torch.testing.assert_close(after, before, rtol=0, atol=0)

    cfg = GelslimConfig(CNN_dimensions=DIMS, input_tactile_image_size=(24, 33), use_difference_image=True,
                        depth_normalization_method="min_max_to_0_-1", depth_normalization_parameters=(-1.9, 0.0))
    pred = Predictor(cfg, sd, compute_dtype=torch.bfloat16, device="cpu")
    frames = rng.uniform(0, 255, (2, 6, 48, 66)).astype(np.float32)
    base = rng.uniform(0, 255, (6, 48, 66)).astype(np.float32)
    path = export_predictor(pred, (48, 66), path=str(tmp_path / "bf16.gsx"), batch_sizes=(2,), frame_size=(48, 66))
    served = ExportedPredictor.load(path)
    assert served.meta["kind"] == "bf16"
    torch.testing.assert_close(served(frames, base), pred.predict_dual_frames(frames, base, (48, 66)),
                               rtol=1e-6, atol=1e-6)


# -- the bf16 graph's concat buffers, written by their producers --------------------


class _Stores:
    """``models/unet.py``'s ``conv_epilogue``, counted: calls, and calls
    that stored into destinations (``into``)."""

    def __init__(self, monkeypatch):
        self.calls = self.into = 0
        real = unet_module.conv_epilogue

        def counted(y, **kw):
            self.calls += 1
            self.into += kw.get("into") is not None
            return real(y, **kw)

        monkeypatch.setattr(unet_module, "conv_epilogue", counted)


class _TwoBands:
    """Height-sharded serving's halo exchange between two bands run in two
    threads of one process: ``halo(rank)(x, dim)`` is x with the row of the
    band above before it and of the band below after it, zeros at the
    image's edges, as ``parallel.HeightHalo`` gives it across ranks."""

    def __init__(self):
        self.barrier = threading.Barrier(2)
        self.rows = [None, None]

    def halo(self, rank):
        def exchange(x, dim):
            first, last = x.narrow(dim, 0, 1), x.narrow(dim, x.shape[dim] - 1, 1)
            self.rows[rank] = (first, last)
            self.barrier.wait()
            top = self.rows[0][1] if rank == 1 else torch.zeros_like(first)
            bottom = self.rows[1][0] if rank == 0 else torch.zeros_like(last)
            self.barrier.wait()
            return torch.cat([top, x, bottom], dim)

        return exchange


def _sharded(params, stats, cfg, x, rows):
    """unet_apply's bf16 eval logits of x over two height bands (rows of x
    in the first), each band in its own thread, stacked."""
    bands, out = _TwoBands(), [None, None]

    def run(rank):
        band = x[:, :, :rows] if rank == 0 else x[:, :, rows:]
        out[rank] = torch_unet_apply(cfg, params, stats, band, compute_dtype=torch.bfloat16,
                                     halo=bands.halo(rank))[0]

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return torch.cat(out, 2)


@pytest.mark.parametrize("route", ["plain", "probe", "height_sharded"])
def test_bf16_concat_in_place_equals_pad_and_cat(rng, monkeypatch, route):
    """The bf16 channels-last eval forward, whose up blocks read one buffer
    that the skip's last epilogue and the upconv's epilogue write, equals
    the pad + concat composition bit for bit: at 20x27 each Up block pads a
    column. Plain, with a probe (which sees the same inputs at every conv),
    and over two height bands with halos. The new route stores into 2 (L -
    1) destinations a call and launches as many epilogues as the old."""
    *_, net, sd = _pair(rng)
    net.to_compute_dtype(torch.bfloat16)
    cfg = net.cfg
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 20, 27)).astype(np.float32))
    params = {k: torch.from_numpy(v) for k, v in sd.items() if not is_batch_stat(k)}
    stats = {k: torch.from_numpy(v) for k, v in sd.items() if is_batch_stat(k)}
    L = len(DIMS)
    got, seen = {}, {}
    for in_place in (True, False):
        with monkeypatch.context() as m:
            stores = _Stores(m)
            if not in_place:
                m.setattr(unet_module, "_concat_in_place", lambda y, fmt, dtype: False)
            probed = seen.setdefault(in_place, [])
            with torch.no_grad():
                if route == "height_sharded":
                    got[in_place] = _sharded(params, stats, cfg, x, rows=8)
                else:
                    probe = (lambda site, h: probed.append((site, h.clone()))) if route == "probe" else None
                    got[in_place] = net(x, probe=probe)
        assert stores.into == (2 * (L - 1) * (2 if route == "height_sharded" else 1) if in_place else 0)
        assert stores.calls == (2 * (2 * L - 1) + (L - 1)) * (2 if route == "height_sharded" else 1)
    assert got[True].shape == (2, 1, 20, 27) and torch.equal(got[True], got[False])
    if route == "probe":
        assert [s for s, _ in seen[True]] == [s for s, _ in seen[False]]
        assert len(seen[True]) == 2 * (2 * L - 1) + (L - 1)
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(seen[True], seen[False]))


def test_training_and_nchw_routes_store_into_nothing(rng, monkeypatch):
    """Only bf16 channels-last eval writes concat buffers in place: the
    float32 NCHW eval forward, a bf16 eval forward that autograd records,
    and a bf16 train step pad and concatenate, and store into nothing."""
    *_, net, sd = _pair(rng)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 20, 27)).astype(np.float32))
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in sd.items() if not is_batch_stat(k)}
    stats = {k: torch.from_numpy(v) for k, v in sd.items() if is_batch_stat(k)}
    stores = _Stores(monkeypatch)
    with torch.no_grad():
        net(x)  # float32, NCHW
    assert stores.calls == 2 * (2 * len(DIMS) - 1) + len(DIMS) - 1
    net.to_compute_dtype(torch.bfloat16)
    net(x).sum().backward()  # autograd records: the aten chain
    torch_unet_apply(net.cfg, params, stats, x, train=True, compute_dtype=torch.bfloat16)[0].sum().backward()
    assert stores.into == 0
