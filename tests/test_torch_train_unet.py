"""The port's functional U-Net in train mode against the JAX package's
``unet_apply(train=True)``, on the same weights and inputs (made with numpy
from a seed, the weights carried by ``params_from_jax``).

float32: both run full float32 convs and float32 batch statistics in
another summation order; outputs and new running statistics agree to 1e-4,
the bar tests/test_unet.py holds unet_apply to against torch.
bfloat16: the JAX reference runs in a subprocess with XLA's excess
precision off, so it rounds where ``unet_apply`` says (in process, XLA's CPU
backend skips the bf16 rounding of a conv output read in float32). The
convs accumulate in another order, so a bf16 ulp (2^-8 relative) can flip
at any rounding point and batch normalization carries it on: the bar is a
max error under 0.05 of the output's spread and an RMSE under 0.01 of it
(tests/test_unet.py::test_bf16_compute_close_to_f32 holds bf16 to 0.05),
and running statistics at rtol 2e-2 / atol 1e-3.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.models.unet import UNetConfig as JaxUNetConfig, unet_apply as jax_unet_apply
from gelslim_depth_tpu_torch.models import UNet, UNetConfig, params_from_jax
from gelslim_depth_tpu_torch.models.unet import split_state_dict, unet_apply
from gelslim_depth_tpu_torch.train.steps import make_optimizer, make_train_step, create_train_state
from tests.torch_fixture import make_state_dict
from tests.torch_port_helpers import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (8, 16, 32)
HW = (20, 27)  # pools to 10x13 and 5x6: the decoder pads its upconv output
HW_K5 = (40, 54)  # 5x5 convs at padding 1 shrink each level by 4
MASK = np.array([True, True, False, True, False])



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield

def _case(seed, activation="relu", k=3):
    """Seeded weights and input: (JAX cfg, params, stats), the port's
    (cfg, params, stats) carried by params_from_jax, x, and the state dict."""
    rng = np.random.RandomState(seed)
    sd = make_state_dict(rng, DIMS, k=k)
    jcfg = JaxUNetConfig(layer_dimensions=DIMS, kernel_size=k, activation=activation)
    params, stats = import_torch_state_dict(sd, jcfg)
    cfg = UNetConfig(layer_dimensions=DIMS, kernel_size=k, activation=activation)
    p, s = split_state_dict(params_from_jax(params, stats, cfg))
    x = rng.uniform(-1, 1, (len(MASK), 3, *(HW if k == 3 else HW_K5))).astype(np.float32)
    return jcfg, params, stats, cfg, p, s, x, sd


@pytest.mark.parametrize("activation,k,masked", [
    ("relu", 3, False), ("relu", 3, True), ("tanh", 3, False), ("tanh", 3, True),
    ("mish", 3, False), ("mish", 3, True), ("relu", 5, True),
])
def test_train_forward_matches_jax(activation, k, masked):
    jcfg, params, stats, cfg, p, s, x, _ = _case(1, activation, k)
    mask = MASK if masked else None
    want, want_stats = jax_unet_apply(jcfg, params, stats, jnp.asarray(x), train=True,
                                      sample_mask=None if mask is None else jnp.asarray(mask))
    got, got_stats = unet_apply(cfg, p, s, torch.from_numpy(x), train=True,
                                sample_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    want_s = split_state_dict(params_from_jax(params, want_stats, cfg))[1]
    assert set(got_stats) == set(want_s) == set(s)
    for key in s:
        np.testing.assert_allclose(got_stats[key].numpy(), want_s[key].numpy(), rtol=1e-4, atol=1e-4, err_msg=key)
        assert not torch.equal(got_stats[key], s[key]), f"{key} was not updated"


def test_masked_statistics_ignore_padded_samples():
    """Padded samples change neither the valid outputs nor the statistics."""
    *_, cfg, p, s, x, _ = _case(2)
    m = torch.from_numpy(MASK)
    got, got_stats = unet_apply(cfg, p, s, torch.from_numpy(x), train=True, sample_mask=m)
    x2 = x.copy()
    x2[~MASK] = 7.0
    got2, got_stats2 = unet_apply(cfg, p, s, torch.from_numpy(x2), train=True, sample_mask=m)
    torch.testing.assert_close(got[m], got2[m], rtol=1e-6, atol=1e-6)
    for key in s:
        torch.testing.assert_close(got_stats[key], got_stats2[key], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_mode_equals_the_eval_module(dtype):
    """unet_apply(train=False) folds the BN on the fly from the given
    statistics; on the same weights it equals UNet's folded eval forward."""
    *_, cfg, p, s, x, _ = _case(3)
    net = UNet(cfg)
    net.load_state_dict({**p, **s})
    net.to_compute_dtype(dtype)
    with torch.no_grad():
        want = net(torch.from_numpy(x))
        got, same = unet_apply(cfg, p, s, torch.from_numpy(x), compute_dtype=dtype)
    assert same is s
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_float64_runs_the_whole_graph_in_float64():
    """compute_dtype float64, the reference a float32 step's gradients are
    held to on the card: float64 logits and statistics, float32's within
    its rounding."""
    *_, cfg, p, s, x, _ = _case(7)
    m = torch.from_numpy(MASK)
    out64, st64 = unet_apply(cfg, p, s, torch.from_numpy(x), train=True, compute_dtype=torch.float64, sample_mask=m)
    out32, st32 = unet_apply(cfg, p, s, torch.from_numpy(x), train=True, sample_mask=m)
    assert out64.dtype == torch.float64 and all(v.dtype == torch.float64 for v in st64.values())
    torch.testing.assert_close(out32.double(), out64, rtol=1e-4, atol=1e-5)
    for k in s:
        torch.testing.assert_close(st32[k].double(), st64[k], rtol=1e-4, atol=1e-6)


def test_remat_equals_no_remat():
    """Recomputation under torch.utils.checkpoint gives the same output,
    statistics (momentum applied once) and gradients."""
    *_, cfg, p, s, x, _ = _case(4)
    xs, m = torch.from_numpy(x), torch.from_numpy(MASK)
    results = []
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        out, stats = unet_apply(cfg, leaves, s, xs, train=True, remat=remat, sample_mask=m)
        grads = torch.autograd.grad(out.square().mean(), list(leaves.values()))
        results.append((out.detach(), stats, dict(zip(leaves, grads))))
    (o1, s1, g1), (o2, s2, g2) = results
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    for key in s:
        torch.testing.assert_close(s1[key], s2[key], rtol=0, atol=0)
    for key in p:
        torch.testing.assert_close(g1[key], g2[key], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dtype,user_flag", [
    (torch.float32, True), (torch.float32, False), (torch.bfloat16, True), (torch.bfloat16, False),
])
def test_float32_step_holds_tf32_off_across_the_backward(monkeypatch, dtype, user_flag):
    """A float32 train step keeps cuDNN TF32 off in every conv of the
    forward and of the backward (read from hooks on the conv outputs, which
    run while their gradients are computed), whatever the caller set;
    bfloat16 leaves the flag alone. The caller's flag is restored after the
    step."""
    *_, cfg, p, s, x, _ = _case(5)
    seen_fwd, seen_bwd = [], []
    conv2d = F.conv2d

    def spy(*a, **kw):
        seen_fwd.append(torch.backends.cudnn.allow_tf32)
        out = conv2d(*a, **kw)
        if out.requires_grad:
            out.register_hook(lambda g: seen_bwd.append(torch.backends.cudnn.allow_tf32))
        return out

    monkeypatch.setattr(F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", user_flag)
    opt = make_optimizer()
    state = create_train_state(cfg, opt, params=p, batch_stats=s)
    step = make_train_step(cfg, opt, compute_dtype=dtype, masked=True)
    step(state, torch.from_numpy(x), torch.zeros(len(MASK), 1, *HW), torch.from_numpy(MASK))
    want = user_flag and dtype != torch.float32
    assert seen_fwd and set(seen_fwd) == {want}
    assert len(seen_bwd) == len(seen_fwd) and set(seen_bwd) == {want}
    assert torch.backends.cudnn.allow_tf32 == user_flag


_JAX_BF16_SCRIPT = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax.numpy as jnp
    from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
    from gelslim_depth_tpu.models.unet import UNetConfig, unet_apply

    root = sys.argv[1]
    z = np.load(root + "/in.npz")
    sd = {n[3:]: z[n] for n in z.files if n.startswith("sd/")}
    cfg = UNetConfig(layer_dimensions=tuple(z["dims"]), activation=str(z["act"]))
    params, stats = import_torch_state_dict(sd, cfg)
    y, st = unet_apply(cfg, params, stats, jnp.asarray(z["x"]), train=True,
                       compute_dtype=jnp.bfloat16, sample_mask=jnp.asarray(z["mask"]))
    out = {"y": np.asarray(y, np.float32)}
    for block, leaves in st.items():
        for leaf, v in leaves.items():
            out[f"st/{block}/{leaf}"] = np.asarray(v)
    np.savez(root + "/out.npz", **out)
    print("JAX-BF16-OK")
    """
)


@pytest.mark.parametrize("activation", ["relu", "mish"])
def test_bf16_train_forward_matches_jax(tmp_path, activation):
    jcfg, params, stats, cfg, p, s, x, sd = _case(6, activation)
    np.savez(tmp_path / "in.npz", x=x, mask=MASK, dims=np.array(DIMS), act=np.array(activation),
             **{f"sd/{k}": v for k, v in sd.items()})
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run([sys.executable, "-c", _JAX_BF16_SCRIPT, str(tmp_path)], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert "JAX-BF16-OK" in r.stdout, r.stderr[-3000:]
    z = np.load(tmp_path / "out.npz")
    got, got_stats = unet_apply(cfg, p, s, torch.from_numpy(x), train=True, compute_dtype=torch.bfloat16,
                                sample_mask=torch.from_numpy(MASK))
    want = z["y"]
    spread = float(want.max() - want.min())
    err = np.abs(got.numpy() - want)
    assert err.max() < 0.05 * spread and np.sqrt((err ** 2).mean()) < 0.01 * spread, (err.max(), spread)
    want_stats = {k[3:]: z[k] for k in z.files if k.startswith("st/")}
    want_s = split_state_dict(params_from_jax(*_trees(params, want_stats), cfg))[1]
    for key in s:
        np.testing.assert_allclose(got_stats[key].numpy(), want_s[key].numpy(), rtol=2e-2, atol=1e-3, err_msg=key)


def _trees(params, flat_stats):
    stats = {}
    for key, v in flat_stats.items():
        block, leaf = key.split("/")
        stats.setdefault(block, {})[leaf] = v
    return params, stats
