"""The port's train and eval steps, EMA, optimizer and train-state files
against the JAX package's (``make_train_step(masked=True)``, optax Adam,
``ema_update``, ``save_train_state``) and against the independent torch
implementation of the reference's training semantics
(tests/torch_fixture.py::torch_train_steps), on the same weights and
batches made with numpy from a seed.

Tolerances: losses rtol 1e-4 / atol 1e-6 (float32 convs in another
summation order); parameters, EMA shadow and running statistics after the
steps rtol 5e-3 / atol 2e-3, the bar tests/test_train_steps.py holds the JAX
step to against torch (Adam divides by sqrt(nu), which amplifies the
gradients' last bits on the first steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.models.unet import UNetConfig as JaxUNetConfig
from gelslim_depth_tpu.train import checkpoint as jax_ckpt
from gelslim_depth_tpu.train import ema_init as jax_ema_init
from gelslim_depth_tpu.train import make_optimizer as jax_make_optimizer
from gelslim_depth_tpu.train import make_train_step as jax_make_train_step
from gelslim_depth_tpu.train.steps import TrainState as JaxTrainState
from gelslim_depth_tpu_torch.models import UNetConfig, params_from_jax, train_state_from_jax
from gelslim_depth_tpu_torch.models.unet import init_unet, reinit_weights_normal, split_state_dict, unet_apply
from gelslim_depth_tpu_torch.train import (
    create_train_state,
    ema_init,
    ema_update,
    load_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    mse_loss,
    save_train_state,
)
from tests.torch_fixture import make_state_dict, torch_train_steps
from tests.torch_port_helpers import torch_threads

DIMS = (8, 16, 32)
CFG = UNetConfig(layer_dimensions=DIMS)
JCFG = JaxUNetConfig(layer_dimensions=DIMS)
HW = (16, 21)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-3)



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield

def _batches(rng, n, bs=4, tail=None):
    """n batches of (x, y, mask); the last holds only `tail` valid samples
    when given, padded by repeating sample 0 as BatchIterator pads."""
    out = []
    for b in range(n):
        x = rng.uniform(0, 1, (bs, 3, *HW)).astype(np.float32)
        y = rng.uniform(-0.9, 0, (bs, 1, *HW)).astype(np.float32)
        m = np.ones(bs, bool)
        if tail is not None and b == n - 1:
            m[tail:] = False
            x[tail:], y[tail:] = x[0], y[0]
        out.append((x, y, m))
    return out


def _weights(seed):
    sd = make_state_dict(np.random.RandomState(seed), DIMS)
    params, stats = import_torch_state_dict(sd, JCFG)
    return sd, params, stats


def _jax_state(params, stats, opt):
    return JaxTrainState(params, stats, opt.init(params), jax_ema_init(params, 0.995), jnp.zeros((), jnp.int32))


def _port(tree_p, tree_s=None):
    """JAX trees -> the port's reference-layout tensors."""
    return split_state_dict(params_from_jax(tree_p, tree_s, CFG))


def _assert_state_close(port_state, jax_state, tol):
    p, s = _port(jax_state.params, jax_state.batch_stats)
    shadow, _ = _port(jax_state.ema.shadow, jax_state.batch_stats)
    for name, got, want in (("params", port_state.params, p), ("stats", port_state.batch_stats, s),
                            ("ema", port_state.ema.shadow, shadow)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=f"{name} {k}", **tol)
    assert int(port_state.step) == int(jax_state.step)
    assert int(port_state.opt_state.count) == int(jax_state.opt_state[1].count)
    assert int(port_state.ema.num_updates) == int(jax_state.ema.num_updates)


def test_masked_steps_match_jax_make_train_step():
    """4 masked steps, the last batch padded, from the same weights."""
    sd, params, stats = _weights(0)
    batches = _batches(np.random.RandomState(1), 4, tail=3)
    jopt = jax_make_optimizer(1e-3, 1e-6)
    jstate = _jax_state(params, stats, jopt)
    jstep = jax.jit(jax_make_train_step(JCFG, jopt, masked=True))
    opt = make_optimizer(1e-3, 1e-6)
    p, s = split_state_dict(sd)
    state = create_train_state(CFG, opt, params=p, batch_stats=s)
    step = make_train_step(CFG, opt, masked=True)
    for x, y, m in batches:
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
        state, loss = step(state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
        np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    _assert_state_close(state, jstate, STATE_TOL)
    # the Adam moments ride along
    mu, _ = _port(jstate.opt_state[1].mu, jstate.batch_stats)
    for k in mu:
        np.testing.assert_allclose(state.opt_state.mu[k].numpy(), mu[k].numpy(), **STATE_TOL)


def test_steps_match_the_torch_reference_semantics():
    """5 unmasked steps against torch.optim.Adam + F.batch_norm + a
    torch_ema-style EMA (tests/torch_fixture.py)."""
    sd = make_state_dict(np.random.RandomState(2), DIMS)
    batches = [(x, y) for x, y, _ in _batches(np.random.RandomState(3), 5)]
    t_losses, t_params, t_shadow = torch_train_steps(sd, batches, DIMS, n_steps=5)
    opt = make_optimizer(1e-3, 1e-6)
    p, s = split_state_dict(sd)
    state = create_train_state(CFG, opt, params=p, batch_stats=s)
    step = make_train_step(CFG, opt)
    losses = []
    for x, y in batches:
        state, loss = step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, t_losses, **LOSS_TOL)
    for k, v in t_params.items():
        got = state.batch_stats[k] if "running_" in k else state.params[k]
        np.testing.assert_allclose(got.numpy(), v, err_msg=k, **STATE_TOL)
    for k, v in t_shadow.items():
        np.testing.assert_allclose(state.ema.shadow[k].numpy(), v, err_msg=k, **STATE_TOL)


def test_nan_batch_leaves_the_state_and_reports_zero():
    sd = make_state_dict(np.random.RandomState(4), DIMS)
    opt = make_optimizer()
    p, s = split_state_dict(sd)
    step = make_train_step(CFG, opt, masked=True)
    x, y, m = _batches(np.random.RandomState(5), 1)[0]
    state, _ = step(create_train_state(CFG, opt, params=p, batch_stats=s),
                    torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
    x[1, 0, 3, 4] = np.nan
    new, loss = step(state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
    assert loss.item() == 0.0
    before, after = state.tensors(), new.tensors()
    assert int(after.pop("step")) == int(before.pop("step")) + 1
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_padded_batch_equals_the_ragged_batch():
    """A tail batch padded to the batch size with mask False gives the
    ragged batch's loss, statistics and gradients. Loss and statistics: the
    padded rows add exact zeros (1e-6). Gradients: the batch axis is a
    contracting axis of the weight gradients, so the zeros reorder those
    sums (relative L2 1e-5). Adam's first step moves each weight by about
    lr whatever its gradient's size, so a near-zero gradient whose sign
    flips moves it 2 lr: the new state is held at the step tolerance."""
    sd = make_state_dict(np.random.RandomState(6), DIMS)
    opt = make_optimizer()
    p, s = split_state_dict(sd)
    step = make_train_step(CFG, opt, masked=True)
    x, y, m = _batches(np.random.RandomState(7), 1, bs=5, tail=3)[0]
    st0 = create_train_state(CFG, opt, params=p, batch_stats=s)
    padded = step.loss_and_grads(st0, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
    ragged = step.loss_and_grads(st0, torch.from_numpy(x[:3]), torch.from_numpy(y[:3]), torch.ones(3, dtype=torch.bool))
    torch.testing.assert_close(padded[0], ragged[0], rtol=1e-6, atol=1e-7)
    for k, v in ragged[1].items():
        torch.testing.assert_close(padded[1][k], v, rtol=1e-6, atol=1e-7, msg=k)
    for k, v in ragged[2].items():
        assert (padded[2][k] - v).norm() <= 1e-5 * v.norm(), k
    pt, rt = step.apply_updates(st0, *padded)[0].tensors(), step.apply_updates(st0, *ragged)[0].tensors()
    for k, v in rt.items():
        np.testing.assert_allclose(pt[k].numpy(), v.numpy(), err_msg=k, **STATE_TOL)


def test_ema_ramp():
    st = ema_init({"w": torch.ones(3)}, decay=0.995)
    st = ema_update(st, {"w": torch.zeros(3)})
    # first update: d = min(0.995, 2/11); shadow = 1 - (1 - d) * 1 = d
    torch.testing.assert_close(st.shadow["w"], torch.full((3,), 2.0 / 11.0))
    assert int(st.num_updates) == 1
    for _ in range(400):  # the ramp reaches the decay and stays there
        st = ema_update(st, {"w": torch.zeros(3)})
    prev = st.shadow["w"].clone()
    st = ema_update(st, {"w": torch.zeros(3)})
    torch.testing.assert_close(st.shadow["w"], prev * 0.995)
    off = ema_update(ema_init({"w": torch.ones(3)}, use_num_updates=False), {"w": torch.zeros(3)})
    torch.testing.assert_close(off.shadow["w"], torch.full((3,), 0.995))
    assert int(off.num_updates) == -1


def test_eval_step_runs_under_the_ema_and_zeroes_a_nonfinite_loss():
    sd = make_state_dict(np.random.RandomState(8), DIMS)
    opt = make_optimizer()
    p, s = split_state_dict(sd)
    state = create_train_state(CFG, opt, params={k: torch.zeros_like(v) for k, v in p.items()}, batch_stats=s)
    state.ema.shadow = p
    x, y, m = _batches(np.random.RandomState(9), 1, tail=2)[0]
    xs, ys, ms = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m)
    with torch.no_grad():
        want = mse_loss(unet_apply(CFG, p, s, xs)[0], ys, ms)
    got = make_eval_step(CFG, masked=True)(state, xs, ys, ms)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    raw = make_eval_step(CFG, use_ema=False, masked=True)(state, xs, ys, ms)
    assert raw.item() != got.item()
    xs[0, 0, 0, 0] = float("inf")
    assert make_eval_step(CFG, masked=True)(state, xs, ys, ms).item() == 0.0


def test_init_and_reinit_statistics():
    """init_unet draws the JAX package's distributions over its key set;
    the re-init puts every weight, BN scales included, at N(0, 0.01) and
    leaves the biases."""
    g = torch.Generator().manual_seed(0)
    p0, s = init_unet(CFG, g)
    jp, js = import_torch_state_dict(make_state_dict(np.random.RandomState(0), DIMS), JCFG)
    want_p, want_s = _port(jp, js)
    assert {k: v.shape for k, v in p0.items()} == {k: v.shape for k, v in want_p.items()}
    assert set(s) == set(want_s)
    assert all(torch.equal(v, torch.ones_like(v) if k.endswith("var") else torch.zeros_like(v)) for k, v in s.items())
    up_w = p0["up.0.up.weight"]  # (in, out, k, k): fan_in = in * k * k
    assert up_w.abs().max() <= up_w.shape[0] ** -0.5 / 2 and up_w.abs().max() > 0.8 * up_w.shape[0] ** -0.5 / 2
    p = reinit_weights_normal(p0, g)
    weights = torch.cat([v.ravel() for k, v in p.items() if k.endswith(".weight")])
    assert abs(weights.std().item() - 0.01) < 5e-4 and abs(weights.mean().item()) < 5e-4
    for k, v in p.items():
        if not k.endswith(".weight"):
            assert torch.equal(v, p0[k]), k
    # the same generator seed gives the same state
    a = create_train_state(CFG, make_optimizer(), generator=torch.Generator().manual_seed(3))
    b = create_train_state(CFG, make_optimizer(), generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(v, b.tensors()[k]) for k, v in a.tensors().items())
    for k, v in a.ema.shadow.items():
        assert torch.equal(v, a.params[k]) and v.data_ptr() != a.params[k].data_ptr()


def test_train_state_crosses_packages(tmp_path):
    """A JAX TrainState carried by train_state_from_jax, by its .npz, and a
    port state in the JAX package's load_train_state, continue the same
    trajectory."""
    sd, params, stats = _weights(10)
    batches = _batches(np.random.RandomState(11), 3, tail=2)
    jopt = jax_make_optimizer()
    jstep = jax.jit(jax_make_train_step(JCFG, jopt, masked=True))
    jstate = _jax_state(params, stats, jopt)
    for x, y, m in batches[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
    carried = train_state_from_jax(jax.device_get(jstate))
    jax_ckpt.save_train_state(str(tmp_path / "j"), jax.device_get(jstate))
    loaded = load_train_state(str(tmp_path / "j"))
    for k, v in carried.tensors().items():
        assert torch.equal(loaded.tensors()[k], v), k
        assert v.dtype == (torch.int32 if k in ("step", "ema/num_updates", "adam/count") else torch.float32)
    assert loaded.ema.decay == carried.ema.decay == float(np.float32(0.995))  # a float32 leaf after jit

    # port -> JAX: the port's file loads into the JAX template bit for bit
    save_train_state(str(tmp_path / "p"), carried)
    back = jax_ckpt.load_train_state(str(tmp_path / "p"), jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    x, y, m = batches[2]
    jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
    step = make_train_step(CFG, make_optimizer(), masked=True)
    state, loss = step(loaded, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    _assert_state_close(state, jstate, STATE_TOL)


def test_bf16_steps_learn_on_float32_masters():
    """bfloat16 compute keeps float32 parameters and moments, and the loss
    on one batch falls."""
    opt = make_optimizer(3e-3)
    state = create_train_state(CFG, opt, generator=torch.Generator().manual_seed(1))
    step = make_train_step(CFG, opt, compute_dtype=torch.bfloat16, masked=True)
    x, y, m = (torch.from_numpy(a) for a in _batches(np.random.RandomState(12), 1)[0])
    losses = []
    for _ in range(8):
        state, loss = step(state, x, y, m)
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
    assert all(v.dtype == torch.float32 for k, v in state.tensors().items()
               if k not in ("step", "ema/num_updates", "adam/count"))
