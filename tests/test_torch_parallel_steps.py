"""The port's data-parallel train and eval steps on 2 gloo ranks on the
CPU (tests/torch_parallel_worker.py, job 'steps'), against the JAX
package's make_dp_train_step / make_dp_eval_step / make_dp_predict on
make_mesh(2), against the JAX single-device step and against the port's own
single-device TrainStep, on the same weights and batches made with numpy
from a seed; plus the multi-process helpers and their refusals.

Bars. The two ranks' states equal bit for bit. Losses rtol 1e-4 / atol
1e-6 against JAX's DP step, JAX's single-device step and the port's
single-device step. The gradients of one step against the port's
single-device step's, relative L2 1e-4 per tensor: Adam divides by
sqrt(nu), which hides a gradient's scale, and a gradient all-reduced or
normalized a world size off is 0.5 or more away. After 2 steps, against
JAX's DP step and the port's single step, and in the unmasked run against
JAX's single-device step too: every parameter, running statistic and (for
the port's single step) EMA weight at JAX's DP bar (tests/
test_train_steps.py:228-240: rtol 1e-3 / atol 1e-5) but for at most one
element a tensor, the bar's own two tensors (the `inc` conv1 weight and
BN1 running mean) with none off; and every parameter's update (new minus
start) within relative L2 1e-2 of the reference's, so a parameter that did
not move, or moved a world size off, fails. Adam's first steps move a
weight by about lr whatever its gradient's size, so a near-zero gradient
whose last bits differ moves it up to 2 lr the other way: one element of
29,945 misses the bar in the unmasked run, against every reference. The
masked run is held to JAX's single-device step on its losses only: JAX's
own masked DP step misses that step on 7,183 elements of 28 tensors at
rtol 1e-3 / atol 1e-5, with an update relative L2 up to 0.44, while the
port's DP step misses JAX's DP step and the port's single step on none.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gelslim_depth_tpu import parallel as jax_parallel
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.models.unet import UNetConfig as JaxUNetConfig
from gelslim_depth_tpu.train import ema_init as jax_ema_init
from gelslim_depth_tpu.train import make_optimizer as jax_make_optimizer
from gelslim_depth_tpu.train import make_train_step as jax_make_train_step
from gelslim_depth_tpu.train.steps import TrainState as JaxTrainState
from gelslim_depth_tpu_torch.models import params_from_jax
from gelslim_depth_tpu_torch.models.torch_import import params_to_jax
from gelslim_depth_tpu_torch.models.unet import UNetConfig, split_state_dict, unet_apply
from gelslim_depth_tpu_torch.parallel import make_mesh, multihost
from gelslim_depth_tpu_torch.train import create_train_state, make_eval_step, make_optimizer, make_train_step
from tests import torch_parallel_worker as worker
from tests.torch_port_helpers import torch_threads

CFG = UNetConfig(layer_dimensions=worker.DIMS)
JCFG = JaxUNetConfig(layer_dimensions=worker.DIMS)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
JAX_DP_TOL = dict(rtol=1e-3, atol=1e-5)
ELEMENTS_OFF = 1  # of each tensor, at JAX_DP_TOL (module docstring)
UPDATE_RTOL = 1e-2  # relative L2 of a parameter's update over 2 steps
JAX_DP_BAR = ("inc.double_conv.0.weight", "inc.double_conv.1.running_mean")
MODES = [("plain", False), ("masked", True)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn("steps", tmp_path_factory.mktemp("steps"))


@pytest.fixture(scope="module")
def inputs():
    return worker.step_inputs()


def _tree(out, prefix):
    return {k.split("|", 2)[2]: v for k, v in out.items() if k.startswith(prefix + "|")}


def _jax_state(sd, opt):
    params, stats = import_torch_state_dict(sd, JCFG)
    return JaxTrainState(params, stats, opt.init(params), jax_ema_init(params, 0.995), jnp.zeros((), jnp.int32))


def _port_trees(jstate):
    params, stats = split_state_dict(params_from_jax(jstate.params, jstate.batch_stats, CFG))
    return {k: v.numpy() for k, v in params.items()}, {k: v.numpy() for k, v in stats.items()}


def _assert_close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}", **tol)


def _assert_dp_bar(got, want, what, start=None):
    """Every tensor at JAX's DP bar but for ELEMENTS_OFF elements; with
    start, every tensor's update within UPDATE_RTOL relative L2."""
    assert set(got) == set(want), what
    for k in want:
        off = int((~np.isclose(got[k], want[k], **JAX_DP_TOL)).sum())
        assert off <= ELEMENTS_OFF, f"{what} {k}: {off} of {want[k].size} elements off rtol 1e-3 / atol 1e-5"
        if start is not None:
            move = want[k] - start[k]
            err = np.linalg.norm((got[k] - start[k]) - move)
            assert err <= UPDATE_RTOL * np.linalg.norm(move), f"{what} {k}: update off by {err} of {np.linalg.norm(move)}"


def test_both_ranks_hold_the_same_state(ranks):
    a, b = ranks
    assert set(a) == set(b)
    for k in a:
        if k != "refusals":
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("mode,masked", MODES)
def test_dp_gradients_equal_the_single_step(ranks, inputs, mode, masked):
    sd, batches = inputs
    p, s = split_state_dict(sd)
    opt = make_optimizer(1e-3, 1e-6)
    x, y, m = (torch.from_numpy(a) for a in batches[mode][-1])
    want = make_train_step(CFG, opt, masked=masked).loss_and_grads(
        create_train_state(CFG, opt, params=p, batch_stats=s), x, y, m if masked else None)[2]
    got = _tree(ranks[0], f"{mode}|grads")
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.linalg.norm(got[k] - v.numpy()) <= 1e-4 * np.linalg.norm(v.numpy()), k


@pytest.mark.parametrize("mode,masked", MODES)
def test_dp_steps_match_jax_dp_and_single(ranks, inputs, mode, masked):
    sd, batches = inputs
    out = ranks[0]
    jopt = jax_make_optimizer(1e-3, 1e-6)
    mesh = jax_parallel.make_mesh(2)
    jdp = jax_parallel.make_dp_train_step(JCFG, jopt, mesh, donate=False, masked=masked)
    jsingle = jax.jit(jax_make_train_step(JCFG, jopt, masked=masked))
    opt = make_optimizer(1e-3, 1e-6)
    p, s = split_state_dict(sd)
    port_single, port_step = create_train_state(CFG, opt, params=p, batch_stats=s), make_train_step(CFG, opt, masked=masked)
    dstate = jax_parallel.replicate(mesh, _jax_state(sd, jopt))
    sstate = _jax_state(sd, jopt)
    dlosses, slosses, plosses = [], [], []
    for x, y, m in batches[mode]:
        args = (jnp.asarray(x), jnp.asarray(y)) + ((jnp.asarray(m),) if masked else ())
        dstate, dl = jdp(dstate, *(jax_parallel.shard_batch(mesh, a) for a in args))
        sstate, sl = jsingle(sstate, *args)
        port_single, pl = port_step(port_single, torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(m) if masked else None)
        dlosses.append(float(dl))
        slosses.append(float(sl))
        plosses.append(pl.item())
    for want in (dlosses, slosses, plosses):
        np.testing.assert_allclose(out[f"{mode}|losses"], want, **LOSS_TOL)
    got = {**_tree(out, f"{mode}|params"), **_tree(out, f"{mode}|stats")}
    refs = {"JAX DP": _port_trees(dstate), "JAX single": _port_trees(sstate),
            "port single": ({k: v.numpy() for k, v in port_single.params.items()},
                            {k: v.numpy() for k, v in port_single.batch_stats.items()})}
    start = {k: v.numpy() for k, v in split_state_dict(sd)[0].items()}
    for name, (params, stats) in refs.items():
        if name == "JAX single" and masked:
            continue  # JAX's own masked DP step misses it (module docstring)
        _assert_dp_bar({k: got[k] for k in params}, params, f"{name} parameters", start)
        _assert_dp_bar({k: got[k] for k in stats}, stats, f"{name} running statistics")
        _assert_close({k: got[k] for k in JAX_DP_BAR}, {k: {**params, **stats}[k] for k in JAX_DP_BAR},
                      JAX_DP_TOL, f"{name}, JAX's DP bar")
    _assert_dp_bar(_tree(out, f"{mode}|ema"), {k: v.numpy() for k, v in port_single.ema.shadow.items()},
                   "port single EMA")
    assert out[f"{mode}|counters"].tolist() == [2, 2, 2]


def test_dp_eval_step_and_predict(ranks, inputs):
    """The eval step's global masked loss and make_dp_predict's rows, on
    the DP state, against the single-device eval step and JAX's DP eval
    step and DP predict on the same state."""
    _, batches = inputs
    out = ranks[0]
    params, stats = _tree(out, "masked|params"), _tree(out, "masked|stats")
    ema = _tree(out, "masked|ema")
    x, y, m = batches["masked"][1]
    opt = make_optimizer(1e-3, 1e-6)
    state = create_train_state(CFG, opt, params={k: torch.from_numpy(v) for k, v in params.items()},
                               batch_stats={k: torch.from_numpy(v) for k, v in stats.items()})
    state.ema.shadow.update({k: torch.from_numpy(v) for k, v in ema.items()})
    want = make_eval_step(CFG, masked=True)(state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
    np.testing.assert_allclose(out["eval_loss"], want.item(), **LOSS_TOL)

    mesh = jax_parallel.make_mesh(2)
    jp, js = params_to_jax({**ema, **stats}, CFG)
    jopt = jax_make_optimizer(1e-3, 1e-6)
    jstate = JaxTrainState(jp, js, jopt.init(jp), jax_ema_init(jp, 0.995), jnp.zeros((), jnp.int32))
    jeval = jax_parallel.make_dp_eval_step(JCFG, mesh, masked=True)
    jloss = jeval(jax_parallel.replicate(mesh, jstate),
                  *(jax_parallel.shard_batch(mesh, jnp.asarray(a)) for a in (x, y, m)))
    np.testing.assert_allclose(out["eval_loss"], float(jloss), **LOSS_TOL)

    jp, js = params_to_jax({**params, **stats}, CFG)
    jpred = jax_parallel.make_dp_predict(JCFG, mesh)(jax_parallel.replicate(mesh, jp), jax_parallel.replicate(mesh, js),
                                                    jax_parallel.shard_batch(mesh, jnp.asarray(x)))
    np.testing.assert_allclose(out["predict"], np.asarray(jpred), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        single = unet_apply(CFG, state.params, state.batch_stats, torch.from_numpy(x))[0]
    np.testing.assert_allclose(out["predict"], single.numpy(), rtol=1e-5, atol=1e-6)


def test_rows_and_refusals_on_the_ranks(ranks):
    """Rows that do not divide split 4 + 3 and gather back in order;
    make_mesh(4) in a world of 2 raises, and so does feeding unequal rows
    to global_batch_from_local, on both ranks."""
    for out in ranks:
        assert out["uneven"].tolist() == list(range(7))
        assert out["refusals"].tolist() == [1, 1]


def test_process_local_rows_and_indices_match_jax():
    for n in (8, 10, 16):
        for pc in (1, 2, 4):
            for pi in range(pc):
                np.testing.assert_array_equal(
                    multihost.process_local_indices(n, process_index=pi, process_count=pc),
                    np.arange(n)[jax_parallel.process_local_rows(n - n % pc, process_index=pi, process_count=pc)]
                    if pi < pc - 1 else np.arange(pi * (n // pc), n))
                if n % pc == 0:
                    assert multihost.process_local_rows(n, process_index=pi, process_count=pc) == \
                        jax_parallel.process_local_rows(n, process_index=pi, process_count=pc)
    assert multihost.process_local_rows(8) == slice(0, 8)  # one process: every row
    np.testing.assert_array_equal(multihost.process_local_indices(10), jax_parallel.process_local_indices(10))
    with pytest.raises(ValueError):
        multihost.process_local_rows(7, process_index=0, process_count=2)


@pytest.mark.parametrize("kw", [dict(num_processes=2), dict(process_id=1),
                                dict(coordinator_address="localhost:1234"),
                                dict(coordinator_address="localhost:1234", num_processes=2)])
def test_initialize_refuses_a_partial_cluster(kw):
    """num_processes/process_id without a coordinator raise, as in the JAX
    package; a coordinator without both counts raises too (torch cannot
    discover them). None of them joins a group."""
    with pytest.raises(ValueError):
        multihost.initialize(**kw)
    assert not multihost.is_initialized()


def test_initialize_reads_the_launcher_environment(monkeypatch):
    for k in multihost.LAUNCHER_ENV + ("SLURM_JOB_ID", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()  # no cluster named: a no-op
    assert not multihost.is_initialized()
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize()
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("SLURM_JOB_ID", "7")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize()
    assert not multihost.is_initialized()


def test_single_process_mesh(monkeypatch):
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type, mesh.group) == (0, 1, "cpu", None)
    assert mesh.rows(5) == slice(0, 5)
    with pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()  # the default device is a card, never the CPU


@pytest.mark.parametrize("masked", [False, True])
def test_unet_reduce_hook_over_one_rank(inputs, masked):
    """unet_apply's reduce over one rank (the identity) gives the
    statistics the plain train forward takes, to float32 rounding."""
    sd, batches = inputs
    x, _, m = batches["masked"][1]
    p, s = split_state_dict(sd)
    kw = dict(train=True, sample_mask=torch.from_numpy(m) if masked else None)
    with torch.no_grad():
        y0, st0 = unet_apply(CFG, p, s, torch.from_numpy(x), **kw)
        y1, st1 = unet_apply(CFG, p, s, torch.from_numpy(x), reduce=lambda t: t, **kw)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-5)
    for k, v in st0.items():
        np.testing.assert_allclose(st1[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_worker_imports_no_jax():
    with open(os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")) as f:
        src = f.read()
    assert "import jax" not in src and "gelslim_depth_tpu." not in src.replace("gelslim_depth_tpu_torch", "")
