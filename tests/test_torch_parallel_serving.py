"""The port's data-parallel serving and rendering on 2 gloo ranks on the
CPU (tests/torch_parallel_worker.py, job 'serving'), against the JAX
package's make_dp_fused_predictor[_int8] and make_dp_renderer on
make_mesh(2) and against the port's own single-process paths, on the same
weights and inputs made with numpy from a seed.

Bars: float32 serving within rtol/atol 1e-4 of JAX's DP graph and of the
unsharded graphs (``__graft_entry__.py:dryrun_multichip``'s bar); int8
serving within 1e-4 of the port's QuantizedPredictor on the whole batch
and bit for bit on each rank's rows (the CPU's float convs round by batch
size and threads), and within 1e-4 of JAX's DP int8 graph given the same quantized
model; the renderer within atol 1e-5 of JAX's
make_dp_renderer and equal to the port's unsharded renderer bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gelslim_depth_tpu import parallel as jax_parallel
from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.inference import Predictor as JaxPredictor
from gelslim_depth_tpu.meshgen import plane_spec as jax_plane_spec
from gelslim_depth_tpu.models.quantize import QuantizedUNet as JaxQuantizedUNet
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu_torch import GelslimConfig, Predictor
from gelslim_depth_tpu_torch.inference import QuantizedPredictor
from gelslim_depth_tpu_torch.meshgen import plane_spec, render_depth_batch
from gelslim_depth_tpu_torch.models.quantize import hwio_from_ohwi
from gelslim_depth_tpu_torch.models.torch_import import params_to_jax
from tests import torch_parallel_worker as worker
from tests.torch_port_helpers import torch_threads

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn("serving", tmp_path_factory.mktemp("serving"))


@pytest.fixture(scope="module")
def inputs():
    sd, frames, base, bases = worker.serving_inputs()
    jcfg = JaxConfig(**worker.SERVE_CFG)
    params, stats = import_torch_state_dict(sd, jcfg.unet_config())
    return dict(sd=sd, frames=frames, base=base, bases=bases, jcfg=jcfg, params=params, stats=stats,
                mesh=jax_parallel.make_mesh(2))


def test_both_ranks_gather_the_same_rows(ranks):
    a, b = ranks
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def _jax_dp_float(inputs, frames, base):
    mesh, jcfg = inputs["mesh"], inputs["jcfg"]
    dp = jax_parallel.make_dp_fused_predictor(jcfg, jcfg.unet_config(), mesh, worker.FRAME)
    rep = jax_parallel.replicate
    return np.asarray(dp(rep(mesh, inputs["params"]), rep(mesh, inputs["stats"]),
                         jax_parallel.shard_batch(mesh, jnp.asarray(frames)), rep(mesh, jnp.asarray(base))))


@pytest.mark.parametrize("base_kind", ["shared", "per_frame"])
def test_dp_float_matches_jax_dp_and_single(ranks, inputs, base_kind):
    got = ranks[0]["float" if base_kind == "shared" else "float_bases"]
    base = inputs["base"] if base_kind == "shared" else inputs["bases"]
    assert got.shape == (8, 2, *worker.FRAME)
    np.testing.assert_allclose(got, _jax_dp_float(inputs, inputs["frames"], base), **TOL)
    single = Predictor(GelslimConfig(**worker.SERVE_CFG), inputs["sd"], device="cpu")
    np.testing.assert_allclose(got, single.predict_dual_frames(inputs["frames"], base, worker.FRAME).numpy(), **TOL)


def test_dp_float_rows_that_do_not_divide(ranks, inputs):
    """7 frames over 2 ranks (4 + 3): JAX's DP graph needs the batch to
    divide the mesh, so the bar is the JAX package's unsharded graph."""
    got = ranks[0]["float_uneven"]
    want = JaxPredictor(inputs["jcfg"], inputs["params"], inputs["stats"]).predict_dual_frames(
        jnp.asarray(inputs["frames"][:7]), jnp.asarray(inputs["base"]), worker.FRAME)
    assert got.shape == (7, 2, *worker.FRAME)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_array_equal(got, ranks[0]["float"][:7])


def test_dp_int8_matches_single_and_jax_dp(ranks, inputs):
    got = ranks[0]["int8"]
    frames, base = inputs["frames"], inputs["base"]
    cfg = GelslimConfig(**worker.SERVE_CFG)
    qpred = Predictor(cfg, inputs["sd"], device="cpu").quantize(frames[:4], base)
    qpred = QuantizedPredictor(cfg, qpred.q, compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(got, qpred.predict_dual_frames(frames, base, worker.FRAME).numpy(), **TOL)
    # each rank's rows through the same path at the same batch and threads
    # as the rank's: the same bits
    with torch_threads(1):
        for rows in (slice(0, 4), slice(4, 8)):
            want = qpred.predict_dual_frames(frames[rows], base, worker.FRAME).numpy()
            np.testing.assert_array_equal(got[rows], want)

    # JAX's DP int8 graph on the port's quantized model
    mesh, jq = inputs["mesh"], _jax_quantized(qpred.q, inputs["jcfg"].unet_config())
    dq = jax_parallel.make_dp_fused_predictor_int8(inputs["jcfg"], jq, mesh, worker.FRAME, compute_dtype=jnp.float32)
    want = dq(jax_parallel.replicate(mesh, jq), jax_parallel.shard_batch(mesh, jnp.asarray(frames)),
              jax_parallel.replicate(mesh, jnp.asarray(base)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _jax_quantized(q, jax_unet_cfg):
    """The port's QuantizedUNet as the JAX package's, in its layouts (what
    save_quantized writes, without the file)."""
    params, stats = params_to_jax(q.net.state_dict(), q.cfg)
    w8, w_scale = {}, {}
    for site in q.sites:
        block, conv = site.split("/")
        w8.setdefault(block, {})[conv] = jnp.asarray(hwio_from_ohwi(q.w8(site)).numpy())
        w_scale.setdefault(block, {})[conv] = jnp.asarray(q.w_scale(site).numpy())
    return JaxQuantizedUNet(jax_unet_cfg, params, stats, w8, w_scale,
                            {k: jnp.float32(v) for k, v in q.act_scales().items()}, jnp.float32(q.float_delta.item()))


def test_dp_renderer_matches_jax_dp_and_single(ranks, inputs):
    pc, poses, widths = worker.render_inputs()
    got = ranks[0]["render"]
    mesh = inputs["mesh"]
    render = jax_parallel.make_dp_renderer(mesh, spec=jax_plane_spec("+y+z"), **worker.RENDER_KW)
    want = render(jax_parallel.replicate(mesh, jnp.asarray(pc)), jax_parallel.shard_batch(mesh, jnp.asarray(poses)),
                  jax_parallel.shard_batch(mesh, jnp.asarray(widths)))
    assert got.shape == (6, 2, *worker.RENDER_KW["image_size"]) and got.min() < 0
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    single = render_depth_batch(pc, poses, widths, spec=plane_spec("+y+z"), device="cpu", **worker.RENDER_KW)
    np.testing.assert_array_equal(got, single.numpy())
