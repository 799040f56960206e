"""The port's height-sharded serving (make_spatial_predictor[_int8]) on 2
and 4 gloo ranks on the CPU (tests/torch_parallel_worker.py, job
'spatial'), against the JAX package's make_spatial_predictor[_int8] on
make_mesh(R) and against the unsharded JAX and port predictors, on the same
weights and inputs made with numpy from a seed; and the band plan itself.

Cases (worker.SPATIAL_CASES): small_config's 80x107 frames and 40x53 net
input; an 84x107 -> 42x53 one, whose level 1 has 21 rows (a floor-mode pool
and the Up block's pad on the last band); an 84x107 -> 40x53 one, whose
frame-to-net height ratio is not an integer (the composed front end over
the global windows' rows, and the resize back from the gathered net
output).

Bars: float32 within rtol 1e-4 / atol 1e-5 mm of JAX's spatial graph and
of the unsharded predictors (tests/test_inference.py's spatial bar); int8
within rtol/atol 1e-4 mm of the port's unsharded QuantizedPredictor; and,
against JAX's spatial int8 graph given the same quantized model, its
difference from it within 1e-4 mm of the difference between the two
packages' unsharded int8 graphs. A float32 ulp at a requantization point
may flip one int8 step between the packages' graphs, sharded or not (XLA
fuses the dequantize and the BN affine into one multiply-add): on the odd
and ratio cases their unsharded graphs differ by up to 1.8e-3 mm at a few
hundred of 18k pixels, so the bar holds what sharding adds on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gelslim_depth_tpu import parallel as jax_parallel
from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.inference import Predictor as JaxPredictor
from gelslim_depth_tpu.inference import QuantizedPredictor as JaxQuantizedPredictor
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu_torch import GelslimConfig, Predictor
from gelslim_depth_tpu_torch.inference import QuantizedPredictor
from gelslim_depth_tpu_torch.models.unet import UNetConfig
from gelslim_depth_tpu_torch.parallel import Mesh, spatial_band_plan
from tests import torch_parallel_worker as worker
from tests.test_torch_parallel_serving import _jax_quantized
from tests.torch_port_helpers import torch_threads

FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
INT8_TOL = dict(rtol=1e-4, atol=1e-4)
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: worker.spawn("spatial", tmp_path_factory.mktemp(f"spatial{w}"), world=w) for w in WORLDS}


@pytest.fixture(scope="module")
def unsharded():
    """Per case: the inputs and the unsharded port and JAX predictors'
    depth, float32 and int8 (the model quantized as rank 0 quantizes it,
    one thread)."""
    out = {}
    for name, (frame_hw, net_hw) in worker.SPATIAL_CASES.items():
        cfg, jcfg = GelslimConfig(**worker.spatial_config(net_hw)), JaxConfig(**worker.spatial_config(net_hw))
        sd, frames, base, calib = worker.spatial_inputs(frame_hw)
        params, stats = import_torch_state_dict(sd, jcfg.unet_config())
        pred = Predictor(cfg, sd, device="cpu")
        with torch_threads(1):
            q = pred.quantize(calib, base).q
        out[name] = dict(
            frame_hw=frame_hw, jcfg=jcfg, params=params, stats=stats, frames=frames, base=base, q=q,
            port_float=pred.predict_dual_frames(frames, base, frame_hw).numpy(),
            jax_float=np.asarray(JaxPredictor(jcfg, params, stats).predict_dual_frames(
                jnp.asarray(frames), jnp.asarray(base), frame_hw)),
        )
        qpred = QuantizedPredictor(cfg, q, compute_dtype=torch.float32, device="cpu")
        out[name]["port_int8"] = qpred.predict_dual_frames(frames, base, frame_hw).numpy()
    return out


def _height_sharded(mesh, frames, base):
    return (jax.device_put(jnp.asarray(frames), NamedSharding(mesh, P(None, None, "data", None))),
            jax.device_put(jnp.asarray(base), NamedSharding(mesh, P(None, "data", None))))


def test_ranks_gather_the_same_depth(ranks):
    for world, outs in ranks.items():
        for k in outs[0]:
            for r in outs[1:]:
                assert np.array_equal(outs[0][k], r[k]), (world, k)
        # one exchange before each 3x3 conv: 2 a DoubleConv, 5 DoubleConvs;
        # int8 adds inc/conv1's input and up_j/conv1's second source
        for name in worker.SPATIAL_CASES:
            assert outs[0][f"{name}|exchanges"].tolist() == [10, 12], (world, name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(worker.SPATIAL_CASES))
def test_spatial_float_matches_jax_spatial_and_single(ranks, unsharded, world, case):
    u = unsharded[case]
    got = ranks[world][0][f"{case}|float"]
    assert got.shape == (1, 2, *u["frame_hw"]) and np.isfinite(got).all()
    mesh, rep = jax_parallel.make_mesh(world), jax_parallel.replicate
    predict = jax_parallel.make_spatial_predictor(u["jcfg"], u["jcfg"].unet_config(), mesh, u["frame_hw"])
    want = predict(rep(mesh, u["params"]), rep(mesh, u["stats"]), *_height_sharded(mesh, u["frames"], u["base"]))
    np.testing.assert_allclose(got, np.asarray(want), **FLOAT_TOL)
    np.testing.assert_allclose(got, u["port_float"], **FLOAT_TOL)
    np.testing.assert_allclose(got, u["jax_float"], **FLOAT_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(worker.SPATIAL_CASES))
def test_spatial_int8_matches_jax_spatial_and_single(ranks, unsharded, world, case):
    u = unsharded[case]
    got = ranks[world][0][f"{case}|int8"]
    assert got.shape == (1, 2, *u["frame_hw"]) and np.isfinite(got).all()
    np.testing.assert_allclose(got, u["port_int8"], **INT8_TOL)
    mesh = jax_parallel.make_mesh(world)
    jq = _jax_quantized(u["q"], u["jcfg"].unet_config())
    predict = jax_parallel.make_spatial_predictor_int8(u["jcfg"], jq, mesh, u["frame_hw"], compute_dtype=jnp.float32)
    want = np.asarray(predict(jax_parallel.replicate(mesh, jq), *_height_sharded(mesh, u["frames"], u["base"])))
    jax_single = np.asarray(JaxQuantizedPredictor(u["jcfg"], jq, compute_dtype=jnp.float32).predict_dual_frames(
        jnp.asarray(u["frames"]), jnp.asarray(u["base"]), u["frame_hw"]))
    np.testing.assert_allclose(got - want, u["port_int8"] - jax_single, rtol=0, atol=1e-4)


FLAGSHIP = UNetConfig()


def test_band_plan_flagship_four_ranks():
    """Bottom level 10 rows -> (3, 3, 2, 2), doubling upward; the kernel
    front end and the band-local resize back both hold at 320 -> 160 -> 320."""
    plan = spatial_band_plan(4, (320, 427), (160, 213), (320, 427), FLAGSHIP)
    heights = [[b - a for a, b in level] for level in plan.levels]
    assert heights == [[48, 48, 32, 32], [24, 24, 16, 16], [12, 12, 8, 8], [6, 6, 4, 4], [3, 3, 2, 2]]
    assert plan.frame_rows == plan.output_rows == ((0, 96), (96, 192), (192, 256), (256, 320))
    assert plan.kernel_front_end and plan.local_back_end


def test_band_plan_odd_and_non_integer_cases():
    cfg = UNetConfig(layer_dimensions=worker.SPATIAL_DIMS)
    odd = spatial_band_plan(4, (84, 107), (42, 53), (84, 107), cfg)
    assert odd.levels[1] == ((0, 6), (6, 12), (12, 16), (16, 21)) and odd.net_rows[-1] == (32, 42)
    assert odd.kernel_front_end and odd.local_back_end
    ratio = spatial_band_plan(Mesh(0, 4, torch.device("cpu")), (84, 107), (40, 53), (84, 107), cfg)
    # 84 -> 40 windows straddle the bands: overlapping frame rows, a gathered resize back
    assert ratio.frame_rows == ((0, 26), (25, 51), (50, 68), (67, 84))
    assert ratio.output_rows == ((0, 26), (26, 51), (51, 68), (68, 84))
    assert not ratio.kernel_front_end and not ratio.local_back_end


@pytest.mark.parametrize("refusal", ["too_many_ranks", "pool_needs_halo"])
def test_band_plan_refusals(refusal):
    """A rank without a bottom row, and a U-Net whose pools would need halos."""
    if refusal == "too_many_ranks":
        # 160 -> 80 -> 40 -> 20 -> 10 bottom rows over 16 ranks
        with pytest.raises(ValueError, match="10 rows: fewer bottom rows than ranks"):
            spatial_band_plan(16, (320, 427), (160, 213), (320, 427), FLAGSHIP)
    else:
        with pytest.raises(ValueError, match="pool 3"):
            spatial_band_plan(2, (320, 427), (160, 213), (320, 427), UNetConfig(maxpool_size=3, upconv_stride=3))
