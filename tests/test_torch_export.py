"""The port's serving export (gelslim_depth_tpu_torch/export.py) against the
JAX package's, and both kernels as torch.library custom ops.

A .gsx artifact of torch.export programs round-trips: exported, reloaded
without the predictor objects, and called, it gives the live predictor's
output (float at 1e-6, int8 bit for bit, as tests/test_export.py holds the
JAX artifact), and the JAX package's exported graph's on the same weights
at rtol/atol 1e-3 (tests/test_torch_inference.py's bar). The dispatch plans
equal JAX's. ``torch.library.opcheck`` holds each op's schema, fake
implementation and dispatch on small CPU inputs.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.export import ExportedPredictor as JaxExportedPredictor
from gelslim_depth_tpu.export import export_predictor as jax_export_predictor
from gelslim_depth_tpu.inference import Predictor as JaxPredictor
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.export import ExportedPredictor, export_predictor
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.models import params_from_jax
from gelslim_depth_tpu_torch.ops.kernels import conv_int8, preprocess_kernel

# by path: where an installed package owns the name `tests`, `from
# tests.torch_fixture import ...` finds that package instead
_spec = importlib.util.spec_from_file_location(
    "torch_fixture", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixture.py"))
_fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixture)

CFG_KW = dict(
    CNN_dimensions=(8, 16, 32),
    input_tactile_image_size=(32, 43),
    image_normalization_method="0_255_to_0_1",
    depth_normalization_method="min_max_to_0_-1",
    depth_normalization_parameters=(-1.9, 0.0),
    norm_scale=0.9,
    use_difference_image=True,
)
FRAME = (64, 86)


@pytest.fixture(scope="module")
def predictors():
    jcfg = JaxConfig(**CFG_KW)
    sd = _fixture.make_state_dict(np.random.RandomState(2), CFG_KW["CNN_dimensions"])
    params, stats = import_torch_state_dict(sd, jcfg.unet_config())
    cfg = GelslimConfig(**CFG_KW)
    return JaxPredictor(jcfg, params, stats), Predictor(cfg, params_from_jax(params, stats, cfg.unet_config()),
                                                        device="cpu")


def _data(seed, n=4):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 255, (n, 6, *FRAME)).astype(np.float32), rng.uniform(0, 255, (6, *FRAME)).astype(np.float32)


def test_export_roundtrip_float(tmp_path, predictors):
    jpred, pred = predictors
    frames, base = _data(11)
    path = export_predictor(pred, FRAME, path=str(tmp_path / "model.gsx"), batch_sizes=(1, 4), frame_size=FRAME)
    served = ExportedPredictor.load(path)
    assert served.batch_sizes == [1, 4]
    assert served.meta["kind"] == "float32" and served.meta["runtime"] == "torch"
    assert served.meta["platforms"] == ["cpu"] and served.meta["use_difference_image"] is True

    got = served(frames, base).numpy()
    want = pred.predict_dual_frames(frames, base, FRAME).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the JAX package's artifact of the same weights
    jpath = jax_export_predictor(jpred, FRAME, path=str(tmp_path / "jax.gsx"), batch_sizes=(4,), frame_size=FRAME)
    np.testing.assert_allclose(got, np.asarray(JaxExportedPredictor.load(jpath)(frames, base)), rtol=1e-3, atol=1e-3)

    # odd batch: composed/padded routing still returns exact rows
    np.testing.assert_allclose(served(frames[:3], base).numpy(), want[:3], rtol=1e-6, atol=1e-6)
    # a batch beyond the largest exported size composes several calls
    big = np.repeat(frames, 2, axis=0)
    want_big = pred.predict_dual_frames(big, base, FRAME).numpy()
    np.testing.assert_allclose(served(big, base).numpy(), want_big, rtol=1e-6, atol=1e-6)
    assert served.dispatch_plan(8) == [(4, 4), (4, 4)]


@pytest.mark.parametrize("sizes", [(1, 64), (1, 8, 64)])
def test_dispatch_plan_matches_jax(sizes):
    ours = ExportedPredictor(dict.fromkeys(sizes), {"platforms": ["cpu"]})
    theirs = JaxExportedPredictor(dict.fromkeys(sizes), {})
    for n in range(1, 131):
        assert ours.dispatch_plan(n) == theirs.dispatch_plan(n), n
    with pytest.raises(ValueError):
        ours.dispatch_plan(0)


class _CountingGraph:
    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def __call__(self, *a):
        self.calls += 1
        return self.inner(*a)


def test_dispatch_composition_avoids_padding_waste(tmp_path, predictors):
    """Batch 2 on a (1, 64) artifact runs two b1 graphs, not the 64-graph;
    large batches chunk into the largest graphs; near-miss batches still
    pad where composition would cost more under the call-overhead model."""
    _, pred = predictors
    path = export_predictor(pred, FRAME, path=str(tmp_path / "m164.gsx"), batch_sizes=(1, 64), frame_size=FRAME)
    served = ExportedPredictor.load(path)
    assert served.dispatch_plan(2) == [(1, 1), (1, 1)]
    assert served.dispatch_plan(64) == [(64, 64)]
    assert served.dispatch_plan(70) == [(64, 64)] + [(1, 1)] * 6
    assert served.dispatch_plan(63) == [(64, 63)]
    assert served.dispatch_plan(128) == [(64, 64), (64, 64)]

    served._graphs = {b: _CountingGraph(g) for b, g in served._graphs.items()}
    frames, base = _data(13, n=2)
    got = served(frames, base).numpy()
    assert served._graphs[1].calls == 2 and served._graphs[64].calls == 0
    want = pred.predict_dual_frames(frames, base, FRAME).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("upconvs", [False, True])
def test_export_roundtrip_int8(tmp_path, predictors, upconvs):
    """The int8 graph exports with its int8 weights and static activation
    scales inside, its quantized convs as gelslim::conv2d_int8 nodes, the
    epilogues of inc/conv1 and the float upconvs as gelslim::conv_epilogue
    nodes, and serves bit for bit as the live QuantizedPredictor."""
    _, pred = predictors
    frames, base = _data(12)
    qpred = pred.quantize(frames, base, quantize_upconvs=upconvs)
    assert qpred.q.has_int8_upconvs == upconvs
    path = export_predictor(qpred, FRAME, path=str(tmp_path / "q.gsx"), batch_sizes=(2,), frame_size=FRAME)
    served = ExportedPredictor.load(path)
    assert served.meta["kind"] == "int8_ptq"
    nodes = [str(n.target) for n in served._graphs[2].graph.nodes if "gelslim" in str(n.target)]
    float_upconvs = 0 if upconvs else len(CFG_KW["CNN_dimensions"]) - 1
    assert nodes.count("gelslim.conv2d_int8.default") == len(qpred.q.sites)
    assert nodes.count("gelslim.conv_epilogue.default") == 1 + float_upconvs
    assert len(nodes) == len(qpred.q.sites) + 1 + float_upconvs
    got = served(frames[:2], base)
    want = qpred.predict_dual_frames(frames[:2], base, FRAME)
    assert torch.equal(got, want)


def test_jax_artifact_and_other_device_refused(tmp_path, predictors):
    jpred, pred = predictors
    jpath = jax_export_predictor(jpred, FRAME, path=str(tmp_path / "jax.gsx"), batch_sizes=(1,), frame_size=FRAME)
    with pytest.raises(ValueError, match="not a torch artifact"):
        ExportedPredictor.load(jpath)
    with pytest.raises(ValueError, match="platforms"):
        export_predictor(pred, FRAME, path=str(tmp_path / "x.gsx"), batch_sizes=(1,), frame_size=FRAME,
                         platforms=("cuda",))


# -- the ops ---------------------------------------------------------------------

def _conv_case(form):
    g = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    def vec(n):
        return torch.rand(n, generator=g) + 0.5

    qx, bn = ints(2, 5, 6, 8), dict(bn_mul=vec(16), bn_add=vec(16) - 1.0, act="relu")
    q1, q2 = torch.tensor([0.05]), torch.tensor([0.11])
    if form == "float":
        return qx, ints(16, 3, 3, 8), 1, vec(16) * 1e-3, conv_int8.Epilogue(**bn), None, (0, 0)
    if form == "one_int8":
        ep = conv_int8.Epilogue(**bn, out_dtype=torch.bfloat16, q_scales=(q1,), store_float=False)
        return qx, ints(16, 3, 3, 8), 1, vec(16) * 1e-3, ep, None, (0, 0)
    if form == "two_int8_and_float":
        ep = conv_int8.Epilogue(**bn, out_dtype=torch.bfloat16, q_scales=(q1, q2))
        return qx, ints(16, 3, 3, 8), 1, vec(16) * 1e-3, ep, None, (0, 0)
    if form == "qx2_at_offset":
        ep = conv_int8.Epilogue(**bn, q_scales=(q1,), store_float=False)
        return qx, ints(16, 3, 3, 12), 1, vec(16) * 1e-3, ep, ints(2, 4, 5, 4), (1, 0)
    if form == "shuffle":
        ep = conv_int8.Epilogue(bias=vec(16), out_dtype=torch.bfloat16, shuffle=2, q_scales=(q1,), store_float=False)
        return qx, ints(16, 1, 1, 8), 0, vec(16) * 1e-3, ep, None, (0, 0)
    raise ValueError(form)


@pytest.mark.parametrize("form", ["float", "one_int8", "two_int8_and_float", "qx2_at_offset", "shuffle"])
def test_opcheck_conv2d_int8(form):
    qx, w, pad, scale, ep, qx2, offset = _conv_case(form)
    args = (qx, w, pad, scale, ep.bias, ep.bn_mul, ep.bn_add, ep.act, ep.out_dtype, ep.shuffle,
            list(ep.q_scales), ep.store_float, qx2, list(offset))
    torch.library.opcheck(torch.ops.gelslim.conv2d_int8.default, args)
    got = conv_int8.conv2d_int8(qx, w, pad=pad, scale=scale, epilogue=ep, qx2=qx2, offset=offset)
    want = conv_int8.conv2d_int8_reference(qx, w, pad=pad, scale=scale, epilogue=ep, qx2=qx2, offset=offset)
    assert type(got) is type(want)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_diff", [True, False])
def test_opcheck_fused_preprocess_dual(use_diff):
    g = torch.Generator().manual_seed(1)
    frames = torch.rand((2, 6, 16, 22), generator=g) * 255
    base = torch.rand((6, 16, 22), generator=g) * 255 if use_diff else None
    args = (frames, base, [1 / 255.0] * 3, [0.0, 0.5, -1.0], 8, 11, use_diff)
    torch.library.opcheck(torch.ops.gelslim.fused_preprocess_dual.default, args)
    got = preprocess_kernel.fused_preprocess_dual(frames, base, args[2], args[3], out_size=(8, 11), use_diff=use_diff)
    want = preprocess_kernel.fused_preprocess_dual_reference(frames, base, args[2], args[3], out_size=(8, 11),
                                                             use_diff=use_diff)
    assert torch.equal(got, want)


# -- on the card only ------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_exported_int8_graph_launches_the_kernels(tmp_path, predictors):
    """On the card the exported int8 graph equals the live one bit for bit,
    and one call launches conv2d_int8 once a quantized site and
    fused_preprocess_dual once, as the live call does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, pred = predictors
    frames, base = _data(14)
    card = Predictor(pred.config, pred.state_dict, compute_dtype=torch.bfloat16)
    qpred = card.quantize(frames, base)
    path = export_predictor(qpred, FRAME, path=str(tmp_path / "q.gsx"), batch_sizes=(2,), frame_size=FRAME)
    served = ExportedPredictor.load(path)
    f = torch.from_numpy(frames[:2]).cuda()
    b = torch.from_numpy(base).cuda()
    counts = []
    for run in (lambda: served(f, b), lambda: qpred.predict_dual_frames(f, b, FRAME)):
        before = preprocess_kernel.fused_preprocess_dual.launches, conv_int8.conv2d_int8.launches
        out = run()
        counts.append((preprocess_kernel.fused_preprocess_dual.launches - before[0],
                       conv_int8.conv2d_int8.launches - before[1]))
        torch.cuda.synchronize()
        if len(counts) == 1:
            got = out
    assert counts == [(1, len(qpred.q.sites))] * 2
    assert torch.equal(got, out)
