"""The port's StreamingEngine against the JAX package's, on the CPU: the
same API and semantics (bounded queue, drop policies, power-of-2
micro-batches, base refresh, the undrained-results warning, stats), and the
same outputs. Mirrors the engine tests of tests/test_inference.py and
tests/test_quantize.py.

Bars: a drained output equals the port's predict_dual_frames of its frame
at 1e-6 (tests/test_inference.py's bar), and the JAX engine's drained output
on the same weights (carried with params_from_jax) at rtol/atol 1e-3, the
bar of tests/test_torch_inference.py. The coalescing tests drive a double
whose readiness the test flips, through the engine's one readiness seam
(``inference._completion``, the dispatch's "done" object).
"""

import importlib.util
import os
import time
import warnings

import numpy as np
import pytest
import torch

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.inference import Predictor as JaxPredictor
from gelslim_depth_tpu.inference import StreamingEngine as JaxStreamingEngine
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu_torch import inference
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor, StreamingEngine
from gelslim_depth_tpu_torch.models import params_from_jax
from gelslim_depth_tpu_torch.models.unet import init_unet

# by path: where an installed package owns the name `tests`, `from
# tests.torch_fixture import ...` finds that package instead
_spec = importlib.util.spec_from_file_location(
    "torch_fixture", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixture.py"))
_fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixture)

DIMS = (8, 16, 32)
OUT = (80, 107)
CFG_KW = dict(
    CNN_dimensions=DIMS,
    input_tactile_image_size=(40, 53),
    depth_normalization_parameters=(-1.9180814027786255, 0.0),
    image_normalization_method="0_255_to_0_1",
    depth_normalization_method="min_max_to_0_-1",
    norm_scale=0.9,
)


@pytest.fixture(scope="module")
def bundle():
    rng = np.random.RandomState(42)
    sd = _fixture.make_state_dict(rng, DIMS)
    out = {"rng": rng}
    for diff in (False, True):
        jcfg = JaxConfig(**CFG_KW, use_difference_image=diff)
        params, stats = import_torch_state_dict(sd, jcfg.unet_config())
        cfg = GelslimConfig(**CFG_KW, use_difference_image=diff)
        out[diff] = (JaxPredictor(jcfg, params, stats),
                     Predictor(cfg, params_from_jax(params, stats, cfg.unet_config()), device="cpu"))
    return out


def _frames(rng, k):
    return [rng.uniform(0, 255, (6, *OUT)).astype(np.float32) for _ in range(k)]


def _live(pred, frame, base):
    return pred.predict_dual_frames(frame[None], base, OUT).numpy()


def test_streaming_engine(bundle):
    rng = bundle["rng"]
    jpred, pred = bundle[False]
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    frames = _frames(rng, 4)
    eng = StreamingEngine(pred, OUT, base_frame=base)
    jeng = JaxStreamingEngine(jpred, OUT, base_frame=base)
    for f in frames:
        eng.submit(f)
        jeng.submit(f)
    assert eng.pending == 4
    outs, jouts = eng.drain(), jeng.drain()
    assert len(outs) == 4 and all(isinstance(o, np.ndarray) for o in outs)
    assert outs[0].shape == (1, 2, *OUT) and outs[0].dtype == np.float32
    np.testing.assert_allclose(outs[2], _live(pred, frames[2], base), rtol=1e-6, atol=1e-6)
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)


def test_streaming_engine_bounded_drop_oldest(bundle):
    """Default live-view policy: the queue never exceeds max_inflight; the
    oldest pending result is discarded (and counted) to admit a new frame,
    and FIFO order of the survivors holds."""
    rng = bundle["rng"]
    _, pred = bundle[False]
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    eng = StreamingEngine(pred, OUT, base_frame=base, max_inflight=2)
    frames = _frames(rng, 5)
    for f in frames:
        assert eng.submit(f)  # always admitted under drop-oldest
    assert eng.pending == 2
    st = eng.stats()
    assert st["submitted"] == 5 and st["dropped"] == 3
    outs = eng.drain()
    for got, f in zip(outs, frames[3:]):  # the two survivors are the newest two, in order
        np.testing.assert_allclose(got, _live(pred, f, base), rtol=1e-6, atol=1e-6)
    st = eng.stats()
    assert st["completed"] == 2 and st["pending"] == 0
    assert st["mean_latency_ms"] > 0 and st["throughput_fps"] > 0
    assert set(st) == set(JaxStreamingEngine(bundle[False][0], OUT).stats())


def test_streaming_engine_drop_newest_and_block(bundle):
    rng = bundle["rng"]
    _, pred = bundle[False]
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    frames = _frames(rng, 4)

    eng = StreamingEngine(pred, OUT, base_frame=base, max_inflight=2, drop_policy="newest")
    admitted = [eng.submit(f) for f in frames]
    assert admitted == [True, True, False, False]
    assert eng.pending == 2 and eng.stats()["dropped"] == 2
    # the survivors are the oldest two
    np.testing.assert_allclose(eng.get(), _live(pred, frames[0], base), rtol=1e-6, atol=1e-6)

    eng = StreamingEngine(pred, OUT, base_frame=base, max_inflight=2, drop_policy="block")
    for f in frames:
        assert eng.submit(f)  # backpressure, nothing dropped
    assert eng.stats()["dropped"] == 0
    assert len(eng.drain()) == 4

    for kw in ({"drop_policy": "nope"}, {"max_inflight": 0}, {"microbatch": 0}, {"max_dispatches": 0}):
        with pytest.raises(ValueError):
            StreamingEngine(pred, OUT, **kw)


def test_streaming_engine_base_refresh(bundle):
    """update_base takes effect for subsequent submissions (regrasp flow)."""
    rng = bundle["rng"]
    _, pred = bundle[True]
    base1, base2, frame = (rng.uniform(0, 255, (6, *OUT)).astype(np.float32) for _ in range(3))
    eng = StreamingEngine(pred, OUT, base_frame=base1)
    eng.submit(frame)
    eng.update_base(base2)
    eng.submit(frame)
    a, b = eng.drain()
    assert not np.allclose(a, b)  # different base -> different diff image
    np.testing.assert_allclose(a, _live(pred, frame, base1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b, _live(pred, frame, base2), rtol=1e-6, atol=1e-6)


def test_streaming_engine_coalesced_outputs_match_real_predictor(bundle):
    """The real predictor with coalescing forced (deep queue, one dispatch
    slot, the device held busy): every drained output equals the
    per-frame fused graph and the JAX engine's, in submission order."""
    rng = np.random.RandomState(11)
    jpred, pred = bundle[False]
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    frames = _frames(rng, 7)
    kw = dict(base_frame=base, max_inflight=8, microbatch=4, max_dispatches=1)
    eng, jeng = StreamingEngine(pred, OUT, **kw), JaxStreamingEngine(jpred, OUT, **kw)
    busy = _Device(idle=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(inference, "_completion", lambda out: _FakeDone(busy))
        for f in frames:
            assert eng.submit(f)
            jeng.submit(f)
        outs = eng.drain()
    st = eng.stats()
    assert st["completed"] == 7 and st["dropped"] == 0 and st["dispatches"] < 7
    for got, want, f in zip(outs, jeng.drain(), frames):
        np.testing.assert_allclose(got, _live(pred, f, base), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)


def test_streaming_engine_accepts_quantized_predictor():
    """The engine pipelines any predictor with predict_dual_frames_multi,
    the int8 one included."""
    rng = np.random.RandomState(5)
    cfg = GelslimConfig(
        CNN_dimensions=(4, 8), input_tactile_image_size=(16, 21),
        image_normalization_method="0_255_to_0_1", depth_normalization_method="min_max_to_0_-1",
        depth_normalization_parameters=(-1.9, 0.0), norm_scale=0.9, use_difference_image=True,
    )
    params, stats = init_unet(cfg.unet_config(), torch.Generator().manual_seed(5))
    pred = Predictor(cfg, {**params, **stats}, device="cpu")
    frames = rng.uniform(0, 255, (4, 6, 32, 43)).astype(np.float32)
    base = rng.uniform(0, 255, (6, 32, 43)).astype(np.float32)
    qpred = pred.quantize(frames, base)

    eng = StreamingEngine(qpred, (32, 43), base_frame=base)
    for f in frames:
        eng.submit(f)
    outs = eng.drain()
    assert len(outs) == 4 and outs[0].shape == (1, 2, 32, 43)
    for got, f in zip(outs, frames):
        want = qpred.predict_dual_frames(f[None], base, (32, 43)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- the coalescing logic, on a double ----------------------------------------

class _Device:
    def __init__(self, idle):
        self.idle = idle


class _FakeDone:
    """A dispatch's "done" object whose readiness the test controls."""

    def __init__(self, device):
        self._device = device

    def query(self):
        return self._device.idle

    def synchronize(self):
        self._device.idle = True


class _FakePredictor:
    """Deterministic CPU double: each (1, 6, H, W) frame maps to a (2, h, w)
    output filled with the frame's first value, so FIFO order and
    micro-batch row routing are directly observable."""

    def __init__(self, output_size=(4, 5)):
        self.output_size = output_size
        self.dispatch_sizes = []
        self.dispatch_bases = []

    def predict_dual_frames_multi(self, frames_list, base_frame, output_size):
        self.dispatch_sizes.append(len(frames_list))
        self.dispatch_bases.append(None if base_frame is None else float(base_frame.flatten()[0]))
        return torch.stack([torch.full((2, *output_size), float(f.flatten()[0])) for f in frames_list])


@pytest.fixture
def device(monkeypatch):
    """The device's busy state, a flag the test flips; every dispatch's
    "done" object reads it."""
    dev = _Device(idle=False)
    monkeypatch.setattr(inference, "_completion", lambda out: _FakeDone(dev))
    return dev


def _const_frame(v):
    return np.full((6, 8, 9), float(v), dtype=np.float32)


def test_streaming_engine_coalesces_while_device_busy(device):
    """Frames submitted while the device is busy coalesce: fewer dispatches
    than frames, power-of-2 micro-batch sizes capped at `microbatch`,
    outputs correct and FIFO-ordered."""
    fake = _FakePredictor()
    eng = StreamingEngine(fake, fake.output_size, max_inflight=16, microbatch=4, max_dispatches=1)
    eng.submit(_const_frame(0))  # an idle slot: the first frame dispatches alone
    assert fake.dispatch_sizes == [1]
    for i in range(1, 9):  # device busy: the next 8 frames queue on the host
        eng.submit(_const_frame(i))
    assert fake.dispatch_sizes == [1] and eng.pending == 9
    device.idle = True  # the slot frees: one micro-batch of 4 (the cap)
    eng.submit(_const_frame(9))
    assert fake.dispatch_sizes == [1, 4]
    outs = eng.drain()  # flush dispatches the remaining 5 as 4 + 1
    assert fake.dispatch_sizes == [1, 4, 4, 1]
    assert [float(o.flat[0]) for o in outs] == list(range(10))  # FIFO
    st = eng.stats()
    assert st["dispatches"] == 4 and st["mean_dispatch_size"] == 2.5
    assert st["completed"] == 10 and st["dropped"] == 0


def test_streaming_engine_power_of_two_bucketing(device):
    """3 pending frames dispatch as 2 + 1, never as a 3-frame call."""
    fake = _FakePredictor()
    eng = StreamingEngine(fake, fake.output_size, max_inflight=16, microbatch=8, max_dispatches=1)
    eng.submit(_const_frame(0))
    for i in range(1, 4):
        eng.submit(_const_frame(i))
    device.idle = True
    outs = eng.drain()
    assert fake.dispatch_sizes == [1, 2, 1]
    assert [float(o.flat[0]) for o in outs] == [0.0, 1.0, 2.0, 3.0]


def test_streaming_engine_queued_frames_keep_submission_base(device):
    """update_base flushes queued frames under the base they were
    submitted with; only later submissions see the new base."""
    fake = _FakePredictor()
    eng = StreamingEngine(fake, fake.output_size, base_frame=_const_frame(100),
                          max_inflight=16, microbatch=4, max_dispatches=1)
    eng.submit(_const_frame(0))          # dispatches under base 100
    eng.submit(_const_frame(1))          # queues (device busy)
    eng.update_base(_const_frame(200))   # flushes frame 1 under base 100
    device.idle = True
    eng.submit(_const_frame(2))          # dispatches under base 200
    eng.drain()
    assert fake.dispatch_bases == [100.0, 100.0, 200.0]


def test_streaming_engine_block_mode_warns_on_undrained_results(device):
    """drop_policy='block' never drops, but an undraining consumer grows
    the unclaimed-result queue: the engine warns once past results_warn."""
    fake = _FakePredictor()
    device.idle = True
    eng = StreamingEngine(fake, fake.output_size, max_inflight=1, drop_policy="block",
                          results_warn=2, max_dispatches=1)
    with pytest.warns(RuntimeWarning, match="not draining"):
        for i in range(6):
            eng.submit(_const_frame(i))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warns only once
        eng.submit(_const_frame(6))
    assert eng.stats()["dropped"] == 0
    outs = eng.drain()
    assert [float(o.flat[0]) for o in outs] == list(range(7))


# -- on the card only ----------------------------------------------------------

@pytest.mark.cuda
def test_cuda_submit_does_not_wait_for_the_dispatch_in_flight():
    """With the stream held busy, submit returns while the dispatch before
    it still reports not done: the frame's upload (pinned, non_blocking)
    does not synchronize the stream. The outputs still equal the live
    predictor's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(3)
    cfg = GelslimConfig(**CFG_KW, use_difference_image=True)
    pred = Predictor(cfg, _fixture.make_state_dict(rng, DIMS), compute_dtype=torch.bfloat16)
    base = rng.uniform(0, 255, (6, *OUT)).astype(np.float32)
    frames = _frames(rng, 4)
    eng = StreamingEngine(pred, OUT, base_frame=base, max_inflight=8, max_dispatches=2)
    for f in frames:  # warm: the pinned host blocks and the caches exist
        eng.submit(f)
    warm = eng.drain()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time on the current stream
    t0 = time.perf_counter()
    eng.submit(frames[0])  # dispatches behind the sleep
    eng.submit(frames[1])
    host_s = time.perf_counter() - t0
    in_flight = [d.done.query() for d in eng._outstanding]
    assert len(in_flight) == 2 and not any(in_flight), f"submit waited for the device ({host_s:.4f} s)"
    outs = warm + eng.drain()
    for got, f in zip(outs, frames + frames[:2]):
        want = pred.predict_dual_frames(f[None], base, OUT).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
