"""The port's span recorder (``utils/profiling.py``: ``span``, ``recording``
and the spans ``trace`` writes) and the spans of a serving call, on the
CPU: the float ``Predictor`` and the ``QuantizedPredictor`` (its quantized
convs on ``conv2d_int8``'s plain twin) at dims (8, 16, 32).

A serving call is one ``serve.call`` holding ``serve.front_end``,
``serve.unet`` and ``serve.post``; the U-Net's 2L - 1 blocks and its head
``outc`` are ``unet.block`` spans, and each conv launch, 2 a DoubleConv,
an upconv an up block and the head, a ``unet.conv`` span inside its block,
followed, where its epilogue is a ``conv_epilogue`` call, by that call's
``unet.epilogue`` span (every float conv but the head: all of them in the
float graph, ``inc/conv1`` and the upconvs in the int8 graph).
Span times share ``torch.profiler``'s clock, so each conv's aten event
lies inside its conv's span once both are on one time base."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.utils import profiling
from tests.torch_port_helpers import torch_threads

_spec = importlib.util.spec_from_file_location(
    "torch_fixture", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixture.py"))
_fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixture)

DIMS = (8, 16, 32)
L = len(DIMS)
CFG_KW = dict(
    CNN_dimensions=DIMS,
    input_tactile_image_size=(32, 43),
    image_normalization_method="0_255_to_0_1",
    depth_normalization_method="min_max_to_0_-1",
    depth_normalization_parameters=(-1.9, 0.0),
    norm_scale=0.9,
    use_difference_image=True,
    weights_name="unet_spans",
)
FRAME = (64, 86)
BLOCKS = ["inc"] + [f"down_{i}" for i in range(L - 1)] + [f"up_{j}" for j in range(L - 1)] + ["outc"]
CONVS = {"inc": ["conv1", "conv2"], "outc": ["conv"],
         **{f"down_{i}": ["conv1", "conv2"] for i in range(L - 1)},
         **{f"up_{j}": ["upconv", "conv1", "conv2"] for j in range(L - 1)}}
# the float convs whose epilogue is a conv_epilogue call, by graph
EPILOGUES = {"float": lambda block, conv: block != "outc", "int8": lambda block, conv: (
    (block, conv) == ("inc", "conv1") or conv == "upconv")}
N_EPILOGUES = {"float": 2 * (2 * L - 1) + (L - 1), "int8": 1 + (L - 1)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def served():
    rng = np.random.RandomState(16)
    pred = Predictor(GelslimConfig(**CFG_KW), _fixture.make_state_dict(rng, DIMS), device="cpu")
    frames = rng.uniform(0, 255, (2, 6, *FRAME)).astype(np.float32)
    base = rng.uniform(0, 255, (6, *FRAME)).astype(np.float32)
    images = rng.uniform(0, 255, (2, 3, *FRAME)).astype(np.float32)
    return {"float": pred, "int8": pred.quantize(frames, base)}, frames, base, images


def _serve(served, kind, entry):
    preds, frames, base, images = served
    if entry == "dual":
        return preds[kind].predict_dual_frames(frames, base, FRAME)
    return preds[kind].predict_depth_from_RGB(images, FRAME)


def _children(spans, parent):
    return [i for i, s in enumerate(spans) if s.parent == parent]


def test_off_records_nothing_and_reads_no_clock(served, monkeypatch):
    """Off, ``span`` hands out one shared object, and a serving call reads
    no clock through the recorder and leaves no span behind."""
    assert profiling.span("serve.call") is profiling.span("unet.conv", "conv1")

    def no_clock():
        raise AssertionError("the clock was read with the recorder off")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    for kind in ("float", "int8"):
        _serve(served, kind, "dual")
    monkeypatch.undo()
    with profiling.recording() as spans:
        assert spans == []


def test_nesting_parent_and_call():
    """Hand-checked indices: a span outside ``serve.call`` has no call; the
    spans inside one name its index; a nested ``recording()`` shares the
    outer list and leaves the recorder on."""
    with profiling.recording() as spans:
        with profiling.span("outer"):
            with profiling.span(profiling.CALL):
                with profiling.span("serve.unet"):
                    with profiling.recording() as inner:
                        assert inner is spans
                    with profiling.span("unet.block", "inc"):
                        pass
            with profiling.span("after", "x"):
                pass
    assert profiling.span("x") is profiling.span("y")
    got = [(s.name, s.site, s.parent, s.call) for s in spans]
    assert got == [("outer", None, None, None), (profiling.CALL, None, 0, 1), ("serve.unet", None, 1, 1),
                   ("unet.block", "inc", 2, 1), ("after", "x", 0, None)]
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


@pytest.mark.parametrize("kind,entry", [("float", "dual"), ("int8", "dual"), ("float", "rgb")])
def test_serving_call_span_tree(served, kind, entry):
    with profiling.recording() as spans:
        _serve(served, kind, entry)
    (call,) = [i for i, s in enumerate(spans) if s.name == profiling.CALL]
    assert call == 0 and spans[0].parent is None
    assert all(s.call == call and s.end_ns is not None for s in spans)
    stages = _children(spans, call)
    assert [spans[i].name for i in stages] == ["serve.front_end", "serve.unet", "serve.post"]
    unet = stages[1]
    blocks = _children(spans, unet)
    assert [(spans[i].name, spans[i].site) for i in blocks] == [("unet.block", b) for b in BLOCKS]
    for b in blocks:
        convs = _children(spans, b)
        block = spans[b].site
        assert [(spans[i].name, spans[i].site) for i in convs] == [
            span for c in CONVS[block]
            for span in [("unet.conv", c)] + [("unet.epilogue", c)] * EPILOGUES[kind](block, c)]
        assert all(not _children(spans, i) for i in convs)
    n_convs = sum(s.name == "unet.conv" for s in spans)
    n_epilogues = sum(s.name == "unet.epilogue" for s in spans)
    assert n_convs == 2 * (2 * L - 1) + (L - 1) + 1 and n_epilogues == N_EPILOGUES[kind]
    assert len(spans) == 1 + 3 + len(BLOCKS) + n_convs + n_epilogues
    for s in spans[1:]:
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


@pytest.mark.parametrize("kind,entry", [("float", "dual"), ("int8", "dual"), ("float", "rgb")])
def test_outputs_bit_equal_with_recorder_on(served, kind, entry):
    off = _serve(served, kind, entry)
    with profiling.recording():
        on = _serve(served, kind, entry)
    assert torch.equal(off, on)


def _inside(t0, t1, spans, name):
    """Whether [t0, t1] lies inside one of the (name, start, end) spans
    named ``name``."""
    return any(n == name and a <= t0 and t1 <= b for n, a, b in spans)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_aten_events_lie_in_their_spans_on_the_profilers_clock(served, kind):
    """Under torch.profiler with CPU activity, each span mapped to the
    trace's microseconds by ``trace_start_ns``: every aten::convolution
    inside a ``unet.conv`` span, every aten event inside ``serve.call``."""
    from torch.profiler import ProfilerActivity, profile

    with profiling.recording() as spans, profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(served, kind, "dual")
    base = prof.profiler.kineto_results.trace_start_ns()
    us = [(s.name, (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3) for s in spans]
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    convs = [e for e in aten if e.name == "aten::convolution"]
    # the float head and the float convs: inc/conv1 and, in the int8 graph,
    # the upconvs (its int8 twin computes in integers)
    assert len(convs) >= (2 + L - 1 if kind == "int8" else 5 * L - 2)
    for e in convs:
        assert _inside(e.time_range.start, e.time_range.end, us, "unet.conv"), e
    for e in aten:
        assert _inside(e.time_range.start, e.time_range.end, us, profiling.CALL), e


def test_trace_writes_spans_on_the_files_clock(served, tmp_path):
    """``trace`` writes the block's spans into its Chrome trace, on a track
    of their own; every aten::convolution there lies inside a ``unet.conv``
    span event, on the file's own time base."""
    log_dir = tmp_path / "trace"
    with profiling.recording() as outer:
        with profiling.trace(str(log_dir)):
            _serve(served, "float", "dual")
    (name,) = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    with open(log_dir / name) as f:
        events = json.load(f)["traceEvents"]
    marked = [e for e in events if e.get("cat") == "span"]
    assert len(marked) == len(outer) == 1 + 3 + len(BLOCKS) + 5 * L - 2 + N_EPILOGUES["float"]
    assert {e["tid"] for e in marked} == {profiling.SPAN_TRACK}
    assert any(e.get("ph") == "M" and e.get("tid") == profiling.SPAN_TRACK for e in events)
    spans = [(e["name"].split(" ")[0], e["ts"], e["ts"] + e["dur"]) for e in marked]
    convs = [e for e in events if e.get("ph") == "X" and e.get("name") == "aten::convolution"]
    assert len(convs) == 5 * L - 2
    eps = 2e-3  # the file's microseconds carry three decimals
    for e in convs:
        assert _inside(e["ts"] + eps, e["ts"] + e["dur"] - eps, spans, "unet.conv"), e
