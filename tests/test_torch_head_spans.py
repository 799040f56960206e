"""The ``head.conv`` spans of the transformers' heads and Depth Pro's decoder
(``models/dpt.py::_head_conv``), on the CPU at the small sizes of
``tests/test_torch_dpt.py``, ``test_torch_vda.py`` and
``test_torch_depth_pro.py``: every conv, transposed conv and 1x1
``F.linear`` call of a head or decoder lies alone in a ``head.conv`` span of
its own, which holds no other work, on the CPU's route and on the card's
(``_epilogue_bias``); the spans' sites name the convs as the op model
``benchmark/yardstick_depth_pro.py`` names them; the depth is the same bit
for bit with the recorder on; and the three readers of the spans
(``benchmark/metrics/decoder_conv_roofline.depth_pro.py``,
``decoder_passes_roofline.depth_pro.py``, ``head_passes_ms.py``) read a
made-up slice as worked out by hand below, and read nothing without the
spans."""

import collections
import contextlib
import json
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import harness, inputs, spans, trace, yardstick, yardstick_depth_pro
from benchmark.loops import closed_depth_pro, closed_dpt, closed_vda
from benchmark.yardstick_dpt import op_ms
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.models.depth_pro import DepthPro
from gelslim_depth_tpu_torch.models.dpt import DPT
from gelslim_depth_tpu_torch.utils import profiling
from tests import test_torch_depth_pro, test_torch_dpt, test_torch_vda
from tests.test_torch_benchmark_spans import BASE_NS, _event, _span
from tests.torch_port_helpers import card_route, torch_threads

CONV = "head.conv"
LAYERS = {"dpt": ("dpt.head",), "vda": ("dpt.head",),
          "depth_pro": ("depth_pro.upsample", "depth_pro.fusion", "depth_pro.head")}
# the aten ops a conv call dispatches on the CPU: the conv, or the 1x1's
# matrix product (with its bias) and the views around it
COMPUTE = {"aten.convolution.default", "aten.mm.default", "aten.addmm.default"}
VIEWS = {"aten.t.default", "aten.view.default", "aten._unsafe_view.default"}

_UNIT = ["unit1.conv1", "unit1.conv2", "unit2.conv1", "unit2.conv2"]
# the DPT head's 32 sites in the order they open, each after its layer's site
DPT_SITES = (["layer1.proj", "layer1.resize", "layer1_rn", "layer2.proj", "layer2.resize", "layer2_rn",
              "layer3.proj", "layer3_rn", "layer4.proj", "layer4.resize", "layer4_rn"]
             + [f"refinenet4/{s}" for s in _UNIT[2:] + ["out"]]
             + [f"refinenet{k}/{s}" for k in (3, 2, 1) for s in _UNIT + ["out"]]
             + ["output_conv1", "output_conv2.0", "output_conv2.2"])


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _model(kind):
    """(the model in float32, its input, the forward's streams) at the test
    modules' small size, on the benchmark's seeded weights."""
    g = inputs.generator("cpu", 5, inputs.WEIGHTS)
    if kind == "depth_pro":
        cfg = test_torch_depth_pro.SMALL
        net = DepthPro(GelslimConfig.from_json(json.dumps(cfg)).depth_pro_config())
        net.load_state_dict(closed_depth_pro.weights(cfg, g, "cpu"))
        return net, torch.randn(1, 3, *cfg["input_tactile_image_size"], generator=torch.Generator().manual_seed(3)), 1
    small = {"dpt": test_torch_dpt.SMALL, "vda": test_torch_vda.SMALL}[kind]
    net = DPT(GelslimConfig.from_json(json.dumps(small)).dpt_config())
    net.load_state_dict((closed_vda if kind == "vda" else closed_dpt).weights(small, g, "cpu"))
    frames = 8 if kind == "vda" else 2
    x = torch.randn(frames, 3, *small["input_tactile_image_size"], generator=torch.Generator().manual_seed(3))
    return net, x, 2 if kind == "vda" else 1


def _open():
    """The index of the innermost span open now, or None."""
    rec = profiling._recorder
    return rec.open[-1] if rec is not None and rec.open else None


def _within(recorded, i, names):
    while i is not None:
        if recorded[i].name in names:
            return True
        i = recorded[i].parent
    return False


@contextlib.contextmanager
def _functional_calls():
    """Records each ``F.conv2d``, ``F.conv_transpose2d`` and ``F.linear``
    call made in the block: (the function's name, the innermost open span)."""
    calls = []
    names = ("conv2d", "conv_transpose2d", "linear")
    originals = {n: getattr(F, n) for n in names}

    def spy(name, fn):
        def call(*args, **kwargs):
            calls.append((name, _open()))
            return fn(*args, **kwargs)
        return call

    for n in names:
        setattr(F, n, spy(n, originals[n]))
    try:
        yield calls
    finally:
        for n in names:
            setattr(F, n, originals[n])


class _AtenOps(TorchDispatchMode):
    """Records each aten op run in the block with the innermost open span."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((str(func), _open()))
        return func(*args, **(kwargs or {}))


def _labels(recorded):
    """``SpanTrace.label`` of each ``head.conv`` span, in the order they open."""
    st = object.__new__(spans.SpanTrace)
    st.spans = recorded
    return [st.label(i) for i, s in enumerate(recorded) if s.name == CONV]


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("kind", ["dpt", "depth_pro"])
def test_every_head_conv_call_is_alone_in_a_head_conv_span(kind, route, monkeypatch):
    """Each conv, transposed conv and 1x1 ``F.linear`` call of the head or
    decoder is made inside a ``head.conv`` span, one call a span; a span
    dispatches one conv or matrix product and only views besides (no
    epilogue, ReLU, add, resize, concat or copy) and holds no span; no call
    outside the head or decoder is in one."""
    if route == "card":
        card_route(monkeypatch)
    net, x, streams = _model(kind)
    with torch.no_grad(), profiling.recording() as recorded, _functional_calls() as calls, _AtenOps() as aten:
        net(x, streams) if kind != "depth_pro" else net(x)
    convs = [i for i, s in enumerate(recorded) if s.name == CONV]
    assert len(convs) == {"dpt": 32, "depth_pro": 50}[kind]
    assert all(_within(recorded, i, LAYERS[kind]) for i in convs)
    head_calls = [i for _, i in calls if _within(recorded, i, LAYERS[kind])]
    assert sorted(head_calls) == convs
    assert not any(_within(recorded, i, (CONV,)) for _, i in calls if i not in convs)
    assert not any(s.parent in convs for s in recorded)
    inside = [op for op, i in aten.ops if i in convs]
    assert set(inside) <= COMPUTE | VIEWS
    assert collections.Counter(i for op, i in aten.ops if i in convs and op in COMPUTE) == {i: 1 for i in convs}


@pytest.mark.parametrize("kind", ["dpt", "vda", "depth_pro"])
def test_head_conv_sites_name_the_convs(kind):
    """The DPT and video heads open their 32 sites, the temporal modules
    none; Depth Pro's 50 labels, ``/`` read as ``.``, are one to one the
    conv and transposed-conv ops of ``yardstick_depth_pro.decoder_ops``."""
    net, x, streams = _model(kind)
    with torch.no_grad(), profiling.recording() as recorded:
        net(x, streams) if kind != "depth_pro" else net(x)
    labels = _labels(recorded)
    assert all(label.startswith(CONV + " ") for label in labels)
    sites = [label[len(CONV) + 1:] for label in labels]
    if kind != "depth_pro":
        assert sites == DPT_SITES
        return
    ops = yardstick_depth_pro.decoder_ops(test_torch_depth_pro.SMALL, 2)
    conv_ops = [op.name for op in ops if op.name.rsplit(".", 1)[-1] not in yardstick_depth_pro.ELEMENTWISE]
    assert len(sites) == len(conv_ops) == 50
    assert sorted(s.replace("/", ".") for s in sites) == sorted(conv_ops)


@pytest.mark.parametrize("kind", ["dpt", "depth_pro"])
def test_depth_is_the_same_with_the_recorder_on(kind):
    net, x, streams = _model(kind)
    with torch.no_grad():
        off = net(x, streams) if kind != "depth_pro" else net(x)
        with profiling.recording() as recorded:
            on = net(x, streams) if kind != "depth_pro" else net(x)
    assert sum(s.name == CONV for s in recorded) > 0
    assert torch.equal(off, on)


# ---------------------------------------------------------------------------
# the readers, on made-up slices of one call (times in microseconds on the
# trace's clock): (name, site, start, end, parent, call)
# ---------------------------------------------------------------------------

DEPTH_PRO_SPANS = [
    ("serve.call", None, 100, 1100, None, 0),               # 0
    ("depth_pro.upsample", None, 110, 300, 0, 0),           # 1
    ("head.conv", "latent0.proj", 120, 150, 1, 0),          # 2
    ("depth_pro.fusion", "level0", 300, 600, 0, 0),         # 3
    ("head.conv", "unit1.conv1", 320, 400, 3, 0),           # 4
    ("depth_pro.head", None, 600, 900, 0, 0),               # 5
    ("head.conv", "head.0", 610, 700, 5, 0),                # 6
]
# (correlation id, runtime call's start, device op's start, end): a conv
# and a pass in each of the three spans, and the call's own op
DEPTH_PRO_LAUNCHES = [(1, 125, 130, 230), (2, 200, 230, 260), (3, 330, 330, 530), (4, 450, 530, 570),
                      (5, 620, 620, 920), (6, 750, 920, 1000), (7, 950, 1000, 1010)]
DPT_SPANS = [
    ("serve.call", None, 100, 1000, None, 0),               # 0
    ("dpt.encoder", None, 100, 200, 0, 0),                  # 1
    ("dpt.head", None, 200, 900, 0, 0),                     # 2
    ("dpt.fusion", "refinenet1", 300, 600, 2, 0),           # 3
    ("head.conv", "unit1.conv1", 320, 400, 3, 0),           # 4
]
DPT_LAUNCHES = [(1, 150, 150, 200), (2, 250, 250, 320), (3, 330, 330, 530), (4, 450, 530, 560)]
# by hand: Depth Pro's convs 100 + 200 + 300 us, its passes 30 + 40 + 80;
# the DPT head's convs 200 us, its passes 70 + 30
CONV_MS, PASSES_MS, DPT_PASSES_MS = 0.6, 0.15, 0.1


def _made_up(recorded, launches, with_spans=True):
    events = []
    for corr, host, s, e in launches:
        events.append(_event("cudaLaunchKernel", DeviceType.CPU, host, host + 3, corr))
        events.append(_event(f"kernel_{corr}", DeviceType.CUDA, s, e, corr))
    prof = SimpleNamespace(events=lambda: events,
                           profiler=SimpleNamespace(kineto_results=SimpleNamespace(trace_start_ns=lambda: BASE_NS)))
    return spans.SpanTrace(prof, 1, 2000e-6, [_span(*s) for s in recorded] if with_spans else [])


def _ctx():
    cell = harness.find_cell("depth_pro_batch8")
    return {"config": cell.config, "traffic": cell.traffic, "peaks": yardstick.card_peaks("NVIDIA H100 80GB HBM3")}


def _bounds(ctx):
    """(the op model's conv bound, its passes' bound) in ms a call."""
    images = 2 * ctx["traffic"]["dual_frames_per_call"]
    ops = yardstick_depth_pro.decoder_ops(ctx["config"], images)
    passes = [op.name.rsplit(".", 1)[-1] in yardstick_depth_pro.ELEMENTWISE for op in ops]
    return (sum(op_ms(op, ctx["peaks"]) for op, p in zip(ops, passes) if not p),
            sum(op_ms(op, ctx["peaks"]) for op, p in zip(ops, passes) if p))


READERS = {
    "decoder_conv_roofline.depth_pro": (DEPTH_PRO_SPANS, DEPTH_PRO_LAUNCHES),
    "decoder_passes_roofline.depth_pro": (DEPTH_PRO_SPANS, DEPTH_PRO_LAUNCHES),
    "head_passes_ms.dpt": (DPT_SPANS, DPT_LAUNCHES),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_head_readers_on_a_made_up_slice(metric):
    ctx = _ctx()
    conv_bound, passes_bound = _bounds(ctx)
    assert conv_bound == pytest.approx(92.031, abs=1e-3) and passes_bound == pytest.approx(34.047, abs=1e-3)
    want = {"decoder_conv_roofline.depth_pro": 100 * conv_bound / CONV_MS,
            "decoder_passes_roofline.depth_pro": 100 * passes_bound / PASSES_MS,
            "head_passes_ms.dpt": DPT_PASSES_MS}[metric]
    assert harness.load_reader(metric)(_made_up(*READERS[metric]), ctx) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_head_readers_read_nothing_without_the_spans(metric):
    """A plain Trace, a slice without spans, and a slice whose program has
    its layers' spans but no ``head.conv`` (as before the spans) read
    nothing."""
    read = harness.load_reader(metric)
    ctx = _ctx()
    plain = trace.Trace(SimpleNamespace(events=lambda: [_event("k", DeviceType.CUDA, 0, 10, 1)]), 1, 1e-3)
    assert read(plain, ctx) is None
    recorded, launches = READERS[metric]
    assert read(_made_up(recorded, launches, with_spans=False), ctx) is None
    assert read(_made_up([s for s in recorded if s[0] != CONV], launches), ctx) is None


def test_decoder_split_adds_up_to_the_decoder_roofline():
    """The convs' and the passes' device ms are the two parts of what
    ``decoder_roofline.depth_pro`` divides its bound by."""
    ctx = _ctx()
    st = _made_up(DEPTH_PRO_SPANS, DEPTH_PRO_LAUNCHES)
    conv_bound, passes_bound = _bounds(ctx)
    conv, passes, whole = (harness.load_reader(m)(st, ctx) for m in (
        "decoder_conv_roofline.depth_pro", "decoder_passes_roofline.depth_pro", "decoder_roofline.depth_pro"))
    assert conv_bound / conv + passes_bound / passes == pytest.approx((conv_bound + passes_bound) / whole)
    assert (conv_bound + passes_bound) / whole == pytest.approx((CONV_MS + PASSES_MS) / 100)
