"""``benchmark/spans.py`` on a made-up trace: the attribution of each device
op to the innermost span open when its runtime call started, matched by
correlation id, and the six readers that read the program's spans
(``benchmark/metrics/{host_issue_ms,call_idle_ms,launches_per_call,
unet_conv_ms,unet_passes_ms,post_ms}.py``), against values worked out by
hand below."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans, trace

BASE_NS = 5_000_000_000

# two calls, times in microseconds on the trace's clock:
# (name, site, start, end, parent, call)
SPANS = [
    ("serve.call", None, 100, 500, None, 0),          # 0
    ("serve.front_end", None, 110, 150, 0, 0),        # 1
    ("serve.unet", None, 150, 400, 0, 0),             # 2
    ("unet.block", "inc", 160, 390, 2, 0),            # 3
    ("unet.conv", "conv1", 170, 200, 3, 0),           # 4
    ("serve.post", None, 400, 480, 0, 0),             # 5
    ("serve.call", None, 600, 900, None, 6),          # 6
    ("serve.front_end", None, 610, 620, 6, 6),        # 7
    ("serve.unet", None, 620, 850, 6, 6),             # 8
    ("unet.block", "inc", 630, 840, 8, 6),            # 9
    ("unet.conv", "conv1", 640, 660, 9, 6),           # 10
    ("serve.post", None, 850, 890, 6, 6),             # 11
]
# (correlation id, runtime call's start, device op's start, end): the
# front end, a conv launched from inside its block (a nested span), the
# block's own pass, the post; an op launched outside every span (9) and
# one with no runtime call in the trace (99)
LAUNCHES = [
    (1, 120, 130, 180), (2, 175, 180, 300), (3, 250, 300, 340), (4, 410, 450, 470),
    (5, 615, 615, 640), (6, 650, 650, 700), (7, 700, 700, 760), (8, 860, 860, 880),
    (9, 950, 950, 960),
]
UNLAUNCHED = (99, 970, 975)
UNITS, WINDOW_S = 2, 1000e-6

# by hand: device busy [130,340] [450,470] [615,640] [650,760] [860,880]
# [950,960] [970,975] = 400 us; call 0 idles 170 us of its 400, call 6 145
# of its 300
EXPECTED = {
    "host_issue_ms.batch": (400 + 300) / 2 / 1e3,
    "call_idle_ms.batch": (170 + 145) / 2 / 1e3,
    "launches_per_call.batch": 8 / 2,
    "unet_conv_ms.batch": (120 + 50) / 2 / 1e3,
    "unet_passes_ms.batch": (40 + 60) / 2 / 1e3,
    "post_ms.batch": (20 + 20) / 2 / 1e3,
}


def _event(name, kind, start, end, corr):
    return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(start=start, end=end),
                           thread=1, id=corr)


def _span(name, site, start, end, parent, call):
    s = SimpleNamespace(name=name, site=site, parent=parent, call=call)
    s.start_ns, s.end_ns = BASE_NS + start * 1000, BASE_NS + end * 1000
    return s


def made_up(with_spans=True, device_offset_us=0.0):
    """The made-up slice; device_offset_us moves every device op on the
    trace's clock, as a profiler whose device clock disagrees with its
    host clock would."""
    events = []
    for corr, host, s, e in LAUNCHES:
        events.append(_event("cudaLaunchKernel", DeviceType.CPU, host, host + 3, corr))
        events.append(_event(f"kernel_{corr}", DeviceType.CUDA, s + device_offset_us, e + device_offset_us, corr))
    corr, s, e = UNLAUNCHED
    events.append(_event("Memset (Device)", DeviceType.CUDA, s + device_offset_us, e + device_offset_us, corr))
    # a host event that is no runtime call shares an id and is not a launch
    events.append(_event("aten::mul", DeviceType.CPU, 990, 995, 2))
    prof = SimpleNamespace(events=lambda: events,
                           profiler=SimpleNamespace(kineto_results=SimpleNamespace(trace_start_ns=lambda: BASE_NS)))
    return spans.SpanTrace(prof, UNITS, WINDOW_S, [_span(*s) for s in SPANS] if with_spans else [])


def test_attribution_to_the_innermost_span():
    t = made_up()
    assert [ln.span for ln in t.launches] == [1, 4, 3, 5, 7, 10, 9, 11, None, None]
    assert [ln.host_us for ln in t.launches][-2:] == [950, None]
    # a sibling that closed hands the time to its parent; between calls, none
    assert t.innermost(250) == 3 and t.innermost(545) is None and t.innermost(95) is None
    assert t.label(4) == "unet.conv inc/conv1" and t.label(0) == "serve.call"
    assert t.device_ms_within("serve.front_end") == pytest.approx((50 + 25) / 2 / 1e3)
    assert t.attributed_share() == pytest.approx(385 / 400)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_readers_on_a_made_up_trace(metric):
    ctx = {"config": {}, "traffic": {}, "peaks": None}
    assert harness.load_reader(metric)(made_up(), ctx) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_readers_read_nothing_without_spans(metric):
    """A plain Trace (as the harness takes today), or spans without device
    ops, read nothing."""
    read = harness.load_reader(metric)
    ctx = {"config": {}, "traffic": {}, "peaks": None}
    plain = trace.Trace(SimpleNamespace(events=lambda: [_event("k", DeviceType.CUDA, 0, 10, 1)]), 1, 1e-3)
    assert read(plain, ctx) is None
    assert read(made_up(with_spans=False), ctx) is None


def test_layers_add_up_to_the_calls_device_time():
    t = made_up()
    parts = (t.device_ms_within("serve.front_end") + EXPECTED["unet_conv_ms.batch"]
             + EXPECTED["unet_passes_ms.batch"] + EXPECTED["post_ms.batch"])
    assert parts == pytest.approx(t.device_ms_within(spans.CALL))


@pytest.mark.parametrize("offset_us", [-5000.0, 250.0])
def test_idle_holds_when_the_device_clock_is_off(offset_us):
    """Each idle term lies on one clock, so moving the device's ops on the
    trace's clock changes neither the calls' idle nor the table."""
    ctx = {"config": {}, "traffic": {}, "peaks": None}
    moved = made_up(device_offset_us=offset_us)
    assert harness.load_reader("call_idle_ms.batch")(moved, ctx) == pytest.approx(EXPECTED["call_idle_ms.batch"])
    assert moved.table() == pytest.approx(made_up().table())


def test_table():
    rows = {r["span"]: r for r in made_up().table()}
    assert list(rows) == ["serve.call", "serve.front_end", "serve.unet", "unet.block inc", "unet.conv inc/conv1",
                          "serve.post", "(no span)", "caller"]
    conv = rows["unet.conv inc/conv1"]
    assert (conv["device_ms"], conv["launches"], conv["host_ms"]) == pytest.approx((0.085, 1.0, 0.025))
    assert conv["idle_ms"] == pytest.approx(10 / 2 / 1e3)  # the second call's conv op waited 640-650
    # the front end's launches waited 20 and 15 us from each call's entry;
    # the post's ops 110 and 100 us; each call returned 40 and 20 us after
    # its work ended (call 0's first op started 10 us after its launch)
    assert rows["serve.front_end"]["idle_ms"] == pytest.approx((20 + 15) / 2 / 1e3)
    assert rows["serve.post"]["idle_ms"] == pytest.approx((110 + 100) / 2 / 1e3)
    assert rows["serve.call"]["idle_ms"] == pytest.approx((40 + 20) / 2 / 1e3)
    assert rows["(no span)"]["device_ms"] == pytest.approx(15 / 2 / 1e3)
    assert rows["caller"]["idle_ms"] == pytest.approx((600 - 315) / 2 / 1e3)
    # the rows split the slice: every device us, and every idle us of the window
    assert sum(r["device_ms"] for r in rows.values()) == pytest.approx(400 / 2 / 1e3)
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(600 / 2 / 1e3)


def test_metric_entries():
    """The entries ``BENCHMARK.json``'s ``per_layer`` would take: each name
    once, each found by the harness's reader lookup, each read in the
    two cells it lists."""
    names = [m["name"] for m in spans.METRICS]
    assert sorted(names) == sorted(EXPECTED)
    spec = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spans.METRICS:
        assert set(m["workloads"]) <= cells and m["moves"] == "frames_per_s"
        assert callable(harness.load_reader(m["name"]))
