"""Profiling helpers, the port of ``gelslim_depth_tpu/utils/profiling.py``.

Device time on a CUDA card, from a ``torch.profiler`` trace: a CUDA event
pair around a call also counts the time the host takes to issue it, while
the card waits; for a kernel of a few microseconds that is most of the
number. The trace gives each device op's own start and end, so
``device_ms`` reports the card's busy time alone.

``trace`` records a block into a trace file (``torch.profiler``, where the
JAX package uses ``jax.profiler``), and ``StepTimer`` is a rolling
wall-clock step timer, as the JAX package's.

``span`` marks the program's own layers: the serving call, its front end,
U-Net and post, each U-Net block and each conv launch; the transformers'
encoder, blocks, attention and MLP, their heads' and Depth Pro's decoder's
layers, and each conv call of those (``head.conv``: the conv alone, its
epilogue and the passes around it outside). Off, it costs one
call and a ``with``; under ``recording()`` each span keeps its interval on
``time.time_ns()``, the clock of ``torch.profiler``'s events, so a reader
can put the device ops of a trace of the same block into the span whose
host code launched them. ``trace`` records the spans too and writes them
into its file on a track of their own.

The JAX package's ``utils/cache.py`` (the XLA compilation cache and the
platform pin) has no counterpart: the port compiles its kernels once per
checkout with ``nvcc`` into ``gelslim_depth_tpu_torch/_build/``
(``ops/kernels/build.py``), which is its cache, and picks its device by
argument.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import List, Optional

import torch


def device_events(fn, calls: int, sync_each: bool):
    """The device ops of a torch.profiler trace of `calls` calls of fn,
    after three warm-up calls; with sync_each, each call ends in a
    synchronize as a serving loop's does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events) -> float:
    """The union of the device ops' intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


TRACE_ATTEMPTS = 3


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one call: the card's busy time over `calls`
    back-to-back calls, over `calls`. A trace now and then comes back with
    no device events (after many traces in one process, or with many kernel
    libraries loaded); it is taken again, up to TRACE_ATTEMPTS times in all.
    Raises when none holds a device op, so a missing measurement never
    reads as a time."""
    for _ in range(TRACE_ATTEMPTS):
        events = device_events(fn, calls, sync_each=False)
        if events:
            return busy_us(events) / calls / 1e3
    raise RuntimeError(f"{TRACE_ATTEMPTS} profiler traces held no device events: device time not measured")


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

CALL = "serve.call"  # the span of one serving call; every span inside it knows its index


class _Recorder:
    """The spans of one ``recording()``, and the indices of those open
    (spans nest: they are opened and closed by one thread's ``with``s)."""

    __slots__ = ("spans", "open")

    def __init__(self):
        self.spans: List[Span] = []
        self.open: List[int] = []


class Span:
    """One recorded span, its own context manager while the recorder is
    on: ``name`` and ``site`` (None, or where in the layer, such as a U-Net
    block or a conv of one), ``start_ns`` and ``end_ns`` on
    ``time.time_ns()`` (``end_ns`` None while it is open), ``parent``, the
    index of the enclosing span in the recording, and ``call``, the index
    of the enclosing ``serve.call`` (None outside one)."""

    __slots__ = ("name", "site", "start_ns", "end_ns", "parent", "call", "_rec")

    def __init__(self, rec: _Recorder, name: str, site: Optional[str]):
        self._rec, self.name, self.site = rec, name, site
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None
        self.parent: Optional[int] = None
        self.call: Optional[int] = None

    def __enter__(self) -> "Span":
        rec = self._rec
        index = len(rec.spans)
        self.parent = rec.open[-1] if rec.open else None
        self.call = index if self.name == CALL else (None if self.parent is None else rec.spans[self.parent].call)
        rec.spans.append(self)
        rec.open.append(index)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._rec.open.pop()
        return False


_NO_SPAN = contextlib.nullcontext()
_recorder: Optional[_Recorder] = None


def span(name: str, site: Optional[str] = None):
    """A context manager that records the block as a span while
    ``recording()`` is on; off, one shared no-op (no clock read, no
    allocation)."""
    rec = _recorder
    if rec is None:
        return _NO_SPAN
    return Span(rec, name, site)


@contextlib.contextmanager
def recording():
    """Turns the span recorder on for the block and yields the list that
    the block's spans are appended to, in the order they open; a span's
    index in it is what ``parent`` and ``call`` name. Inside another
    ``recording()`` it yields that one's list and leaves the recorder on."""
    global _recorder
    if _recorder is not None:
        yield _recorder.spans
        return
    rec = _recorder = _Recorder()
    try:
        yield rec.spans
    finally:
        _recorder = None


SPAN_TRACK = 1  # the Chrome trace's thread id of the spans' track


def _write_spans(path: str, spans: List[Span]) -> None:
    """Adds the closed spans to the Chrome trace at ``path`` (as
    ``export_chrome_trace`` writes it) as complete events on a track of
    their own in this process, on the file's clock: microseconds from its
    ``baseTimeNanoseconds``."""
    with open(path) as f:
        doc = json.load(f)
    base_ns = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TRACK, "args": {"name": "spans"}})
    for s in spans:
        if s.end_ns is not None:
            events.append({"ph": "X", "cat": "span", "name": s.name if s.site is None else f"{s.name} {s.site}",
                           "pid": pid, "tid": SPAN_TRACK, "ts": (s.start_ns - base_ns) / 1e3,
                           "dur": (s.end_ns - s.start_ns) / 1e3, "args": {"site": s.site}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` capture of the block, with CUDA activity when the
    process has used a card, written on exit as the Chrome trace
    ``log_dir/<host>.<pid>.pt.trace.json`` (Perfetto and TensorBoard's
    profiler plugin read it), with the block's spans on a track of their
    own. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")
    with recording() as spans:
        first = len(spans)
        with profile(activities=activities) as prof:
            yield prof
        block = spans[first:]
    prof.export_chrome_trace(path)
    _write_spans(path, block)


class StepTimer:
    """Rolling wall-clock step timer with summary statistics."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: List[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> dict:
        if not self.times:
            return {"n": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {"n": n, "mean_s": sum(ts) / n, "p50_s": ts[n // 2], "min_s": ts[0], "max_s": ts[-1]}
