"""Profiling helpers, the port of ``gelslim_depth_tpu/utils/profiling.py``.

Device time on a CUDA card, from a ``torch.profiler`` trace: a CUDA event
pair around a call also counts the time the host takes to issue it, while
the card waits; for a kernel of a few microseconds that is most of the
number. The trace gives each device op's own start and end, so
``device_ms`` reports the card's busy time alone.

``trace`` records a block into a trace file (``torch.profiler``, where the
JAX package uses ``jax.profiler``), and ``StepTimer`` is a rolling
wall-clock step timer, as the JAX package's.

The JAX package's ``utils/cache.py`` (the XLA compilation cache and the
platform pin) has no counterpart: the port compiles its kernels once per
checkout with ``nvcc`` into ``gelslim_depth_tpu_torch/_build/``
(``ops/kernels/build.py``), which is its cache, and picks its device by
argument.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import List

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


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` capture of the block, with CUDA activity when the
    process has used a card, written on exit as the Chrome trace
    ``log_dir/<host>.<pid>.pt.trace.json`` (Perfetto and TensorBoard's
    profiler plugin read it). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"))


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
