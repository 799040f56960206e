"""Device time on a CUDA card, from a ``torch.profiler`` trace.

A CUDA event pair around a call also counts the time the host takes to
issue it, while the card waits; for a kernel of a few microseconds that is
most of the number. The trace gives each device op's own start and end, so
``device_ms`` reports the card's busy time alone.
"""

from __future__ import annotations

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
