"""Device-idle ms a call inside the serving calls' host intervals (the
``serve.call`` spans); the rest of ``idle_share``'s idle time is the
caller's. Nothing from a trace without the program's spans or device ops."""

from benchmark import spans


def read(trace, ctx):
    return spans.reading(trace, "call_idle_ms")
