"""Device ms a call launched inside ``serve.post``: the depth's
denormalize, its area resize back to the frame and the stack of the two
fingers. Nothing from a trace without the program's spans or device ops."""

from benchmark import spans


def read(trace, ctx):
    return spans.reading(trace, "device_ms_within", "serve.post")
