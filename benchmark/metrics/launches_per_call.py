"""Device ops (kernels, copies, sets) a call launched inside ``serve.call``.
Nothing from a trace without the program's spans or device ops."""

from benchmark import spans


def read(trace, ctx):
    return spans.reading(trace, "launches_within", spans.CALL)
