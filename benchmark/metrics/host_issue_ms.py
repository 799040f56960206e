"""The mean host ms of a serving call: the program's ``serve.call`` span,
from the call's entry to its return, the host's time to issue the call's
work. Nothing from a trace without the program's spans or device ops."""

from benchmark import spans


def read(trace, ctx):
    return spans.reading(trace, "host_issue_ms")
