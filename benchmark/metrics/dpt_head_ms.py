"""Device ms a call launched inside the program's ``dpt.head`` span: the
DPT head's reassembly, fusion blocks and output convs. Nothing from a
trace without the span or device ops."""

from benchmark import spans


def read(trace, ctx):
    return spans.reading(trace, "device_ms_within", "dpt.head") or None
