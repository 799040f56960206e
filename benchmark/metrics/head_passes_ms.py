"""Device ms a call launched inside the program's ``dpt.head`` span but
outside its ``head.conv`` spans: the DPT head's passes between its convs
(``conv_epilogue``, ``bilinear_resize``, the fusion blocks' outer adds and
the ReLUs before each residual unit), whatever kernel runs them. The
head's convs take ``dpt_head_ms`` less this. Nothing from a trace without
those spans or device ops."""

from benchmark import spans


def read(trace, ctx):
    if not spans.reading(trace, "device_ms_within", "head.conv"):
        return None
    return spans.reading(trace, "device_ms_within", "dpt.head", "head.conv")
