"""Device ms a call launched inside ``serve.unet`` but outside its
``unet.conv`` spans: the U-Net's work between its convs (BatchNorm
affine, activations, casts, quantize passes, bias adds, pads, concats,
pools), whatever kernel runs it. Nothing from a trace without the
program's spans or device ops."""

from benchmark import spans


def read(trace, ctx):
    return spans.reading(trace, "device_ms_within", "serve.unet", "unet.conv")
