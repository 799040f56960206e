"""Device ms a call launched inside the U-Net's ``unet.conv`` spans: each
conv launch with its layout transposes, or ``conv2d_int8`` with its fused
epilogue. Nothing from a trace without the program's spans or device ops."""

from benchmark import spans


def read(trace, ctx):
    return spans.reading(trace, "device_ms_within", "unet.conv")
