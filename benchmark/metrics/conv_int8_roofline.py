"""The int8 conv kernel ``conv2d_int8``'s share of its roofline, in %: the
quantized sites' summed bound (each the larger of its int8 operations at
the int8 peak and its bytes at the bandwidth, ``yardstick.int8_sites``)
over the summed device ms of every ``conv2d_int8`` launch a call. Nothing
where the slice launched none."""

from benchmark import yardstick


def read(trace, ctx):
    ms = trace.layer_ms_per_unit("conv2d_int8")
    if ms is None:
        return None
    cfg = ctx["config"]
    images = 2 * ctx["traffic"]["dual_frames_per_call"]
    return 100.0 * yardstick.conv_int8_bound_ms(cfg, images, tuple(cfg["input_tactile_image_size"]), ctx["peaks"]) / ms
