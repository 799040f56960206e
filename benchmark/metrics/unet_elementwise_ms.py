"""Device ms a serving call in aten's own kernels (``at::native``): the
U-Net's BatchNorm affine, activations, casts, quantize passes, biases,
pads, concats and pools, and the denormalize and resize back. Nothing
where the slice ran none."""


def read(trace, ctx):
    return trace.layer_ms_per_unit("aten")
