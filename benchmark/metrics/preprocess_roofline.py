"""The front-end kernel ``fused_preprocess_dual``'s share of its byte
bound, in %: the bytes a call's front end must move (its frames, the base
frame, the network input) at the card's bandwidth, over the kernel's
device ms a call. Nothing where the slice launched no such kernel."""

from benchmark import yardstick


def read(trace, ctx):
    ms = trace.layer_ms_per_unit("fused_preprocess_dual")
    if ms is None:
        return None
    cfg = ctx["config"]
    bound = yardstick.preprocess_bound_ms(ctx["traffic"]["dual_frames_per_call"], cfg["frame_size"],
                                          cfg["input_tactile_image_size"], ctx["peaks"])
    return 100.0 * bound / ms
