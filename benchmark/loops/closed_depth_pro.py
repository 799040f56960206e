"""The closed serving loop of a Depth Pro configuration (``"model_type":
"depth_pro"``): ``closed_dpt.py``'s window over the same seeded session of
dual frames, with Depth Pro's seeded weights and the judge of its plain
reference (``benchmark/reference/depth_pro.py``), which runs a dual frame
at a time beside the program.

One caller, no think time, calls of ``dual_frames_per_call`` dual frames
through ``predict_dual_frames``, cycling over a seeded pool of ``pool``
inputs on the card; the depth stays on the card and a call ends when the
card has finished it. ``frames_per_s``: the window's dual frames over its
wall time. With ``--trace 1`` the first ``traced_calls`` calls run under
the profiler and the program's span recorder, and the readers get a
``spans.SpanTrace``.

The weights (``weights``): both encoders' as the DPT's encoder is drawn
(``closed_dpt.weights``: the patch embedding carries each patch's
contrast, the LayerScales keep the residual stream near it), then the
projection-upsample blocks', the decoder's and the head's by the same
rules, so that the depth follows the frame far beyond the bfloat16
rounding the comparison allows (the run's ``depth_spread_mm`` count).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict

import torch

from benchmark import harness, inputs, serving, spans, trace as trace_mod
from benchmark.loops import closed_dpt
from benchmark.reference import depth_pro as ref_depth_pro

VIT_KEYS = ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "layer_norm_eps")


def _vit_weights(cfg: dict, g: torch.Generator, device, prefix: str) -> Dict[str, torch.Tensor]:
    """An encoder's weights under ``prefix``, drawn as ``closed_dpt.weights``
    draws the DPT's encoder (its head, at the narrowest widths, dropped)."""
    d = cfg["depth_pro"]
    t = ref_depth_pro.tile(cfg)
    vit = {"dpt": {**{k: d[k] for k in VIT_KEYS}, "hooks": [d["depth"] - 1], "features": 2,
                   "out_channels": [1, 1, 1, 1], "head_features": 1},
           "input_tactile_image_size": [t, t]}
    sd = closed_dpt.weights(vit, g, device)
    return {prefix + k[len("pretrained"):]: v for k, v in sd.items() if k.startswith("pretrained.")}


def weights(cfg: dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A served Depth Pro's state dict from the generator: the two
    encoders' (``_vit_weights``), then the rest in two draws: kernels normal
    at gain / sqrt(fan in) (gain sqrt(2) where a ReLU feeds the conv, 0.3
    for the head's last 1x1, 1 elsewhere), biases U(-0.1, 0.1)."""
    sd = {}
    for prefix in ref_depth_pro.ENCODERS:
        sd.update(_vit_weights(cfg, g, device, prefix))
    shapes = {k: s for k, s in ref_depth_pro.state_shapes(cfg).items() if k not in sd}
    kernels = {k: s for k, s in shapes.items() if len(s) > 1}
    vectors = {k: s for k, s in shapes.items() if len(s) == 1}
    draws = inputs._split(torch.randn(sum(torch.Size(s).numel() for s in kernels.values()), generator=g,
                                      device=device), kernels)
    for k, s in kernels.items():
        # past the encoders every 2x2 kernel is a transposed conv k2 s2, which
        # meets one tap an input channel; the convs are 1x1 and 3x3
        fan_in = s[0] if s[2:] == (2, 2) else torch.Size(s[1:]).numel()
        if k == "head.4.weight":
            gain = 0.3
        elif ".resConfUnit" in k:
            gain = 2.0 ** 0.5
        else:
            gain = 1.0
        sd[k] = draws[k] * (gain / fan_in ** 0.5)
    u = inputs._split(torch.rand(sum(s[0] for s in vectors.values()), generator=g, device=device), vectors)
    sd.update({k: v * 0.2 - 0.1 for k, v in u.items()})
    return sd


def call_inputs(cell, seed: int, device):
    """(the pool's calls, the base frame, the weights), from the seed: the
    frames as ``closed_dpt.run`` makes them."""
    cfg, tr = cell.config, cell.traffic
    n, pool = tr["dual_frames_per_call"], tr["pool"]
    frames, base, _ = inputs.session(inputs.generator(device, seed, inputs.FRAMES), n * pool,
                                     tuple(cfg["frame_size"]), device)
    pool_inputs = [frames[i * n:(i + 1) * n].clone() for i in range(pool)]
    del frames
    return pool_inputs, base, weights(cfg, inputs.generator(device, seed, inputs.WEIGHTS), device)


def judge_numbers(cfg: dict, sd, kept, pool_inputs, base, device) -> Dict[str, float]:
    """``serving.compare_depth``'s numbers of the kept calls against the
    reference, a dual frame at a time, in float32 and, for the scale of a
    bf16 configuration, in bfloat16."""
    def reference(fr):
        return ref_depth_pro.predict(cfg, sd, fr, base)

    def scale(fr):
        return ref_depth_pro.predict(cfg, sd, fr, base, dtype=torch.bfloat16)

    return serving.compare_depth(kept, pool_inputs, reference, device, scale if cfg["precision"] == "bf16" else None)


def run(cell, seed: int, seconds: float, traced: bool, device, system=None) -> harness.Run:
    """One window. ``system`` (a control) replaces the program,
    ``serving.serving_system``: the configuration's ``Predictor``."""
    # a program without Depth Pro fails here, before any input is made
    from gelslim_depth_tpu_torch.models import depth_pro  # noqa: F401
    from gelslim_depth_tpu_torch.utils import profiling

    cfg, tr = cell.config, cell.traffic
    n, pool = tr["dual_frames_per_call"], tr["pool"]
    frame = tuple(cfg["frame_size"])
    marks = [("start", time.perf_counter())]
    pool_inputs, base, sd = call_inputs(cell, seed, device)
    harness.sync(device)
    marks.append(("inputs", time.perf_counter()))
    pred = (system or serving.serving_system)(cell, sd, None, base, device)
    harness.sync(device)
    marks.append(("program", time.perf_counter()))

    def call(i):
        out = pred.predict_dual_frames(pool_inputs[i], base, frame)
        harness.sync(device)
        return out

    for i in range(tr["warmup_calls"]):
        call(i % pool)
    marks.append(("warm-up", time.perf_counter()))
    gc.collect()
    gc.freeze()

    kept = harness.Reservoir(tr["kept_calls"], seed)
    traced_calls = tr["traced_calls"] if traced else 0
    calls = 0
    t_start = time.perf_counter()
    record = profiling.recording() if traced else contextlib.nullcontext([])
    with trace_mod.profiled(traced) as prof, record as recorded:
        t_slice = time.perf_counter()
        while calls < traced_calls:
            out = call(calls % pool)
            kept.offer((calls % pool, out))
            calls += 1
        slice_s = time.perf_counter() - t_slice
    while True:
        out = call(calls % pool)
        t1 = time.perf_counter()
        kept.offer((calls % pool, out))
        calls += 1
        if t1 - t_start >= seconds and calls >= tr["kept_calls"]:
            break
    window_s = time.perf_counter() - t_start
    gc.unfreeze()
    del out
    metrics = {"frames_per_s": calls * n / window_s}
    prof_trace = spans.SpanTrace(prof, traced_calls, slice_s, recorded) if prof is not None else None

    def judge():
        return judge_numbers(cfg, sd, kept.items, pool_inputs, base, device)

    return harness.Run(calls, metrics, harness.phases(marks), t_start, prof_trace, judge)
