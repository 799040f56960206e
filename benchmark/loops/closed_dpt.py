"""The closed serving loop of a dense-prediction transformer configuration
(``"model_type": "dpt"``): ``closed.py``'s window, with the DPT's seeded
weights, the program's ``Predictor`` of the DPT and the judge of the DPT's
plain reference (``benchmark/reference/dpt.py``).

One caller, no think time, calls of ``dual_frames_per_call`` dual frames
through ``predict_dual_frames``, cycling over a seeded pool of ``pool``
inputs on the card; the depth stays on the card and a call ends when the
card has finished it. ``frames_per_s``: the window's dual frames over its
wall time. With ``--trace 1`` the first ``traced_calls`` calls run under
the profiler and the program's span recorder
(``utils.profiling.recording()``), and the readers get a
``spans.SpanTrace``.

The weights (``weights``) make the depth follow the frame: the patch
embedding carries each patch's contrast, and the blocks' LayerScales keep
the residual stream near it, so the frames' own noise and contact move
every token; a run's ``depth_spread_mm`` count, the reference depths'
spread about their mean, is that dependence, against the bfloat16
rounding the comparison allows.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict

import torch

from benchmark import harness, inputs, serving, spans, trace as trace_mod
from benchmark.reference import dpt as ref_dpt


def weights(cfg: dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A served DPT's state dict from the generator, in a few large draws:
    kernels normal at gain / sqrt(fan in) (gain sqrt(2) where a ReLU feeds
    the conv, 0.3 for the last 1x1, 1 elsewhere; a transposed conv whose
    kernel equals its stride meets one tap an input channel); the
    position table and class token normal at 0.02, the mask token 0;
    LayerNorm scales U(0.8, 1.2), LayerScales U(0.05, 0.15), biases and
    LayerNorm shifts U(-0.1, 0.1)."""
    shapes = ref_dpt.state_shapes(cfg)
    tables = ("pretrained.cls_token", "pretrained.pos_embed", "pretrained.mask_token")
    kernels = {k: s for k, s in shapes.items() if len(s) > 1 and k not in tables}
    vectors = {k: s for k, s in shapes.items() if len(s) == 1}
    draws = inputs._split(torch.randn(sum(torch.Size(s).numel() for s in kernels.values()), generator=g,
                                      device=device), kernels)
    sd = {}
    for k, s in kernels.items():
        if ".resize_layers.0." in k or ".resize_layers.1." in k:
            fan_in = s[0]
        else:
            fan_in = torch.Size(s[1:]).numel()
        if k.endswith("output_conv2.2.weight"):
            gain = 0.3
        elif ".resConfUnit" in k or "output_conv2" in k:
            gain = 2.0 ** 0.5
        else:
            gain = 1.0
        sd[k] = draws[k] * (gain / fan_in ** 0.5)
    for k in tables:
        scale = 0.0 if k.endswith("mask_token") else 0.02
        sd[k] = torch.randn(shapes[k], generator=g, device=device) * scale
    u = inputs._split(torch.rand(sum(s[0] for s in vectors.values()), generator=g, device=device), vectors)
    for k, v in u.items():
        if k.endswith(".gamma"):
            sd[k] = v * 0.1 + 0.05
        elif "norm" in k.rsplit(".", 2)[-2] and k.endswith(".weight"):
            sd[k] = v * 0.4 + 0.8
        else:
            sd[k] = v * 0.2 - 0.1
    return sd


def run(cell, seed: int, seconds: float, traced: bool, device, system=None) -> harness.Run:
    """One window. ``system`` (a control) replaces the program,
    ``serving.serving_system``: the configuration's ``Predictor``."""
    # a program without the DPT fails here, before any input is made
    from gelslim_depth_tpu_torch.models import dpt  # noqa: F401
    from gelslim_depth_tpu_torch.utils import profiling

    cfg, tr = cell.config, cell.traffic
    n, pool = tr["dual_frames_per_call"], tr["pool"]
    frame = tuple(cfg["frame_size"])
    marks = [("start", time.perf_counter())]
    frames, base, _ = inputs.session(inputs.generator(device, seed, inputs.FRAMES), n * pool, frame, device)
    pool_inputs = [frames[i * n:(i + 1) * n].clone() for i in range(pool)]
    del frames
    sd = weights(cfg, inputs.generator(device, seed, inputs.WEIGHTS), device)
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
        def reference(fr):
            return ref_dpt.predict(cfg, sd, fr, base)

        def scale(fr):
            return ref_dpt.predict(cfg, sd, fr, base, dtype=torch.bfloat16)

        return serving.compare_depth(kept.items, pool_inputs, reference, device,
                                     scale if cfg["precision"] == "bf16" else None)

    return harness.Run(calls, metrics, harness.phases(marks), t_start, prof_trace, judge)

