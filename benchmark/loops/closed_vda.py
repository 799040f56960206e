"""The closed serving loop of a video depth configuration (a DPT with the
temporal head, ``"num_frames"`` > 0): ``closed_dpt.py``'s window over
consecutive frames of one recorded session, with the temporal modules'
seeded weights and the judge of Video Depth Anything's plain reference
(``benchmark/reference/vda.py``), run a clip at a time.

One caller, no think time, calls of ``dual_frames_per_call`` consecutive
dual frames through ``predict_dual_frames`` (each finger's frames of a
call are its clips of ``num_frames``), cycling over a pool of ``pool``
calls that are one session's consecutive frames, on the card; the depth
stays on the card and a call ends when the card has finished it.
``frames_per_s``: the window's dual frames over its wall time. With
``--trace 1`` the first ``traced_calls`` calls run under the profiler and
the program's span recorder, and the readers get a ``spans.SpanTrace``.

The frames (``clip_session``) are ``inputs.session``'s arithmetic with
contacts that move through each clip: in every clip of ``num_frames``
frames and finger, each contact presses in and slides, its centre
drifting along a line and its depth ramping up.

The judge gives ``serving.compare_depth``'s numbers: the reference's
depth of a pool call is computed whole, each finger's clips a clip at a
time, and ``compare_depth`` looks its blocks up by the dual frames'
places in the call.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Tuple

import torch

from benchmark import harness, inputs, serving, spans, trace as trace_mod
from benchmark.loops import closed_dpt
from benchmark.reference import vda as ref_vda

DRIFT = 0.15  # the largest move of a contact's centre in a clip, a share of the frame a side
PRESS_FROM = 0.1  # a contact's depth at a clip's first frame, a share of its peak


def clip_session(g: torch.Generator, n: int, clip: int, frame: Tuple[int, int],
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """n consecutive dual frames of one sensor, in clips of ``clip``
    frames: ((n, 6, H, W) frames, the (6, H, W) base frame). The base and
    the response as ``inputs.session``'s; in each clip and finger,
    ``inputs.BLOBS`` contacts, each with its widths U(8, 30) px, a start
    centre U(0.2, 0.8) of the frame that moves by U(-DRIFT, DRIFT) of the
    frame a side over the clip, and a depth that ramps from PRESS_FROM x
    to 1 x its peak U(0.3, 1) x 1.9 mm; noise N(0, 2) a frame."""
    h, w = frame
    base = inputs._uniform(g, (6, 1, 1), 80.0, 170.0, device) + inputs._uniform(g, (6, h, w), -8.0, 8.0, device)
    n_clips = -(-n // clip)
    p = torch.rand((n_clips, 2, inputs.BLOBS, 7), generator=g, device=device)
    # each frame's place in its clip, 0 at the first frame and 1 at a whole clip's last
    tau = (torch.arange(n, device=device) % clip).float() / max(clip - 1, 1)
    at = p[torch.arange(n, device=device) // clip]  # (n, 2, BLOBS, 7)
    tau = tau.view(n, 1, 1)
    cy = (at[..., 0] * 0.6 + 0.2 + (at[..., 5] * 2 - 1) * DRIFT * tau) * h
    cx = (at[..., 1] * 0.6 + 0.2 + (at[..., 6] * 2 - 1) * DRIFT * tau) * w
    sy, sx = at[..., 2] * 22.0 + 8.0, at[..., 3] * 22.0 + 8.0
    amp = (at[..., 4] * 0.7 + 0.3) * inputs.MAX_DEPTH_MM * (PRESS_FROM + (1 - PRESS_FROM) * tau)
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, 1, 1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, 1, 1, w)
    frames = torch.empty((n, 6, h, w), device=device)
    resp = torch.tensor(inputs.RESPONSE, device=device).view(1, 1, 3, 1, 1)
    for s in range(0, n, inputs.FRAME_CHUNK):
        e = min(n, s + inputs.FRAME_CHUNK)

        def v(t):
            return t[s:e, :, :, None, None]

        blobs = v(amp) * torch.exp(-(((yy - v(cy)) / v(sy)) ** 2 + ((xx - v(cx)) / v(sx)) ** 2))
        d = torch.clamp(-blobs.sum(dim=2), min=-inputs.MAX_DEPTH_MM)
        t = base.view(1, 2, 3, h, w) + resp * (-d).unsqueeze(2)
        t = t + torch.randn(t.shape, generator=g, device=device) * 2.0
        frames[s:e] = torch.clamp(t, 0.0, 255.0).reshape(e - s, 6, h, w)
    return frames, base


def weights(cfg: dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A served video depth model's state dict from the generator: the
    DPT's (``closed_dpt.weights``), then the temporal modules': kernels
    normal at 1 / sqrt(fan in), GroupNorm and LayerNorm scales U(0.8,
    1.2), biases and shifts U(-0.1, 0.1), each ``pos_encoder.pe`` the
    sinusoidal table (``reference/vda.py::sinusoid_table``)."""
    sd = closed_dpt.weights(cfg, g, device)
    shapes = ref_vda.temporal_shapes(cfg)
    kernels = {k: s for k, s in shapes.items() if len(s) == 2}
    vectors = {k: s for k, s in shapes.items() if len(s) == 1}
    draws = inputs._split(torch.randn(sum(torch.Size(s).numel() for s in kernels.values()), generator=g,
                                      device=device), kernels)
    for k, s in kernels.items():
        sd[k] = draws[k] / s[1] ** 0.5
    u = inputs._split(torch.rand(sum(s[0] for s in vectors.values()), generator=g, device=device), vectors)
    for k, v in u.items():
        scale = k.endswith(".weight") and (k.rsplit(".", 2)[-2] in ("norm", "ff_norm") or ".norms." in k)
        sd[k] = v * 0.4 + 0.8 if scale else v * 0.2 - 0.1
    for k, s in shapes.items():
        if k.endswith(".pe"):
            sd[k] = ref_vda.sinusoid_table(s[1], s[2]).to(device).unsqueeze(0)
    return sd


def call_inputs(cell, seed: int, device) -> Tuple[List[torch.Tensor], torch.Tensor, Dict[str, torch.Tensor]]:
    """(the pool's calls, each ``dual_frames_per_call`` consecutive dual
    frames of one session, the base frame, the weights), from the seed."""
    cfg, tr = cell.config, cell.traffic
    n, pool = tr["dual_frames_per_call"], tr["pool"]
    frames, base = clip_session(inputs.generator(device, seed, inputs.FRAMES), n * pool, cfg["dpt"]["num_frames"],
                                tuple(cfg["frame_size"]), device)
    pool_inputs = [frames[i * n:(i + 1) * n].clone() for i in range(pool)]
    del frames
    return pool_inputs, base, weights(cfg, inputs.generator(device, seed, inputs.WEIGHTS), device)


class _ByPlace:
    """A predict over a call's dual frames whose answers are computed once
    per pool call, whole, and looked up by the dual frames' places: what
    ``compare_depth`` hands it are the places (``places``)."""

    def __init__(self, pool_inputs, predict):
        self.pool_inputs, self.predict, self.done = pool_inputs, predict, {}

    def places(self, idx: int) -> torch.Tensor:
        n = self.pool_inputs[idx].shape[0]
        return torch.arange(idx * n, (idx + 1) * n)

    def __call__(self, places: torch.Tensor) -> torch.Tensor:
        n = self.pool_inputs[0].shape[0]
        idx = int(places[0]) // n
        if idx not in self.done:
            self.done[idx] = self.predict(self.pool_inputs[idx])
        return self.done[idx][places - idx * n]


def judge_numbers(cfg: dict, sd, kept, pool_inputs, base, device) -> Dict[str, float]:
    """``serving.compare_depth``'s numbers of the kept calls, the reference
    run a clip at a time, in float32 and, for the scale of a bf16
    configuration, in bfloat16."""
    ref = _ByPlace(pool_inputs, lambda fr: ref_vda.predict(cfg, sd, fr, base))
    scale = _ByPlace(pool_inputs, lambda fr: ref_vda.predict(cfg, sd, fr, base, dtype=torch.bfloat16))
    places = [ref.places(i) for i in range(len(pool_inputs))]
    return serving.compare_depth(kept, places, ref, device, scale if cfg["precision"] == "bf16" else None)


def run(cell, seed: int, seconds: float, traced: bool, device, system=None) -> harness.Run:
    """One window. ``system`` (a control) replaces the program,
    ``serving.serving_system``: the configuration's ``Predictor``."""
    # a program without the temporal head fails here, before any input is made
    from gelslim_depth_tpu_torch.models.dpt import TemporalModule  # noqa: F401
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
