"""The closed serving loop: one caller, no think time, serving calls of
``dual_frames_per_call`` dual frames through ``predict_dual_frames``,
cycling over a seeded pool of ``pool`` inputs kept on the card or on the
host (``inputs_on``); the depth stays on the card or is copied back to the
host (``outputs_on``), and a call ends when the depth is where its caller
reads it.

It measures ``frames_per_s``, the dual frames of the window's calls over
the window's wall time, and ``latency_p95_ms``, the 95th percentile of
all the window's calls. Its traffic file's numbers: those above,
``warmup_calls`` (set-up), ``kept_calls`` (the reservoir sample that the
reference judges) and ``traced_calls`` (the profiled slice at the
window's start, with ``--trace 1``).
"""

from __future__ import annotations

import gc
import time
from typing import List

from benchmark import harness, serving, trace as trace_mod


def run(cell, seed: int, seconds: float, traced: bool, device, system=None) -> harness.Run:
    """One window. ``system`` (the control) replaces
    ``serving.serving_system``: it makes a predictor from the same (cell,
    state dict, calibration frames, base, device)."""
    cfg, tr = cell.config, cell.traffic
    n, pool = tr["dual_frames_per_call"], tr["pool"]
    frame = tuple(cfg["frame_size"])
    marks = [("start", time.perf_counter())]
    pool_inputs, base, calib, sd = serving.serving_inputs(cell, seed, device)
    harness.sync(device)
    marks.append(("inputs", time.perf_counter()))
    pred = (system or serving.serving_system)(cell, sd, calib, base, device)
    harness.sync(device)
    marks.append(("program", time.perf_counter()))
    to_host = tr["outputs_on"] == "host"

    def call(i):
        out = pred.predict_dual_frames(pool_inputs[i], base, frame)
        if to_host:
            return out.cpu().numpy()
        harness.sync(device)
        return out

    for i in range(tr["warmup_calls"]):
        call(i % pool)
    harness.sync(device)
    marks.append(("warm-up", time.perf_counter()))
    # what set-up left behind is collected now and frozen, so that no
    # collection inside the window walks it
    gc.collect()
    gc.freeze()

    kept = harness.Reservoir(tr["kept_calls"], seed)
    latencies: List[float] = []
    traced_calls = tr["traced_calls"] if traced else 0
    calls = 0
    t_start = time.perf_counter()
    with trace_mod.profiled(traced) as prof:
        t_slice = time.perf_counter()
        while calls < traced_calls:
            t0 = time.perf_counter()
            out = call(calls % pool)
            latencies.append(time.perf_counter() - t0)
            kept.offer((calls % pool, out))
            calls += 1
        slice_s = time.perf_counter() - t_slice
    while True:
        t0 = time.perf_counter()
        out = call(calls % pool)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        kept.offer((calls % pool, out))
        calls += 1
        if t1 - t_start >= seconds and calls >= tr["kept_calls"]:
            break
    window_s = time.perf_counter() - t_start
    gc.unfreeze()
    del out
    metrics = {"frames_per_s": calls * n / window_s,
               "latency_p95_ms": 1e3 * harness.percentile(latencies, 95)}
    prof_trace = trace_mod.Trace(prof, traced_calls, slice_s) if prof is not None else None

    def judge():
        predict_ref, predict_scale = serving.serving_reference(cell, sd, calib, base)
        return serving.compare_depth(kept.items, pool_inputs, predict_ref, device, predict_scale)

    return harness.Run(calls, metrics, harness.phases(marks), t_start, prof_trace, judge)
