#!/usr/bin/env python3
"""The program's spans read against the device trace of the same slice.

``gelslim_depth_tpu_torch.utils.profiling.recording()`` keeps each span
of the program (``serve.call``, ``serve.front_end``, ``serve.unet``,
``serve.post``, ``unet.block``, ``unet.conv``) on ``time.time_ns()``,
the clock of ``torch.profiler``'s events: a span maps to the trace's
microseconds as ``(ns - trace_start_ns) / 1e3``. A device op (kernel,
copy, set) belongs to the innermost span open at the start of the host's
CUDA runtime or driver call that launched it, the two matched by their
correlation id. So a span's device time is the work its own code
launched, whatever kernel implements it. The device idle time a call
holds is counted on one clock at a time (``SpanTrace.waits``): the
profiler's device timestamps can sit milliseconds off its host ones.

``SpanTrace`` is a ``trace.Trace`` that also holds the spans; the readers
``benchmark/metrics/{host_issue_ms,call_idle_ms,launches_per_call,
unet_conv_ms,unet_passes_ms,post_ms}.py`` read it, and read nothing from
a ``Trace`` taken without the spans. ``METRICS`` are their entries as
``BENCHMARK.json``'s ``per_layer`` would hold them.

Run as a script, it serves a cell's traffic as ``loops/closed.py`` does,
and takes traced slices with the recorder off and on, in turns, and
untraced windows the same way; it prints each slice's per-layer metrics,
the per-span table of the slices with the recorder on, and the
recorder's cost:

    python3 benchmark/spans.py --workload int8_batch64 --seed 7 --seed 8 --out spans_int8.json
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import trace as trace_mod  # noqa: E402

CALL = "serve.call"

_CELLS = ["int8_batch64", "bf16_batch64"]
METRICS = [
    {"name": name, "unit": unit, "better": "lower", "source": "device_trace", "layer": layer,
     "moves": "frames_per_s", "workloads": _CELLS}
    for name, unit, layer in (
        ("host_issue_ms.batch", "ms", "whole call"),
        ("call_idle_ms.batch", "ms", "device"),
        ("launches_per_call.batch", "launches", "whole call"),
        ("unet_conv_ms.batch", "ms", "U-Net"),
        ("unet_passes_ms.batch", "ms", "U-Net"),
        ("post_ms.batch", "ms", "post"),
    )
]


class SpanUs(NamedTuple):
    """A recorded span on the trace's clock, in microseconds."""

    name: str
    site: Optional[str]
    start_us: float
    end_us: float
    parent: Optional[int]
    call: Optional[int]


class Launch(NamedTuple):
    """A device op, the start of the runtime call that launched it (None
    where no runtime call of the trace has its correlation id), and the
    innermost span open then (None outside every span)."""

    op: trace_mod.Op
    host_us: Optional[float]
    span: Optional[int]


class SpanTrace(trace_mod.Trace):
    """A traced slice of ``units`` calls in ``window_s`` seconds, with the
    spans that ``profiling.recording()`` kept over it."""

    def __init__(self, prof, units: int, window_s: float, spans):
        from torch.autograd import DeviceType

        super().__init__(prof, units, window_s)
        base_ns = prof.profiler.kineto_results.trace_start_ns()
        self.spans: List[SpanUs] = [
            SpanUs(s.name, s.site, (s.start_ns - base_ns) / 1e3,
                   float("inf") if s.end_ns is None else (s.end_ns - base_ns) / 1e3, s.parent, s.call)
            for s in spans]
        self._starts = [s.start_us for s in self.spans]
        launched_at: Dict[int, float] = {}
        device: List[Tuple[int, trace_mod.Op]] = []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                device.append((e.id, trace_mod.Op(e.name, e.time_range.start, e.time_range.end, e.thread)))
            elif e.device_type == DeviceType.CPU and e.name.startswith("cu"):
                launched_at[e.id] = e.time_range.start
        self.launches: List[Launch] = []
        for corr, op in sorted(device, key=lambda d: d[1].start_us):
            host = launched_at.get(corr)
            self.launches.append(Launch(op, host, None if host is None else self.innermost(host)))

    # ---- spans ---------------------------------------------------------
    def innermost(self, t_us: float) -> Optional[int]:
        """The innermost span open at t_us: the last to start by then, or
        the nearest of its ancestors still open (spans nest)."""
        i = bisect.bisect_right(self._starts, t_us) - 1
        while i is not None and i >= 0 and self.spans[i].end_us < t_us:
            i = self.spans[i].parent
        return None if i is None or i < 0 else i

    def within(self, i: Optional[int], name: str) -> bool:
        """Whether span i or one of its ancestors is named ``name``."""
        while i is not None:
            if self.spans[i].name == name:
                return True
            i = self.spans[i].parent
        return False

    def label(self, i: int) -> str:
        """A span's name and its site, after its ancestors' sites
        (``unet.conv down_1/conv2``)."""
        sites, j = [], i
        while j is not None:
            if self.spans[j].site is not None:
                sites.append(self.spans[j].site)
            j = self.spans[j].parent
        return " ".join([self.spans[i].name] + (["/".join(reversed(sites))] if sites else []))

    def calls(self) -> List[int]:
        return [i for i, s in enumerate(self.spans) if s.name == CALL]

    def readable(self) -> bool:
        """Device ops and serving calls to read."""
        return self.has_device_ops() and bool(self.calls())

    # ---- device time by span -----------------------------------------
    def device_ms_within(self, name: str, outside: Optional[str] = None) -> float:
        """Device ms a call in the ops launched inside a span named
        ``name`` (and, with ``outside``, not inside one named so)."""
        us = sum(ln.op.end_us - ln.op.start_us for ln in self.launches
                 if self.within(ln.span, name) and not (outside and self.within(ln.span, outside)))
        return us / 1e3 / self.units

    def launches_within(self, name: str) -> float:
        return sum(self.within(ln.span, name) for ln in self.launches) / self.units

    def attributed_share(self) -> float:
        """The share of the slice's device ms launched inside a serving call."""
        total = sum(ln.op.end_us - ln.op.start_us for ln in self.launches)
        return self.device_ms_within(CALL) * 1e3 * self.units / total

    # ---- host and idle time ------------------------------------------
    def host_issue_ms(self) -> float:
        """The mean host ms from a serving call's entry to its return."""
        calls = self.calls()
        return sum(self.spans[i].end_us - self.spans[i].start_us for i in calls) / 1e3 / len(calls)

    def waits(self) -> List[Tuple[int, float]]:
        """The device's idle time that each serving call holds, as (span,
        us) pairs: from the call's entry to its first launch, given to the
        span that launched it; before each later op of the call that the
        device waited for, given to the span that launched that op; and,
        where the call returned after its last op ended, from that end to
        the return, given to the call. Each term is a difference on one
        clock (the host's, the device's, or the call's host time after its
        first launch less its device time after its first op started), so
        an offset between the profiler's device and host clocks cancels;
        the first launch's own latency, tens of microseconds, is left to
        the caller."""
        ops: Dict[int, List[Launch]] = {}
        for ln in self.launches:  # in device order
            call = None if ln.span is None else self.spans[ln.span].call
            if call is not None:
                ops.setdefault(call, []).append(ln)
        out = []
        for call, lns in ops.items():
            first = lns[0]
            out.append((first.span, max(0.0, first.host_us - self.spans[call].start_us)))
            end = first.op.end_us
            for ln in lns[1:]:
                if ln.op.start_us > end:
                    out.append((ln.span, ln.op.start_us - end))
                end = max(end, ln.op.end_us)
            after_first = self.spans[call].end_us - first.host_us
            out.append((call, max(0.0, after_first - (end - first.op.start_us))))
        return out

    def call_idle_ms(self) -> float:
        """Device-idle ms a call that the serving calls hold (``waits``)."""
        return sum(us for _, us in self.waits()) / 1e3 / self.units

    # ---- the table -----------------------------------------------------
    def table(self) -> List[dict]:
        """A row a span label, in the order they first open: device ms,
        launches and host ms a call, and the device-idle ms a call that
        the span holds (``waits``); then ``(no span)`` for the device ops
        launched outside every span or by no runtime call of the trace,
        and ``caller`` for the idle time no serving call holds."""
        labels = [self.label(i) for i in range(len(self.spans))]
        rows: Dict[str, dict] = {}
        for i, s in enumerate(self.spans):
            row = rows.setdefault(labels[i], {"span": labels[i], "device_ms": 0.0, "launches": 0.0, "host_ms": 0.0,
                                              "idle_ms": 0.0})
            row["host_ms"] += (s.end_us - s.start_us) / 1e3 / self.units
        for i, us in self.waits():
            rows[labels[i]]["idle_ms"] += us / 1e3 / self.units
        none = {"span": "(no span)", "device_ms": 0.0, "launches": 0.0, "host_ms": 0.0, "idle_ms": 0.0}
        for ln in self.launches:
            row = none if ln.span is None else rows[labels[ln.span]]
            row["device_ms"] += (ln.op.end_us - ln.op.start_us) / 1e3 / self.units
            row["launches"] += 1 / self.units
        busy_ms = (self.busy_s() or 0.0) * 1e3
        caller = (self.window_s * 1e3 - busy_ms) / self.units - self.call_idle_ms()
        return list(rows.values()) + [none, {"span": "caller", "device_ms": 0.0, "launches": 0.0,
                                             "host_ms": 0.0, "idle_ms": caller}]


def reading(trace, method: str, *args) -> Optional[float]:
    """``trace.<method>(*args)``, or None from a trace without spans or
    with nothing to read."""
    if not isinstance(trace, SpanTrace) or not trace.readable():
        return None
    return getattr(trace, method)(*args)


def format_table(rows: List[dict]) -> str:
    lines = [f"{'span':<28} {'device ms':>10} {'launches':>9} {'host ms':>9} {'idle ms':>9}"]
    for r in rows:
        lines.append(f"{r['span']:<28} {r['device_ms']:>10.4f} {r['launches']:>9.2f} {r['host_ms']:>9.4f} "
                     f"{r['idle_ms']:>9.4f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the script: the recorder's readings and cost on a cell
# ---------------------------------------------------------------------------

def _serve_slices(cell, seed: int, calls: int, untraced: int, device) -> dict:
    """One program from the seed, warmed up as the closed loop warms it;
    then traced slices of ``calls`` calls and untraced windows of
    ``untraced`` calls, each with the recorder off, on, on, off."""
    import contextlib
    import gc
    import time

    import torch

    from benchmark import harness, serving
    from gelslim_depth_tpu_torch.utils import profiling

    tr = cell.traffic
    n, pool, frame = tr["dual_frames_per_call"], tr["pool"], tuple(cell.config["frame_size"])
    pool_inputs, base, calib, sd = serving.serving_inputs(cell, seed, device)
    pred = serving.serving_system(cell, sd, calib, base, device)
    for i in range(tr["warmup_calls"]):
        pred.predict_dual_frames(pool_inputs[i % pool], base, frame)
    harness.sync(device)
    gc.collect()
    gc.freeze()
    read_cell = dataclasses.replace(cell, per_layer=cell.per_layer + METRICS)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = {"seed": seed, "traced": [], "untraced": []}

    def window(k):
        """k calls; the mean host ms of the program's return, and the wall s."""
        issue = 0.0
        t_start = time.perf_counter()
        for c in range(k):
            t0 = time.perf_counter()
            pred.predict_dual_frames(pool_inputs[c % pool], base, frame)
            issue += time.perf_counter() - t0
            harness.sync(device)
        return 1e3 * issue / k, time.perf_counter() - t_start

    for side in ("off", "on", "on", "off"):
        rec = profiling.recording() if side == "on" else contextlib.nullcontext([])
        with rec as spans, trace_mod.profiled(True) as prof:
            issue_ms, slice_s = window(calls)
        st = SpanTrace(prof, calls, slice_s, spans)
        metrics = {k: v["value"] for k, v in harness.per_layer_metrics(read_cell, st, kind, harness.ROOT).items()}
        entry = {"recorder": side, "issue_ms": issue_ms, "metrics": metrics,
                 "busy_ms_per_call": (st.busy_s() or 0.0) * 1e3 / calls}
        if side == "on" and st.readable():
            entry["front_end_ms"] = st.device_ms_within("serve.front_end")
            entry["attributed_share"] = st.attributed_share()
            entry["uncorrelated_ops"] = sum(ln.host_us is None for ln in st.launches)
            # each call's first launch finds the device idle, so the device
            # starts it a launch's latency after its runtime call: the least,
            # median and most of those lags show how far the profiler's
            # device clock sits from its host clock (``waits`` needs neither)
            first = {}
            for ln in st.launches:  # in device order
                if ln.span is not None and st.spans[ln.span].call is not None:
                    first.setdefault(st.spans[ln.span].call, ln)
            lags = sorted(ln.op.start_us - ln.host_us for ln in first.values())
            entry["first_launch_lag_us"] = [lags[0], lags[len(lags) // 2], lags[-1]]
            entry["table"] = st.table()
        out["traced"].append(entry)
    for side in ("off", "on", "on", "off"):
        with profiling.recording() if side == "on" else contextlib.nullcontext():
            issue_ms, wall_s = window(untraced)
        out["untraced"].append({"recorder": side, "issue_ms": issue_ms, "frames_per_s": untraced * n / wall_s})
    gc.unfreeze()
    return out


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--calls", type=int, default=20, help="calls a traced slice")
    p.add_argument("--untraced", type=int, default=100, help="calls an untraced window")
    p.add_argument("--out", help="also write the results, one JSON object, here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: no CUDA card; no result", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    cell = harness.find_cell(args.workload)
    runs = []
    for seed in args.seed:
        r = _serve_slices(cell, seed, args.calls, args.untraced, torch.device("cuda"))
        runs.append(r)
        for t in r["traced"]:
            print(json.dumps({k: v for k, v in t.items() if k != "table"}), file=sys.stderr)
            if "table" in t:
                print(format_table(t["table"]), file=sys.stderr)
        print(json.dumps(r["untraced"]), file=sys.stderr)
        torch.cuda.empty_cache()
    result = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    from benchmark import spans  # the readers' module, whose SpanTrace they know

    sys.exit(spans.main())
