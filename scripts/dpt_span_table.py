#!/usr/bin/env python3
"""Where a transformer cell's device time goes, by the program's spans:
the cell's loop (``benchmark/loops/closed_dpt.py``, ``closed_vda.py`` for
the video cell, ``closed_depth_pro.py`` for Depth Pro's) run traced for
each seed, its slice's ``spans.SpanTrace`` printed as
``benchmark/spans.py`` prints a U-Net cell's (device ms, launches, host
ms and held idle ms a call, a row a span label: the video cell's temporal
modules and their attention and feed-forward spans by site, Depth Pro's
pyramid, encoders, merge, upsample blocks, fusion levels by site and
head), with the per-layer metrics, the device's busy share, the SDPA
calls by backend, the encoder's and the temporal modules', and Depth
Pro's encoder sequences (``DepthPro.tiles``); the correctness comparison
is not run.

Then the heads' convs (``models/dpt.py::_head_conv``): a row a
``head.conv`` site (device ms and launches a call; for Depth Pro the op
model's bound of the conv, ``yardstick_depth_pro.decoder_ops``, and the
share of it), and each layer of the head or decoder (``dpt.reassemble``,
each ``dpt.fusion``, ``dpt.output``; ``depth_pro.upsample``, each
``depth_pro.fusion``, ``depth_pro.head``) split into the device ms of its
convs and of its passes (everything else it launched, the temporal
modules' spans left to their own rows). Last, the recorder's cost: a
span's host us off and on (``SPAN_ITERATIONS`` empty spans a side)
times the spans a call opens, and the window's program served
``COST_CALLS`` calls at a time with the recorder off, on, on, off,
untraced, each side's host ms from a call's entry to its return (mean)
and its dual frames a second:

    python3 scripts/dpt_span_table.py --seed 11 --seed 12 --out dpt_spans.json
    python3 scripts/dpt_span_table.py --workload vda_vitl14_clip64 --seed 11 --out vda_spans.json
    python3 scripts/dpt_span_table.py --workload depth_pro_batch8 --seed 11 --out depth_pro_spans.json
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, serving, spans, yardstick, yardstick_depth_pro  # noqa: E402
from benchmark.yardstick_dpt import op_ms  # noqa: E402

CONV = "head.conv"
COST_CALLS = 20  # calls a side of the recorder's cost, off, on, on, off
SPAN_ITERATIONS = 200_000  # empty spans a side of a span's host cost
# the layers of a head or decoder; a launch goes to the innermost one open
LAYERS = ("dpt.head", "dpt.reassemble", "dpt.fusion", "dpt.output", "depth_pro.upsample", "depth_pro.fusion",
          "depth_pro.head")


class Captured:
    """The cell's program (``serving.serving_system``), keeping itself and
    the arguments of its latest call for the recorder's cost."""

    def __init__(self):
        self.pred, self.args = None, None

    def system(self, cell, sd, calib, base, device):
        self.pred = serving.serving_system(cell, sd, calib, base, device)
        return self

    def predict_dual_frames(self, *args):
        self.args = args
        return self.pred.predict_dual_frames(*args)


def conv_rows(st: spans.SpanTrace, cell, kind: str) -> list:
    """A row a ``head.conv`` label: device ms and launches a call, and for
    Depth Pro the op model's bound of the conv (ms a call) and its share."""
    rows = {}
    for ln in st.launches:
        if ln.span is not None and st.within(ln.span, CONV):
            row = rows.setdefault(st.label(ln.span), {"site": st.label(ln.span), "device_ms": 0.0, "launches": 0.0})
            row["device_ms"] += (ln.op.end_us - ln.op.start_us) / 1e3 / st.units
            row["launches"] += 1 / st.units
    if cell.config.get("model_type") == "depth_pro":
        peaks = yardstick.card_peaks(kind)
        images = 2 * cell.traffic["dual_frames_per_call"]
        bounds = {op.name: op_ms(op, peaks) for op in yardstick_depth_pro.decoder_ops(cell.config, images)}
        for row in rows.values():
            bound = bounds.get(row["site"][len(CONV) + 1:].replace("/", "."))
            row["bound_ms"] = bound
            row["roofline"] = None if bound is None else 100.0 * bound / row["device_ms"]
    return list(rows.values())


def layer_split(st: spans.SpanTrace) -> list:
    """Each head or decoder layer's label, with the device ms and launches
    a call of its ``head.conv`` spans and of the rest it launched (the
    temporal modules' spans left out; ``dpt.head``'s row its own launches),
    and their total."""
    rows = {}
    for ln in st.launches:
        i = ln.span
        if i is None or st.within(i, "dpt.temporal"):
            continue
        conv = st.within(i, CONV)
        while i is not None and st.spans[i].name not in LAYERS:
            i = st.spans[i].parent
        if i is None:
            continue
        label = st.label(i)
        row = rows.setdefault(label, {"layer": label, "conv_ms": 0.0, "passes_ms": 0.0, "conv_launches": 0.0,
                                      "pass_launches": 0.0})
        ms, launches = ("conv_ms", "conv_launches") if conv else ("passes_ms", "pass_launches")
        row[ms] += (ln.op.end_us - ln.op.start_us) / 1e3 / st.units
        row[launches] += 1 / st.units
    total = {"layer": "total"}
    for k in ("conv_ms", "passes_ms", "conv_launches", "pass_launches"):
        total[k] = sum(r[k] for r in rows.values())
    return list(rows.values()) + [total]


def recorder_cost(captured: Captured, calls: int) -> list:
    """The captured program on its latest call's arguments, ``calls`` calls
    a side with the recorder off, on, on, off, untraced: each side's mean
    host ms from a call's entry to its return, and its dual frames a
    second over the side's wall time (a synchronize after each call)."""
    from gelslim_depth_tpu_torch.utils import profiling

    pred, args = captured.pred, captured.args
    n = args[0].shape[0]
    out = []
    for side in ("off", "on", "on", "off"):
        host_s = 0.0
        with profiling.recording() if side == "on" else contextlib.nullcontext():
            t_start = time.perf_counter()
            for _ in range(calls):
                t0 = time.perf_counter()
                pred.predict_dual_frames(*args)
                host_s += time.perf_counter() - t0
                torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        out.append({"recorder": side, "host_ms": 1e3 * host_s / calls, "frames_per_s": calls * n / wall})
    return out


def span_cost_us(iterations: int) -> dict:
    """The host us of one empty ``span("head.conv", site)`` block with the
    recorder off and on, ``iterations`` a side."""
    from gelslim_depth_tpu_torch.utils import profiling

    out = {}
    for side in ("off", "on"):
        with profiling.recording() if side == "on" else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(iterations):
                with profiling.span(CONV, "site"):
                    pass
            out[side] = 1e6 * (time.perf_counter() - t0) / iterations
    return out


def _print_rows(rows: list, keys: list) -> None:
    first = keys[0]
    print(f"{first:<40} " + " ".join(f"{k:>13}" for k in keys[1:]), file=sys.stderr)
    for r in rows:
        cells = [f"{r[k]:>13.4f}" if isinstance(r.get(k), float) else f"{str(r.get(k)):>13}" for k in keys[1:]]
        print(f"{r[first]:<40} " + " ".join(cells), file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="dpt_vitl14_batch64")
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", help="also write the results, one JSON object, here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("dpt_span_table: no CUDA card", file=sys.stderr)
        return 2
    from gelslim_depth_tpu_torch.models.depth_pro import DepthPro
    from gelslim_depth_tpu_torch.models.dpt import DPT

    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    cell = harness.find_cell(args.workload)
    kind = torch.cuda.get_device_name(0)
    runs = []
    for seed in args.seed:
        tiles = DepthPro.tiles
        captured = Captured()
        r = harness.load_module("loops", cell.traffic["loop"]).run(cell, seed, args.seconds, True,
                                                                    torch.device("cuda"), system=captured.system)
        st = r.trace
        entry = {"seed": seed, "frames_per_s": r.metrics["frames_per_s"],
                 "busy_share": (st.busy_s() or 0.0) / st.window_s,
                 "busy_ms_per_call": (st.busy_s() or 0.0) * 1e3 / st.units,
                 "attributed_share": st.attributed_share(),
                 "metrics": {k: v["value"] for k, v in harness.per_layer_metrics(cell, st, kind, ROOT).items()},
                 "memory_peak_bytes": torch.cuda.max_memory_allocated(),
                 "attention_calls": dict(DPT.attention_calls),
                 "temporal_attention_calls": dict(DPT.temporal_attention_calls),
                 "depth_pro_tiles": DepthPro.tiles - tiles, "table": st.table(),
                 "convs": conv_rows(st, cell, kind), "layers": layer_split(st)}
        per_span = span_cost_us(SPAN_ITERATIONS)
        spans_a_call = len(st.spans) / st.units
        entry["recorder_cost"] = {
            "span_us": per_span, "spans_a_call": spans_a_call,
            "head_conv_spans_a_call": sum(s.name == CONV for s in st.spans) / st.units,
            "host_us_a_call": {side: us * spans_a_call for side, us in per_span.items()},
            "windows": recorder_cost(captured, COST_CALLS)}
        runs.append(entry)
        print(json.dumps({k: v for k, v in entry.items() if k not in ("table", "convs", "layers")}), file=sys.stderr)
        print(spans.format_table(entry["table"]), file=sys.stderr)
        _print_rows(entry["convs"], ["site", "device_ms", "launches", "bound_ms", "roofline"])
        _print_rows(entry["layers"], ["layer", "conv_ms", "passes_ms", "conv_launches", "pass_launches"])
        del r, st, captured
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": kind, "runs": runs}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
