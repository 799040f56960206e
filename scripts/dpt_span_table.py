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
is not run:

    python3 scripts/dpt_span_table.py --seed 11 --seed 12 --out dpt_spans.json
    python3 scripts/dpt_span_table.py --workload vda_vitl14_clip64 --seed 11 --out vda_spans.json
    python3 scripts/dpt_span_table.py --workload depth_pro_batch8 --seed 11 --out depth_pro_spans.json
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, spans  # noqa: E402


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
        r = harness.load_module("loops", cell.traffic["loop"]).run(cell, seed, args.seconds, True,
                                                                    torch.device("cuda"))
        st = r.trace
        entry = {"seed": seed, "frames_per_s": r.metrics["frames_per_s"],
                 "busy_share": (st.busy_s() or 0.0) / st.window_s,
                 "busy_ms_per_call": (st.busy_s() or 0.0) * 1e3 / st.units,
                 "attributed_share": st.attributed_share(),
                 "metrics": {k: v["value"] for k, v in harness.per_layer_metrics(cell, st, kind, ROOT).items()},
                 "memory_peak_bytes": torch.cuda.max_memory_allocated(),
                 "attention_calls": dict(DPT.attention_calls),
                 "temporal_attention_calls": dict(DPT.temporal_attention_calls),
                 "depth_pro_tiles": DepthPro.tiles - tiles, "table": st.table()}
        runs.append(entry)
        print(json.dumps({k: v for k, v in entry.items() if k != "table"}), file=sys.stderr)
        print(spans.format_table(entry["table"]), file=sys.stderr)
        del r, st
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": kind, "runs": runs}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
