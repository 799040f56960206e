#!/usr/bin/env python3
"""The readings that the limits of ``benchmark/limits/<workload>.json``
are set from, on the card at the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload int8_batch64 --seeds 11,12,13 \\
        --control-seeds 21,22,23 --faults half_batch,swapped_answer --fault-seeds 31,32,33 --seconds 1

For each of ``--seeds``, one run of the program (``harness.run_cell``: a
short window of the cell's traffic, its seeded sample of outputs compared
as a run compares them); for each of ``--control-seeds``, the same with
the control in the program's place (``control``): for int8 the plain
reference in int4 (the int8 scheme's sites, scales and calibration with 7
steps a side for 127), for bf16 the program's own int8 path; for each of
``--faults`` (``faults.FAULTS``) and each of ``--fault-seeds``, the
program with that fault planted under its serving call. Prints one JSON
line a run, every number compared and every count. The benchmark's own
runs never run this.
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

from benchmark import faults, harness, serving  # noqa: E402
from benchmark.reference import serving as ref_serving  # noqa: E402

INT4_LEVELS = 7


class ReferencePredictor:
    """The serving reference with its own quantization, in the program's
    place."""

    def __init__(self, cfg, sd, quant, device):
        self.cfg, self.sd, self.quant, self.device = cfg, sd, quant, device

    def predict_dual_frames(self, frames, base, out_size):
        return ref_serving.predict(self.cfg, self.sd, torch.as_tensor(frames, device=self.device), base, self.quant)


def control(cell, sd, calib, base, device):
    """The control of a cell, made as ``serving.serving_system`` makes the
    program: for int8, the reference quantized to int4 on the same
    calibration; for bf16, the program's own path one step below, its
    int8 ``QuantizedPredictor`` (the same calibration dual frames)."""
    precision = cell.config["precision"]
    if precision == "int8":
        return ReferencePredictor(cell.config, sd, ref_serving.calibrate(cell.config, sd, calib, base, INT4_LEVELS),
                                  device)
    if precision == "bf16":
        int8 = harness.Cell(**{**cell.__dict__, "config": {**cell.config, "precision": "int8"}})
        return serving.serving_system(int8, sd, calib, base, device)
    raise ValueError(f"no control for precision {precision!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="", help="comma-separated names of faults.FAULTS")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    runs = [(int(s), "program", None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "control", control) for s in args.control_seeds.split(",") if s]
    runs += [(int(s), name, None) for name in args.faults.split(",") if name
             for s in args.fault_seeds.split(",") if s]
    for seed, kind, system in runs:
        t0 = time.perf_counter()
        with faults.planted(kind) if kind in faults.FAULTS else contextlib.nullcontext():
            r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0, system=system)
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, "s": time.perf_counter() - t0,
                          **{k: v["value"] for k, v in r["compared"].items()}, **r["counts"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
