#!/usr/bin/env python3
"""The control that the transformer cell's limits are set against: the DPT
one precision step below bfloat16, its encoder's matrix products fed
float8_e4m3fn inputs (``reference/dpt.py``'s bfloat16 model with
``gemm_inputs=fp8_rounding``: activations and weights rounded through
float8 at a per-tensor scale), served in the program's place
(``harness.run_cell(..., system=control)``) on the card, at the cell's own
size; one JSON line a seed with every number compared and every count,
as ``benchmark/calibrate.py`` prints them for the program and the faults:

    python3 scripts/dpt_fp8_control.py --workload dpt_vitl14_batch64 --seeds 21,22,23 --seconds 1
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import dpt as ref_dpt  # noqa: E402

BLOCK = 8  # dual frames a reference pass


class Fp8Control:
    def __init__(self, cfg, sd, device):
        self.cfg, self.sd, self.device = cfg, sd, device

    def predict_dual_frames(self, frames, base, out_size):
        frames = torch.as_tensor(frames, device=self.device)
        return torch.cat([ref_dpt.predict(self.cfg, self.sd, frames[s:s + BLOCK], base, dtype=torch.bfloat16,
                                          gemm_inputs=ref_dpt.fp8_rounding)
                          for s in range(0, frames.shape[0], BLOCK)])


def control(cell, sd, calib, base, device):
    return Fp8Control(cell.config, sd, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="dpt_vitl14_batch64")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("dpt_fp8_control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0, system=control)
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": "fp8_control",
                          "s": time.perf_counter() - t0, **{k: v["value"] for k, v in r["compared"].items()},
                          **r["counts"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
