#!/usr/bin/env python3
"""The controls that the Depth Pro cell's limits are set against, served in
the program's place (``harness.run_cell(..., system=control)``) at the
cell's own size; one JSON line a run with every number compared and
every count, as ``benchmark/calibrate.py`` prints them for the program
and the faults:

    python3 scripts/depth_pro_controls.py --workload depth_pro_batch8 \\
        --kinds fp8,transposed,shifted --seeds 21,22 --seconds 1

- ``fp8``: the model one precision step below bfloat16,
  ``reference/depth_pro.py``'s bfloat16 model with both encoders' matrix
  products fed float8_e4m3fn inputs (``gemm_inputs=fp8_rounding``), a dual
  frame at a time.
- ``transposed``: the program with its tiles merged in the wrong order,
  column-major where the split is row-major (each tile's map lands at its
  mirror across the diagonal).
- ``shifted``: the program with each tile's crop taken on the wrong side:
  every tile's first cells kept, so that the merged map is of the right
  size but its tiles sit up to two paddings off their places.

A merge that crops nothing makes maps of another size, which the decoder's
first fusion refuses (its two inputs differ in size): no control, a crash.
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

from benchmark import harness, serving  # noqa: E402
from benchmark.reference import depth_pro as ref_depth_pro, dpt as ref_dpt  # noqa: E402


class Fp8:
    def __init__(self, cfg, sd, device):
        self.cfg, self.sd, self.device = cfg, sd, device

    def predict_dual_frames(self, frames, base, out_size):
        return ref_depth_pro.predict(self.cfg, self.sd, torch.as_tensor(frames, device=self.device), base,
                                     dtype=torch.bfloat16, gemm_inputs=ref_dpt.fp8_rounding)


def transposed_merge(maps, n, steps, padding):
    """The program's merge of the tiles taken column-major."""
    from gelslim_depth_tpu_torch.models.depth_pro import merge

    g = maps.shape[1]
    return merge(maps.view(steps, steps, n, g, g, -1).transpose(0, 1).reshape(maps.shape), n, steps, padding)


def shifted_merge(maps, n, steps, padding):
    """The merge with each tile's cells kept from its first: as many as the
    right crop keeps, none cut from the start."""
    g = maps.shape[1]
    tiles = maps.view(steps, steps, n, g, g, maps.shape[-1])

    def cut(k):
        return slice(0, g - padding * ((k > 0) + (k < steps - 1)))

    rows = [torch.cat([tiles[j, i, :, cut(j), cut(i)] for i in range(steps)], dim=2) for j in range(steps)]
    return torch.cat(rows, dim=1)


def _mis_merged(merge_fn):
    def make(cell, sd, calib, base, device):
        pred = serving.serving_system(cell, sd, calib, base, device)
        pred.net.merge = merge_fn
        return pred
    return make


CONTROLS = {
    "fp8": lambda cell, sd, calib, base, device: Fp8(cell.config, sd, device),
    "transposed": _mis_merged(transposed_merge),
    "shifted": _mis_merged(shifted_merge),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="depth_pro_batch8")
    p.add_argument("--kinds", default=",".join(CONTROLS))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("depth_pro_controls: no CUDA card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    cell = harness.find_cell(args.workload)
    for kind in args.kinds.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0, system=CONTROLS[kind])
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, "s": time.perf_counter() - t0,
                              **{k: v["value"] for k, v in r["compared"].items()}, **r["counts"],
                              "metrics": {k: v["value"] for k, v in r["metrics"].items()}}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
