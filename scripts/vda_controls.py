#!/usr/bin/env python3
"""The controls that the video depth cell's limits are set against, served
in the program's place (``harness.run_cell(..., system=control)``) at the
cell's own size; one JSON line a run with every number compared and
every count, as ``benchmark/calibrate.py`` prints them for the program
and the faults:

    python3 scripts/vda_controls.py --workload vda_vitl14_clip64 \\
        --kinds fp8,no_temporal,reversed,interleaved --seeds 21,22,23 --seconds 1

- ``fp8``: the model one precision step below bfloat16,
  ``reference/vda.py``'s bfloat16 model with its encoder's matrix
  products fed float8_e4m3fn inputs (``gemm_inputs=fp8_rounding``), a
  clip at a time.
- ``no_temporal``: the program without its temporal modules: the
  per-frame DPT on the same weights.
- ``reversed``: the program handed each clip's frames in reverse order,
  its depth put back in the frames' order.
- ``interleaved``: the program's network handed the left and right
  fingers' frames alternating in one stream, so that each clip holds
  half a clip of each finger.
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
from benchmark.reference import dpt as ref_dpt, vda as ref_vda  # noqa: E402


class Fp8:
    def __init__(self, cfg, sd, device):
        self.cfg, self.sd, self.device = cfg, sd, device

    def predict_dual_frames(self, frames, base, out_size):
        return ref_vda.predict(self.cfg, self.sd, torch.as_tensor(frames, device=self.device), base,
                               dtype=torch.bfloat16, gemm_inputs=ref_dpt.fp8_rounding)


def within_clips_reversed(n: int, clip: int) -> torch.Tensor:
    """The order of n frames with each clip's frames reversed (its own
    inverse)."""
    return torch.cat([torch.arange(min(n, s + clip) - 1, s - 1, -1) for s in range(0, n, clip)])


class Reversed:
    def __init__(self, pred, clip: int):
        self.pred, self.clip = pred, clip

    def predict_dual_frames(self, frames, base, out_size):
        order = within_clips_reversed(frames.shape[0], self.clip).to(frames.device)
        return self.pred.predict_dual_frames(frames[order], base, out_size)[order]


class Interleaved:
    def __init__(self, pred):
        self.pred = pred

    @torch.inference_mode()
    def predict_dual_frames(self, frames, base, out_size):
        from gelslim_depth_tpu_torch import inference

        net = self.pred.net

        def mixed(x, streams=2):
            # (left 0..n-1, right 0..n-1) -> (left 0, right 0, left 1, ...) as one stream, and back
            rows = x.view(2, x.shape[0] // 2, *x.shape[1:]).transpose(0, 1).reshape(x.shape)
            y = net(rows, streams=1)
            return y.view(y.shape[0] // 2, 2, *y.shape[1:]).transpose(0, 1).reshape(y.shape)

        return inference.fused_predict_dual(self.pred.config, mixed, frames, base, tuple(out_size))


def _per_frame(cell, sd, base, device):
    cfg = {**cell.config, "dpt": {**cell.config["dpt"], "num_frames": 0}}
    per_frame = harness.Cell(**{**cell.__dict__, "config": cfg})
    sd = {k: v for k, v in sd.items() if ".motion_modules." not in k}
    return serving.serving_system(per_frame, sd, None, base, device)


CONTROLS = {
    "fp8": lambda cell, sd, calib, base, device: Fp8(cell.config, sd, device),
    "no_temporal": lambda cell, sd, calib, base, device: _per_frame(cell, sd, base, device),
    "reversed": lambda cell, sd, calib, base, device: Reversed(
        serving.serving_system(cell, sd, calib, base, device), cell.config["dpt"]["num_frames"]),
    "interleaved": lambda cell, sd, calib, base, device: Interleaved(
        serving.serving_system(cell, sd, calib, base, device)),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="vda_vitl14_clip64")
    p.add_argument("--kinds", default=",".join(CONTROLS))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("vda_controls: no CUDA card", file=sys.stderr)
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
