"""`export` command: write the serving artifact (a .gsx of torch.export
programs, gelslim_depth_tpu_torch/export.py).

Exports a trained (float) or quantized checkpoint's whole fused dual-frame
graph, weights inside, so that a serving process runs it with no model
code. The graphs run on the device they were exported on.

    python -m gelslim_depth_tpu_torch export <weights_name> [gpu] \
        [--int8] [--batch_sizes 1 64] [--output model.gsx] [--f32] [--check]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gelslim_depth_tpu_torch.cli.quantize_cmd import GPU_HELP, parse_device


def parse_args(argv):
    p = argparse.ArgumentParser(
        prog="gelslim-depth-tpu-torch export", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("weights_name", type=str, help="Checkpoint name to export")
    p.add_argument("gpu", type=str, nargs="?", default=None, help=GPU_HELP)
    p.add_argument("--weights_dir", type=str, default="train_output/weights")
    p.add_argument("--int8", action="store_true",
                   help="Export the quantized artifact (<name>_int8.npz, "
                        "see the quantize command) instead of the float "
                        "checkpoint")
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[1, 64],
                   help="One exported graph per batch size (static shapes)")
    p.add_argument("--output_size", type=int, nargs=2, default=[320, 427],
                   help="Depth output resolution")
    p.add_argument("--frame_size", type=int, nargs=2, default=[320, 427],
                   help="Raw input frame resolution")
    p.add_argument("--output", type=str, default=None,
                   help="Artifact path (default <weights_dir>/<name>[_int8].gsx)")
    p.add_argument("--platforms", type=str, nargs="+", default=None,
                   help="The device type to export for; it must be the one the graphs run on")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bfloat16 compute for the float graph (default)")
    p.add_argument("--f32", dest="bf16", action="store_false",
                   help="float32 compute for the float graph")
    p.add_argument("--check", action="store_true",
                   help="Reload the artifact and verify it against the live "
                        "predictor on random frames before reporting success")
    args = p.parse_args(argv)
    args.device = parse_device(p, args.gpu)
    return args


def run(argv):
    args = parse_args(argv)
    from gelslim_depth_tpu_torch.export import ExportedPredictor, export_predictor

    if args.int8:
        from gelslim_depth_tpu_torch.inference import QuantizedPredictor

        pred = QuantizedPredictor.from_checkpoint(args.weights_dir, args.weights_name, device=args.device)
        suffix = "_int8"
    else:
        from gelslim_depth_tpu_torch.inference import Predictor

        pred = Predictor.from_checkpoint(
            args.weights_dir, args.weights_name, device=args.device,
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        )
        suffix = ""
    out = args.output or os.path.join(args.weights_dir, f"{args.weights_name}{suffix}.gsx")
    path = export_predictor(
        pred, tuple(args.output_size), path=out,
        batch_sizes=tuple(args.batch_sizes), frame_size=tuple(args.frame_size),
        platforms=args.platforms,
    )
    print(f"wrote {path} (batch sizes {args.batch_sizes}, "
          f"{'int8' if args.int8 else ('bf16' if args.bf16 else 'f32')} graph)")
    if args.check:
        served = ExportedPredictor.load(path)
        n = min(args.batch_sizes)
        rng = np.random.RandomState(0)
        frames = rng.uniform(0, 255, (n, 6, *args.frame_size)).astype(np.float32)
        base = rng.uniform(0, 255, (6, *args.frame_size)).astype(np.float32)
        got = served(frames, base).cpu().numpy()
        want = pred.predict_dual_frames(frames, base, tuple(args.output_size)).cpu().numpy()
        delta = float(np.sqrt(np.mean((got - want) ** 2)))
        if delta >= 1e-4:  # not assert: --check must survive python -O
            raise SystemExit(
                f"export check FAILED: exported graph deviates from the "
                f"live predictor by {delta} mm RMSE"
            )
        print(f"check OK: exported-vs-live RMSE {delta:.2e} mm at batch {n}")
    return 0
