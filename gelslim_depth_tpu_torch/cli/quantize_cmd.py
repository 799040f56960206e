"""`quantize` command: post-training int8 quantization of a trained
checkpoint, calibrated on real dataset frames.

Loads a checkpoint (<weights_dir>/<name>.npz, the JAX package's format) or
a reference config .py + torch .pth pair, calibrates the activation scales
on frames drawn from a dataset split, writes <name>_int8.npz next to the
weights (loadable by QuantizedPredictor.from_checkpoint in either package),
and prints the calibration fitness delta in mm, the number to check before
deploying.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

GPU_HELP = "'cpu', or a CUDA ordinal n for cuda:n (default: cuda)"


def parse_args(argv):
    p = argparse.ArgumentParser(
        prog="gelslim-depth-tpu-torch quantize",
        description="int8 post-training quantization of a trained model.",
    )
    p.add_argument("weights_name", type=str, help="Checkpoint name to quantize")
    p.add_argument("gpu", type=str, nargs="?", default=None, help=GPU_HELP)
    p.add_argument("--weights_dir", type=str, default="train_output/weights")
    p.add_argument("--config_module", type=str, default=None,
                   help="Reference-style config .py (with --torch_pth)")
    p.add_argument("--torch_pth", type=str, default=None,
                   help="torch state dict to quantize instead of an npz checkpoint")
    p.add_argument("--data_path", type=str, default=None, help="Override GELSLIM_DATA_PATH")
    p.add_argument("--calib_dir", type=str, default="train_data",
                   help="Dataset sub-directory to draw calibration frames from")
    p.add_argument("--calib_frames", type=int, default=16,
                   help="Number of dual frames for calibration")
    p.add_argument("--percentile", type=float, default=100.0,
                   help="Activation-scale percentile (<100 clips outliers)")
    p.add_argument("--int8_upconvs", action="store_true",
                   help="Also run the transposed convs in int8 (row-split "
                        "matmul formulation); validate the reported delta")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.torch_pth and not args.config_module:
        p.error("--torch_pth requires --config_module")
    args.device = parse_device(p, args.gpu)
    return args


def parse_device(parser, gpu):
    from gelslim_depth_tpu_torch.utils.device import device_from_gpu_arg

    try:
        return device_from_gpu_arg(gpu)
    except ValueError as e:
        parser.error(str(e))


def as_float32(v) -> np.ndarray:
    """A .pt entry (a tensor of any float type, bfloat16 included, or an
    array) as a float32 numpy array."""
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v, np.float32)


def _load_calibration_frames(dataset_dir: str, n: int, seed: int, *, need_base: bool):
    """Raw (n, 6, H, W) frames + a (6, H, W) base frame from the .pt files
    of a split directory. With need_base (difference-image configs) the
    scan continues past the frame quota until a base frame is found:
    calibrating a diff-image model on non-difference inputs would produce
    scales (and a fitness delta) for the wrong input distribution."""
    from gelslim_depth_tpu_torch.data.pt_io import load_pt

    frames, base = [], None
    for fname in sorted(os.listdir(dataset_dir)):
        if not fname.endswith(".pt"):
            continue
        d = load_pt(os.path.join(dataset_dir, fname))
        if "tactile_image" not in d:
            continue
        if sum(f.shape[0] for f in frames) < n:
            frames.append(as_float32(d["tactile_image"]))
        if base is None and "base_tactile_image" in d:
            base = as_float32(d["base_tactile_image"])[0]
        if sum(f.shape[0] for f in frames) >= n and (base is not None or not need_base):
            break
    if not frames:
        raise FileNotFoundError(f"no .pt files with tactile_image in {dataset_dir}")
    if need_base and base is None:
        raise FileNotFoundError(
            f"config.use_difference_image is set but no base_tactile_image "
            f"was found in any .pt under {dataset_dir}: refusing to "
            f"calibrate on the wrong input distribution"
        )
    allf = np.concatenate(frames, axis=0)
    rng = np.random.RandomState(seed)
    idx = rng.choice(allf.shape[0], size=min(n, allf.shape[0]), replace=False)
    return allf[idx], base


def run(argv):
    args = parse_args(argv)
    from gelslim_depth_tpu_torch.config import GelslimConfig
    from gelslim_depth_tpu_torch.inference import Predictor

    kw = dict(compute_dtype=torch.bfloat16, device=args.device)
    if args.torch_pth:
        config = GelslimConfig.from_python_module(args.config_module)
        config.weights_name = args.weights_name
        pred = Predictor.from_torch_checkpoint(args.torch_pth, config, **kw)
    else:
        pred = Predictor.from_checkpoint(args.weights_dir, args.weights_name, **kw)
        config = pred.config

    dataset_path = args.data_path
    if dataset_path is None:
        from gelslim_depth_tpu_torch import main_config

        dataset_path = main_config.DATA_PATH
    calib_dir = os.path.join(dataset_path, args.calib_dir)
    frames, base = _load_calibration_frames(
        calib_dir, args.calib_frames, args.seed,
        need_base=bool(config.use_difference_image),
    )
    print(f"calibrating on {frames.shape[0]} frames from {calib_dir}"
          + ("" if base is not None else " (no base frame found)"))

    qpred = pred.quantize(
        frames, base, percentile=args.percentile, quantize_upconvs=args.int8_upconvs
    )
    path = qpred.save(args.weights_dir, name=args.weights_name)
    print(f"wrote {path}")
    print(f"calibration delta vs float graph: {qpred.delta_mm:.5f} mm RMSE "
          f"(parity budget: 0.05 mm)")
    return 0
