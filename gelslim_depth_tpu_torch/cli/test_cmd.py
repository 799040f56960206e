"""`test` command: the visual evaluation harness
(rebuild of test_utils/test_depth_estimation.py:22-104).

For up to 5 objects of a chosen sub_dir, pick 5 random samples each with a
random finger, build (optionally difference) 3-channel inputs, run the
fused predictor at native resolution, and save an RGB-vs-depth grid to
test_output/depth_predictions.png when matplotlib imports. The reference's
base-image index off-by-one (`min(idx, num_base)` instead of num_base-1,
ref :83) is fixed. Also prints a per-object mm RMSE against ground truth
when the dict has depth.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gelslim_depth_tpu_torch.cli.quantize_cmd import GPU_HELP, as_float32, parse_device


def run(argv):
    p = argparse.ArgumentParser(prog="gelslim-depth-tpu-torch test")
    p.add_argument("weights_name")
    p.add_argument("gpu", nargs="?", default=None, help=GPU_HELP)
    p.add_argument("sub_dir")
    p.add_argument("objects", nargs="*")
    p.add_argument("--data_path", default=None)
    p.add_argument("--weights_dir", default="train_output/weights")
    p.add_argument("--output_dir", default="test_output")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config_module", default=None,
                   help="reference-style generated config (.py path or import "
                        "path) to use instead of a <weights_dir> json artifact")
    p.add_argument("--torch_pth", default=None,
                   help="load weights from a torch .pth state dict (e.g. the "
                        "published unet_bigdata.pth) instead of a .npz checkpoint")
    p.add_argument("--int8", action="store_true",
                   help="evaluate the quantized serving artifact "
                        "(<weights_name>_int8.npz from the quantize command) "
                        "instead of the float checkpoint")
    args = p.parse_args(argv)
    if args.int8 and (args.config_module or args.torch_pth):
        p.error("--int8 evaluates a quantized artifact; it cannot be "
                "combined with --config_module/--torch_pth (quantize the "
                "artifact first with the quantize command)")
    device = parse_device(p, args.gpu)

    from gelslim_depth_tpu_torch import ops
    from gelslim_depth_tpu_torch.data.pt_io import load_pt
    from gelslim_depth_tpu_torch.inference import Predictor
    from gelslim_depth_tpu_torch.train.checkpoint import load_checkpoint

    data_path = args.data_path
    if data_path is None:
        from gelslim_depth_tpu_torch import main_config

        data_path = main_config.DATA_PATH
    data_path = os.path.join(data_path, args.sub_dir)

    pt_files = sorted(f for f in os.listdir(data_path) if f.endswith(".pt"))
    if args.objects:
        pt_files = [f for name in args.objects for f in pt_files if name in f]
    pt_files = pt_files[:5]

    if args.int8:
        from gelslim_depth_tpu_torch.inference import QuantizedPredictor

        predictor = QuantizedPredictor.from_checkpoint(args.weights_dir, args.weights_name, device=device)
        config = predictor.config
        print(f"int8 artifact: calibration delta {predictor.delta_mm:.5f} mm "
              f"vs float graph")
    elif args.config_module or args.torch_pth:
        # reference-artifact migration path: generated config .py +
        # published torch weights, no retraining or conversion step needed
        from gelslim_depth_tpu_torch.config import GelslimConfig

        if args.config_module:
            config = GelslimConfig.from_python_module(args.config_module)
        else:
            config, _, _ = load_checkpoint(args.weights_dir, args.weights_name)
        pth = args.torch_pth or (config.weights_path + args.weights_name + ".pth")
        predictor = Predictor.from_torch_checkpoint(pth, config, device=device)
    else:
        predictor = Predictor.from_checkpoint(args.weights_dir, args.weights_name, device=device)
        config = predictor.config

    rng = np.random.RandomState(args.seed)
    n_show = 5
    rows = []
    for pt_file in pt_files:
        print("Testing on:", pt_file)
        pt = load_pt(os.path.join(data_path, pt_file))
        img = as_float32(pt["tactile_image"])
        n, _, h, w = img.shape
        idx = rng.randint(0, n, n_show)
        finger = rng.randint(0, 2, n_show)
        inputs = np.stack([img[i, 3 * f : 3 * f + 3] for i, f in zip(idx, finger)])
        if config.use_difference_image and "base_tactile_image" in pt:
            base = as_float32(pt["base_tactile_image"])
            bsel = np.minimum(idx, base.shape[0] - 1)  # ref off-by-one fixed
            bases = np.stack([base[i, 3 * f : 3 * f + 3] for i, f in zip(bsel, finger)])
            inputs = ops.get_difference_image(torch.from_numpy(inputs), torch.from_numpy(bases)).numpy()
        depth = predictor.predict_depth_from_RGB(inputs, (h, w)).cpu().numpy()

        gt = None
        for key in ("depth_image", "depth_images"):
            if key in pt:
                gt = np.stack([as_float32(pt[key])[i, f] for i, f in zip(idx, finger)])[:, None]
        if gt is not None:
            rmse = float(np.sqrt(np.mean((depth - gt) ** 2)))
            print(f"  mm RMSE vs ground truth: {rmse:.4f}")
        rows.append((pt_file, inputs, depth))

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, "depth_predictions.png")
    if _save_grid(rows, n_show, out_path):
        print(f"Saved {out_path}")
    return 0


def _save_grid(rows, n_show, out_path) -> bool:
    """The RGB-vs-depth grid as a PNG; False, and nothing written, where
    matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping image grid")
        return False
    n_obj = len(rows)
    fig, axs = plt.subplots(
        n_show, max(n_obj * 2, 2), figsize=(2 * max(n_obj, 1), 1.1 * n_show), squeeze=False
    )
    for i, (name, inputs, depth) in enumerate(rows):
        for j in range(n_show):
            axs[j][2 * i].imshow(np.clip(inputs[j].transpose(1, 2, 0), 0, 255).astype(np.uint8))
            axs[j][2 * i + 1].imshow(depth[j, 0])
            for ax in (axs[j][2 * i], axs[j][2 * i + 1]):
                ax.set_xticks([])
                ax.set_yticks([])
    plt.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return True
