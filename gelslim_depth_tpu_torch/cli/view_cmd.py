"""`view` command (rebuild of scripts/data_scripts/view_pt.py), the port of
``gelslim_depth_tpu/cli/view_cmd.py``: plot 5 random samples' L/R tactile +
L/R depth with the in-hand pose in the title, shared depth color scale,
saved under pt_images/<name>.png. The reference loops on input(); pass
--loop to get that, default is one shot. Runs on the host (numpy and
matplotlib)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from gelslim_depth_tpu_torch.cli.quantize_cmd import as_float32


def run(argv):
    p = argparse.ArgumentParser(prog="gelslim-depth-tpu-torch view")
    p.add_argument("sub_dir")
    p.add_argument("data_name")
    p.add_argument("--data_path", default=None)
    p.add_argument("--output_dir", default="pt_images")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    from gelslim_depth_tpu_torch.data.pt_io import load_pt

    data_path = args.data_path
    if data_path is None:
        from gelslim_depth_tpu_torch import main_config

        data_path = main_config.DATA_PATH
    data_dir = os.path.join(data_path, args.sub_dir)
    matches = [f for f in sorted(os.listdir(data_dir)) if args.data_name in f]
    if not matches:
        print(f"no .pt matching {args.data_name!r} in {data_dir}")
        return 1
    pt = load_pt(os.path.join(data_dir, matches[0]))

    img = as_float32(pt["tactile_image"])
    n = img.shape[0]
    poses = as_float32(pt["in_hand_pose"]) if "in_hand_pose" in pt else np.zeros((n, 3), np.float32)
    depth = pt.get("depth_image", pt.get("depth_images"))
    depth = (
        as_float32(depth)
        if depth is not None
        else np.zeros((n, 2, img.shape[2], img.shape[3]), np.float32)
    )
    print("Found", n, "data points")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable")
        return 1

    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    min_depth = 0.0
    while True:
        k = min(5, n)
        idx = rng.choice(n, k, replace=False)
        fig, axs = plt.subplots(k, 4, figsize=(20, 5 * k), squeeze=False)
        for r, i in enumerate(idx):
            min_depth = min(min_depth, float(depth[i].min()))
            axs[r][0].imshow(np.clip(img[i, :3].transpose(1, 2, 0), 0, 255).astype(np.uint8))
            axs[r][1].imshow(depth[i, 0], vmax=0, vmin=min_depth)
            pose = poses[i]
            axs[r][1].set_title(
                f"In Hand Pose: {round(1000 * pose[0], 1)} mm, "
                f"{round(1000 * pose[1], 1)} mm, "
                f"{round(180 / np.pi * pose[2], 1)} deg"
            )
            axs[r][2].imshow(np.clip(img[i, 3:6].transpose(1, 2, 0), 0, 255).astype(np.uint8))
            axs[r][3].imshow(depth[i, 1], vmax=0, vmin=min_depth)
            for c in range(4):
                axs[r][c].set_xticks([])
                axs[r][c].set_yticks([])
        fig.suptitle("Left                    Right")
        out = os.path.join(args.output_dir, f"{args.data_name}.png")
        fig.savefig(out, dpi=150)
        plt.close(fig)
        print("saved", out)
        if not args.loop:
            break
        if input("Press Enter to continue (q to quit)") == "q":
            break
    return 0
