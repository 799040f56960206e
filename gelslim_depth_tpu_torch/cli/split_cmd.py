"""`split-data` command (rebuild of scripts/data_scripts/split_data.py), the
port of ``gelslim_depth_tpu/cli/split_cmd.py``.

For each loose `.pt` in the data dir: shuffle, split 0.8/0.1/0.1, carry
tactile_image always plus depth_image / in_hand_pose / base_tactile_image
with aligned indices when present, write <name>_{train,val,test}.pt into
the three subdirs, and delete the original (ref split_data.py:22-85;
pass --keep_originals to skip the delete, which the reference only offers
as a comment to edit). The same seed draws the same permutation as the JAX
package's command, and the files come out the same, byte for byte.
Splitting runs on the host."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gelslim_depth_tpu_torch.cli.quantize_cmd import GPU_HELP, parse_device

SPLIT = (0.8, 0.1, 0.1)
CARRIED_KEYS = ("depth_image", "in_hand_pose", "base_tactile_image", "grasp_widths")


def split_object(data: dict, rng: np.random.RandomState):
    """(train, val, test) dicts of one object's rows; tensors keep their
    dtype, arrays come out as tensors."""
    n = len(data["tactile_image"])
    order = rng.permutation(n)
    i_train = int(n * SPLIT[0])
    i_val = int(n * (SPLIT[0] + SPLIT[1]))
    parts = (order[:i_train], order[i_train:i_val], order[i_val:])
    out = []
    for sel in parts:
        sel = torch.from_numpy(sel)
        out.append({key: torch.as_tensor(data[key])[sel]
                    for key in ("tactile_image", *CARRIED_KEYS) if key in data})
    return out


def run(argv):
    p = argparse.ArgumentParser(prog="gelslim-depth-tpu-torch split-data")
    p.add_argument("gpu", nargs="?", default=None,
                   help=GPU_HELP + "; accepted for the reference's command line, the split runs on the host")
    p.add_argument("--data_path", default=None)
    p.add_argument("--keep_originals", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    parse_device(p, args.gpu)

    from gelslim_depth_tpu_torch.data.pt_io import load_pt, save_pt

    data_dir = args.data_path
    if data_dir is None:
        from gelslim_depth_tpu_torch import main_config

        data_dir = main_config.DATA_PATH

    rng = np.random.RandomState(args.seed)
    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".pt"))
    for sub in ("train_data", "validation_data", "test_data"):
        os.makedirs(os.path.join(data_dir, sub), exist_ok=True)
    for filename in files:
        data = load_pt(os.path.join(data_dir, filename))
        if "depth_image" not in data and "depth_images" not in data:
            print(f"[INFO] No depth images found in {filename}. Still splitting; "
                  "generate them with the generate-depth command.")
        train_d, val_d, test_d = split_object(data, rng)
        stem = filename[:-3]
        save_pt(train_d, os.path.join(data_dir, "train_data", stem + "_train.pt"))
        save_pt(val_d, os.path.join(data_dir, "validation_data", stem + "_val.pt"))
        save_pt(test_d, os.path.join(data_dir, "test_data", stem + "_test.pt"))
        if not args.keep_originals:
            os.remove(os.path.join(data_dir, filename))
        print(f"split {filename}: {len(train_d['tactile_image'])}/"
              f"{len(val_d['tactile_image'])}/{len(test_d['tactile_image'])}")
    return 0
