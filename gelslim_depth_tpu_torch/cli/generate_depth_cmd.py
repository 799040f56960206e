"""`generate-depth` command (rebuild of scripts/data_scripts/
depth_generation.py — the reference is an edit-in-file parameter block
(:9-18); here everything is a flag), the port of
``gelslim_depth_tpu/cli/generate_depth_cmd.py`` with the same flags. It
renders with the torch renderer on cuda unless the ``gpu`` positional says
otherwise."""

from __future__ import annotations

import argparse
import os

from gelslim_depth_tpu_torch.cli.quantize_cmd import GPU_HELP, parse_device


def run(argv):
    p = argparse.ArgumentParser(prog="gelslim-depth-tpu-torch generate-depth")
    p.add_argument("gpu", nargs="?", default=None, help=GPU_HELP)
    p.add_argument("--mesh_dir", default="mesh")
    p.add_argument("--objects", nargs="+", default=None,
                   help="object names; default: every .pt in the dataset dir")
    p.add_argument("--dataset_dir", default=None,
                   help="directory of .pt files (default <DATA_PATH>/real_data)")
    p.add_argument("--grasp_widths_file", default=None)
    p.add_argument("--pc_scale", type=float, default=1000.0)
    p.add_argument("--gelslim_plane", default="+y+z")
    p.add_argument("--lr_flip", action="store_true")
    p.add_argument("--image_size", type=int, nargs=2, default=(320, 427))
    p.add_argument("--image_height_mm", type=float, default=12.0)
    p.add_argument("--grasp_width_offset", type=float, default=0.0)
    p.add_argument("--pc_sampling", type=float, default=1e5)
    p.add_argument("--interactive", action="store_true",
                   help="restore the reference's confirmation prompt")
    args = p.parse_args(argv)
    device = parse_device(p, args.gpu)

    from gelslim_depth_tpu_torch.meshgen import DepthImageGenerator

    dataset_dir = args.dataset_dir
    grasp_widths_file = args.grasp_widths_file
    if dataset_dir is None or grasp_widths_file is None:
        from gelslim_depth_tpu_torch import main_config

        dataset_dir = dataset_dir or os.path.join(main_config.DATA_PATH, "real_data")
        grasp_widths_file = grasp_widths_file or os.path.join(
            main_config.DATA_PATH, "grasp_widths.txt"
        )

    gen = DepthImageGenerator(
        mesh_dir=args.mesh_dir,
        object_list=args.objects,
        pc_scale=args.pc_scale,
        dataset_dir=dataset_dir,
        grasp_widths_file=grasp_widths_file,
        gelslim_plane=args.gelslim_plane,
        LR_flip=args.lr_flip,
        image_size=tuple(args.image_size),
        image_height_mm=args.image_height_mm,
        grasp_width_offset=args.grasp_width_offset,
        pc_sampling=args.pc_sampling,
        device=device,
        interactive=args.interactive,
    )
    gen.generate_depth_images_v1()
    return 0
