"""Dataset-level ground-truth depth generation, the port of
``gelslim_depth_tpu/meshgen/generator.py``.

Reference-compatible constructor and behavior
(ref depth_from_mesh.py:9-78): for each `.pt` in the dataset dir (filtered
by object list), load the mesh `mesh/<object>.stl`, sample its surface,
scale to mm, and render a (left, right) depth-image stack per datapoint
from `in_hand_pose` + grasp width, writing the result back under
'depth_image' and re-saving the `.pt`.

Differences (deliberate, recorded in SURVEY.md's known-bugs list):
- whole objects render as one batch of poses on the device instead of a
  per-sample CPU Delaunay loop;
- the interactive input() confirmation gate (:34-36) is off by default
  (`interactive=True` restores it);
- the always-on per-sample matplotlib debug dump (:221-229) is gone.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch.data.dataset import _float32
from gelslim_depth_tpu_torch.data.pt_io import load_pt, save_pt
from gelslim_depth_tpu_torch.meshgen.depth_render import plane_spec, render_depth_batch
from gelslim_depth_tpu_torch.meshgen.sample import sample_surface_points
from gelslim_depth_tpu_torch.meshgen.stl import load_stl
from gelslim_depth_tpu_torch.utils.device import resolve_device

BACKENDS = ("auto", "native")


def _object_key(pt_file: str) -> str:
    """`pattern_31_rod_train.pt` -> `pattern_31_rod`... matching the
    reference's split-suffix handling (:30-34, 51-54, but robust to
    multi-underscore names rather than taking only the last '_' token —
    the reference's `split('_')[-2]` truncates names like
    'pattern_31_rod'; recorded as a fixed quirk)."""
    stem = pt_file[:-3] if pt_file.endswith(".pt") else pt_file
    for suffix in ("_train", "_val", "_test"):
        if stem.endswith(suffix):
            return stem[: -len(suffix)]
    return stem


def parse_grasp_widths_file(path: str) -> Dict[str, Optional[float]]:
    """'object: width' lines; 'None' means per-sample widths in the .pt
    (ref :38-46)."""
    out: Dict[str, Optional[float]] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            v = v.strip()
            out[k.strip()] = None if v == "None" else float(v)
    return out


class DepthImageGenerator:
    def __init__(
        self,
        mesh_dir: str,
        object_list: Optional[Sequence[str]],
        pc_scale: float,
        dataset_dir: str,
        grasp_widths_file: str,
        gelslim_plane: str = "+y+z",
        LR_flip: bool = False,
        image_size: Tuple[int, int] = (320, 427),
        image_height_mm: float = 12,
        grasp_width_offset: float = 0.0,
        pc_sampling: float = 1e5,
        device=None,
        *,
        interactive: bool = False,
        fill_iters: int = 6,
        seed: int = 0,
        backend: str = "auto",
    ):
        """device: where the torch renderer runs, ``cuda`` unless it says
        otherwise (raises without a card). backend: 'auto', the torch
        renderer on that device (meshgen/depth_render.py); 'native', the
        multi-threaded host C++ renderer (csrc/meshrender.cpp, the same
        algorithm), which raises when it cannot be built. self.backend
        names the renderer: 'torch' or 'native'."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
        self.mesh_dir = mesh_dir
        self.object_list = list(object_list) if object_list is not None else None
        self.pc_scale = float(pc_scale)
        self.dataset_dir = dataset_dir
        self.grasp_widths_file = grasp_widths_file
        self.spec = plane_spec(gelslim_plane)
        self.LR_flip = LR_flip
        self.image_size = tuple(image_size)
        self.image_height_mm = float(image_height_mm)
        self.mm_per_pixel = self.image_height_mm / self.image_size[0]
        self.grasp_width_offset = float(grasp_width_offset)
        self.pc_sampling = int(pc_sampling)
        self.interactive = interactive
        self.fill_iters = int(fill_iters)
        self.seed = seed
        self.backend = "native" if backend == "native" else "torch"
        self.device = resolve_device(device) if self.backend == "torch" else torch.device("cpu")

    def _dataset_files(self):
        files = sorted(f for f in os.listdir(self.dataset_dir) if f.endswith(".pt"))
        if self.object_list is not None:
            files = [f for f in files if _object_key(f) in self.object_list]
        return files

    def generate_depth_images_v1(self) -> None:
        files = self._dataset_files()
        if self.interactive:
            user_in = input(
                f"Generating depth images for {files}, Press enter to continue or q to quit."
            )
            if user_in == "q":
                return
        for pt_file in files:
            path = os.path.join(self.dataset_dir, pt_file)
            data = load_pt(path)
            data["depth_image"] = self.generate_for_object(pt_file, data)
            save_pt(data, path)

    def generate_for_object(self, pt_file: str, data: Dict) -> np.ndarray:
        """(B, 2, H, W) float32 depth stack for one object's dict."""
        key = _object_key(pt_file)
        tri = load_stl(os.path.join(self.mesh_dir, key + ".stl"))
        pc = sample_surface_points(tri, self.pc_sampling, seed=self.seed) * self.pc_scale

        poses = _float32(data["in_hand_pose"])[:, :3]
        n = poses.shape[0]
        fixed = parse_grasp_widths_file(self.grasp_widths_file).get(key)
        if fixed is None:
            widths = _float32(data["grasp_widths"]).reshape(n)
        else:
            widths = np.full((n,), fixed, np.float32)
        widths = widths + np.float32(self.grasp_width_offset)

        kw = dict(spec=self.spec, image_size=self.image_size, mm_per_pixel=self.mm_per_pixel,
                  fill_iters=self.fill_iters, lr_flip=self.LR_flip)
        if self.backend == "native":
            from gelslim_depth_tpu_torch.meshgen.native_render import render_depth_batch_native

            return render_depth_batch_native(pc, poses, widths, **kw)
        out = render_depth_batch(pc, poses, widths, device=self.device, **kw)
        return out.cpu().numpy()
