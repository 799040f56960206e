"""Mesh -> contact-depth ground truth, the port of ``gelslim_depth_tpu/meshgen``:
STL IO, surface sampling, the torch renderer, the host C++ renderer and the
dataset generator."""

from gelslim_depth_tpu_torch.meshgen.stl import load_stl, save_stl_binary
from gelslim_depth_tpu_torch.meshgen.sample import sample_surface_points
from gelslim_depth_tpu_torch.meshgen.depth_render import (
    PlaneSpec,
    plane_spec,
    affine2d_points,
    render_depth_pair,
    render_depth_batch,
)
from gelslim_depth_tpu_torch.meshgen.generator import DepthImageGenerator

__all__ = [
    "load_stl",
    "save_stl_binary",
    "sample_surface_points",
    "PlaneSpec",
    "plane_spec",
    "affine2d_points",
    "render_depth_pair",
    "render_depth_batch",
    "DepthImageGenerator",
]
