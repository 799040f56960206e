"""Synthetic reference-shaped dataset fixtures, the port's copy of
``gelslim_depth_tpu/data/synthetic.py`` (numpy; the same draws from the
same ``RandomState`` give the same arrays).

Generates dicts with the reference's `.pt` schema (README.md:33-44):
  tactile_image       (N, 6, H, W) float32, [0, 255] — dual-finger RGB
  base_tactile_image  (N, 6, H, W) float32 — undeformed reference frames
  depth_image         (N, 2, H, W) float32, <= 0 mm — per-finger depth
  in_hand_pose        (N, 3) float32 — (y, z, theta) SE(2) pose
  grasp_widths        (N,) float32 mm

Contact is synthesized as smooth Gaussian indentations, so the depth maps
have structure (zero background, negative blobs) and the tactile images
respond to the contact; ``make_mesh_contact_object`` renders it from real
STL geometry instead.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from gelslim_depth_tpu_torch.data.pt_io import save_pt


def _base_frames(rng: np.random.RandomState, n: int, h: int, w: int, jitter: float) -> np.ndarray:
    """Undeformed reference frames: a per-channel DC level plus spatial
    jitter, identical across the N samples of one object."""
    base = rng.uniform(80, 170, (1, 6, 1, 1)).astype(np.float32) + rng.uniform(
        -jitter, jitter, (1, 6, h, w)
    ).astype(np.float32)
    return np.broadcast_to(base, (n, 6, h, w)).copy()


def _apply_sensor_response(
    rng: np.random.RandomState,
    base: np.ndarray,
    depth: np.ndarray,
    *,
    max_depth_mm: float,
    response_power: float = 1.0,
    noise_std: float = 2.0,
) -> np.ndarray:
    """The sensor model: per-channel response [+35, -20, +15]/mm of
    indentation, raised to `response_power` on the normalized indentation,
    plus additive noise, clipped to [0, 255]."""
    tactile = base.copy()
    for f in range(2):
        resp = (-depth[:, f : f + 1]) / max_depth_mm  # [0, 1] where contact
        resp = max_depth_mm * resp ** np.float32(response_power)
        tactile[:, 3 * f : 3 * f + 3] += np.concatenate(
            [35.0 * resp, -20.0 * resp, 15.0 * resp], axis=1
        )
    return np.clip(
        tactile + rng.normal(0, noise_std, tactile.shape), 0, 255
    ).astype(np.float32)


def make_synthetic_object(
    rng: np.random.RandomState,
    n: int = 8,
    image_size: Tuple[int, int] = (320, 427),
    n_blobs: int = 2,
    max_depth_mm: float = 1.9,
    blob_sigma_range: Tuple[float, float] = (8.0, 30.0),
    rotated: bool = False,
    response_power: float = 1.0,
    noise_std: float = 2.0,
) -> Dict[str, np.ndarray]:
    """`blob_sigma_range`, `rotated` and `response_power` harden the task
    for long convergence runs (small rotated anisotropic indentations, a
    super-linear tactile response); `noise_std` sets the additive sensor
    noise. The defaults give the easy fixtures."""
    h, w = image_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = _base_frames(rng, n, h, w, jitter=8.0)

    s_lo, s_hi = blob_sigma_range
    depth = np.zeros((n, 2, h, w), np.float32)
    for i in range(n):
        for f in range(2):
            for _ in range(n_blobs):
                cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
                sy, sx = rng.uniform(s_lo, s_hi), rng.uniform(s_lo, s_hi)
                amp = rng.uniform(0.3, 1.0) * max_depth_mm
                dy, dx = yy - cy, xx - cx
                if rotated:
                    th = rng.uniform(0, np.pi)
                    dy, dx = (np.cos(th) * dy - np.sin(th) * dx,
                              np.sin(th) * dy + np.cos(th) * dx)
                depth[i, f] -= amp * np.exp(
                    -((dy / sy) ** 2 + (dx / sx) ** 2)
                ).astype(np.float32)
    depth = np.maximum(depth, -max_depth_mm)

    tactile = _apply_sensor_response(
        rng, base, depth, max_depth_mm=max_depth_mm,
        response_power=response_power, noise_std=noise_std,
    )

    return {
        "tactile_image": tactile,
        "base_tactile_image": base.astype(np.float32),
        "depth_image": depth,
        "in_hand_pose": rng.uniform(-0.01, 0.01, (n, 3)).astype(np.float32),
        "grasp_widths": rng.uniform(20, 40, (n,)).astype(np.float32),
    }


def make_mesh_contact_object(
    rng: np.random.RandomState,
    mesh_path: str,
    n: int = 8,
    *,
    pc_scale: float = 1000.0,
    image_size: Tuple[int, int] = (160, 213),
    image_height_mm: float = 12.0,
    n_points: int = 100_000,
    penetration_mm: Tuple[float, float] = (0.3, 1.5),
    translation_mm: float = 2.0,
    gelslim_plane: str = "+y+z",
    max_depth_mm: float = 1.9,
    noise_std: float = 2.0,
    device=None,
) -> Dict[str, np.ndarray]:
    """Reference-schema object whose depth maps come from REAL geometry.

    Renders `n` random grasps of an actual STL mesh through the package's
    own GT pipeline (meshgen: area-weighted surface sampling + SE(2) +
    combined-finger min-splat — the rebuild of ref depth_from_mesh.py:80-231)
    on `device` (``cuda`` unless it says otherwise), then synthesizes the
    tactile response from those depth maps with the same per-channel sensor
    model as `make_synthetic_object`. The result is a corpus with the
    statistics the product actually sees (line/curve patterns, hex keys,
    pegs — sharp ridges and flats, not Gaussian blobs).

    Poses are uniform: in-plane translations ±`translation_mm`, angle
    [0, 2pi). Grasp width is derived per sample so the deepest contact is
    a draw from `penetration_mm`: the SE(2) transform never moves points
    along the out-of-plane axis, so the cloud's out-of-plane extent is
    pose-invariant and width = extent - 2*penetration pins the max
    per-finger indentation exactly.
    """
    from gelslim_depth_tpu_torch.meshgen import load_stl, plane_spec, render_depth_batch, sample_surface_points

    h, w = image_size
    spec = plane_spec(gelslim_plane)
    tri = load_stl(mesh_path)
    pts = sample_surface_points(tri, n_points, seed=int(rng.randint(2**31))) * pc_scale
    perp = pts[:, spec.perp]
    extent = float(perp.max() - perp.min())

    pen = rng.uniform(penetration_mm[0], penetration_mm[1], (n,)).astype(np.float32)
    widths = np.maximum(extent - 2.0 * pen, 0.1).astype(np.float32)
    t_m = translation_mm / 1000.0  # render_depth_batch takes meters (ref :156)
    poses = np.stack(
        [
            rng.uniform(-t_m, t_m, n),
            rng.uniform(-t_m, t_m, n),
            rng.uniform(0.0, 2.0 * np.pi, n),
        ],
        axis=1,
    ).astype(np.float32)

    depth = render_depth_batch(
        pts, poses, widths, spec=spec, image_size=image_size, mm_per_pixel=image_height_mm / h, device=device,
    ).cpu().numpy()
    depth = np.maximum(depth, -max_depth_mm)

    base = _base_frames(rng, n, h, w, jitter=6.0)
    tactile = _apply_sensor_response(
        rng, base, depth, max_depth_mm=max_depth_mm, response_power=1.0,
        noise_std=noise_std,
    )

    return {
        "tactile_image": tactile,
        "base_tactile_image": base.astype(np.float32),
        "depth_image": depth,
        "in_hand_pose": poses,
        "grasp_widths": widths,
    }


def write_synthetic_dataset_tree(
    root: str,
    object_names=("pattern_31_rod", "peg1"),
    n_per_object: int = 6,
    image_size: Tuple[int, int] = (64, 86),
    seed: int = 0,
) -> None:
    """Materialize a reference-layout dataset directory tree:
    {train,validation,test}_data/<obj>_{train,val,test}.pt plus real_data/
    with its inclusion-list txt files (ref train_unet.py:110-192)."""
    rng = np.random.RandomState(seed)
    for sub, suffix in (("train_data", "_train"), ("validation_data", "_val"), ("test_data", "_test")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for name in object_names:
            obj = make_synthetic_object(rng, n_per_object, image_size)
            save_pt(obj, os.path.join(root, sub, f"{name}{suffix}.pt"))
    os.makedirs(os.path.join(root, "real_data"), exist_ok=True)
    real = make_synthetic_object(rng, n_per_object, image_size)
    save_pt(real, os.path.join(root, "real_data", "button.pt"))
    with open(os.path.join(root, "real_data", "train_real_objects.txt"), "w") as f:
        f.write("button\n")
    for fname in ("validation_real_objects.txt", "test_real_objects.txt"):
        open(os.path.join(root, "real_data", fname), "w").close()
    open(os.path.join(root, "validation_objects.txt"), "w").close()
    open(os.path.join(root, "test_objects.txt"), "w").close()
    with open(os.path.join(root, "grasp_widths.txt"), "w") as f:
        for name in object_names:
            f.write(f"{name}: 30.0\n")
