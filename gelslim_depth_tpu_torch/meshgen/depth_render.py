"""Vectorized mesh -> per-finger contact-depth rendering on torch tensors,
the port of ``gelslim_depth_tpu/meshgen/depth_render.py``.

Capability-equivalent to the reference's generate_depth_image
(ref depth_from_mesh.py:80-231) with the one sanctioned algorithm change
(SURVEY.md section 2.2): the reference's Delaunay + griddata scattered
interpolation becomes a regular-grid *min-splat rasterization with
iterative hole fill*. Output contract: (image_size) maps of penetration
depth in mm, <= 0, 0 where no contact, floored at the cloud's min depth,
holes/outside -> 0 (the reference's NaN->0, :193-218).

Geometry pipeline (identical to the reference):
1. center the cloud along the out-of-plane axis (:153-154);
2. SE(2) transform in the gelslim plane: rotation by `angle` about the
   out-of-plane axis + translations (meters -> mm via x1000) (:156,233-248);
3. split into right/left half-clouds at the midplane, clamp each to its
   gel plane at +-width/2, re-express as penetration depth (:158-164);
4. mirror the left image's unaligned axis (:166);
5. resample onto the pixel grid with mm_per_pixel = image_height_mm/H,
   rows <-> the unaligned axis, cols <-> the aligned axis (:12,169-190).

Where the JAX package vmaps one pose's program over the batch, the
functions here work on a (B, P) batch of poses by points directly, in
chunks of poses that bound the per-point temporaries. Everything is
float32 on the caller's device. The scatter-min is ``scatter_reduce_``
with ``amin``, order-independent and so deterministic; everything after
the pixel indices (scatter, hole fill, floors) is the JAX arithmetic in
the JAX order. The pixel indices themselves are not bit-reproducible
across implementations: f32 cos/sin differ by ULPs between libraries, so
a point on a rounding boundary may land one pixel over.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch.utils.device import resolve_device

# points held at once by render_depth_batch's default pose chunk, which
# bounds its per-point temporaries: 83 poses at the CLI's 1e5 points
POINTS_PER_CHUNK = 1 << 23


class PlaneSpec(NamedTuple):
    perp: int        # out-of-plane axis index
    aligned: int     # axis mapped to image columns
    unaligned: int   # axis mapped to image rows (mirrored for the left finger)
    multiplier: int  # +1/-1: sign of the right finger's out-of-plane direction


def plane_spec(gelslim_plane: str) -> PlaneSpec:
    """Decode a plane string like '+y+z' (ref :85-151's case table)."""
    axes = [c for c in gelslim_plane if c.isalpha()]
    signs = [c for c in gelslim_plane if c in "+-"]
    if len(axes) != 2 or len(signs) != 2 or axes[0] == axes[1]:
        raise ValueError(f"Invalid gelslim_plane {gelslim_plane!r}")
    ax = {"x": 0, "y": 1, "z": 2}
    pair = frozenset(axes)
    same = signs[0] == signs[1]
    # (pair, first_axis) -> (aligned, unaligned, dir_if_same_signs)
    table = {
        (frozenset("xy"), "x"): (1, 0, +1),
        (frozenset("xy"), "y"): (0, 1, -1),
        (frozenset("xz"), "x"): (2, 0, -1),
        (frozenset("xz"), "z"): (0, 2, +1),
        (frozenset("yz"), "y"): (2, 1, +1),
        (frozenset("yz"), "z"): (1, 2, -1),
    }
    aligned, unaligned, dir_same = table[(pair, axes[0])]
    perp = 3 - ax[axes[0]] - ax[axes[1]]
    return PlaneSpec(perp, aligned, unaligned, dir_same if same else -dir_same)


def affine2d_points(
    pc: torch.Tensor, perp_axis: int, t1: torch.Tensor, t2: torch.Tensor, angle: torch.Tensor,
    invert: bool = False,
) -> torch.Tensor:
    """SE(2) on the two in-plane coordinates (ref affine2D_pc, :233-248).
    The in-plane axes are the sorted non-perp indices; translations are in
    the same units as pc. pc is (..., P, 3); t1, t2 and angle broadcast
    against its leading dims (scalars for one pose, (B, 1) for a batch)."""
    idx = [i for i in range(3) if i != perp_axis]
    c, s = torch.cos(angle), torch.sin(angle)
    if invert:
        # inverse of [[c,-s,t1],[s,c,t2]]: R^T, -R^T t
        t1, t2 = -(c * t1 + s * t2), -(-s * t1 + c * t2)
        s = -s
    u = pc[..., idx[0]]
    v = pc[..., idx[1]]
    nu = c * u - s * v + t1
    nv = s * u + c * v + t2
    shape = torch.broadcast_shapes(nu.shape, nv.shape)
    out = [pc[..., i].expand(shape) for i in range(3)]
    out[idx[0]], out[idx[1]] = nu.expand(shape), nv.expand(shape)
    return torch.stack(out, dim=-1)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum over the last two dims by two separable shifted sums,
    rows then columns, in the JAX package's order of additions."""
    xp = F.pad(x, (0, 0, 1, 1))
    xv = x + xp[..., :-2, :] + xp[..., 2:, :]
    xp = F.pad(xv, (1, 1))
    return xv + xp[..., :-2] + xp[..., 2:]


def _fill_holes(grid: torch.Tensor, fill_iters: int) -> torch.Tensor:
    """Iterative occupied-3x3-average hole fill of min-splat grids (..., H,
    W) (inf = unoccupied), synchronous over fill_iters steps; untouched
    pixels come out 0 (no contact)."""
    occ = torch.isfinite(grid)
    vals = torch.where(occ, grid, 0.0)
    for _ in range(fill_iters):
        occ_f = occ.to(torch.float32)
        ksum = _box3(vals * occ_f)
        kcnt = _box3(occ_f)
        neigh = ksum / torch.clamp(kcnt, min=1.0)
        newly = ~occ & (kcnt > 0)
        vals = torch.where(newly, neigh, vals)
        occ = occ | newly
    return torch.where(occ, vals, 0.0)


def _splat(
    pc: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, angle: torch.Tensor, width: torch.Tensor,
    spec: PlaneSpec, image_size: Tuple[int, int], mm_per_pixel: float, invert_affine: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b,) poses of one cloud (P, 3) -> the min-splat grids (b, 2, H, W),
    inf where no point landed, and each half-cloud's min depth (b, 2), the
    floor (0 for an empty half); channel order (right, left). Translations
    in meters."""
    h, w = image_size
    b = angle.shape[0]
    dev = pc.device
    m = float(spec.multiplier)

    # 1. center along the out-of-plane axis
    perp = pc[:, spec.perp]
    mid = 0.5 * (perp.max() + perp.min())
    pc = pc.clone()
    pc[:, spec.perp] -= mid

    # 2. SE(2) in-plane, every pose at once: (b, P, 3)
    col = lambda t: t[:, None]  # noqa: E731
    pc = affine2d_points(pc, spec.perp, col(t1 * 1000.0), col(t2 * 1000.0), col(angle), invert_affine)

    signed = m * pc[..., spec.perp]  # distance toward the right gel
    half = col(width / 2.0)

    # 3. per-finger penetration depth (<= 0); clamp-to-plane == max(..., 0) -> negated
    right_depth = -torch.clamp(signed - half, min=0.0)
    left_depth = -torch.clamp(-signed - half, min=0.0)
    right_valid = signed > 0
    left_valid = signed < 0
    inf = torch.tensor(float("inf"), device=dev)
    floors = torch.stack([torch.where(right_valid, right_depth, inf).amin(dim=1),
                          torch.where(left_valid, left_depth, inf).amin(dim=1)], dim=1)
    floors = torch.where(torch.isfinite(floors), floors, 0.0)

    # 5. project to pixels: rows <-> unaligned, cols <-> aligned. A divisor
    # on the device, not a Python float: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which rounds differently
    mmpp = torch.tensor(mm_per_pixel, dtype=torch.float32, device=dev)
    una = pc[..., spec.unaligned]
    cols = torch.round(pc[..., spec.aligned] / mmpp + w / 2.0).to(torch.int64)
    # 4. the left image mirrors the unaligned axis (ref :166)
    is_left = ~right_valid
    rows = torch.round(torch.where(is_left, -una, una) / mmpp + h / 2.0).to(torch.int64)
    depth = torch.where(is_left, left_depth, right_depth)
    valid = (right_valid | left_valid) & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)

    # the COMBINED splat: every point belongs to one finger, so both
    # fingers' grids of every pose are one flat scatter-min; out-of-range
    # and midplane points go to one dump slot past the end
    n_grid = b * 2 * h * w
    plane = torch.arange(b, device=dev)[:, None] * 2 + is_left.to(torch.int64)
    flat = torch.where(valid, (plane * h + rows) * w + cols, n_grid)
    grid = torch.full((n_grid + 1,), float("inf"), dtype=torch.float32, device=dev)
    grid.scatter_reduce_(0, flat.reshape(-1), depth.reshape(-1), reduce="amin", include_self=True)
    return grid[:n_grid].view(b, 2, h, w), floors


def _render_chunk(pc, t1, t2, angle, width, spec, image_size, mm_per_pixel, fill_iters, invert_affine):
    """_splat's grids hole-filled and floored: (b, 2, H, W), (right, left)."""
    grid, floors = _splat(pc, t1, t2, angle, width, spec, image_size, mm_per_pixel, invert_affine)
    return torch.maximum(_fill_holes(grid, fill_iters), floors[:, :, None, None])


def render_depth_pair(
    pc: torch.Tensor,             # (P, 3) mm, output of surface sampling * pc_scale
    translation1,                 # meters (x1000 inside, ref :156)
    translation2,
    angle,                        # radians
    inter_gelslim_distance,       # mm
    *,
    spec: PlaneSpec,
    image_size: Tuple[int, int] = (320, 427),
    mm_per_pixel: float = 12.0 / 320.0,
    fill_iters: int = 6,
    invert_affine: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sample's (right, left) contact-depth images, on pc's device."""
    pc = torch.as_tensor(pc, dtype=torch.float32)
    pose = [torch.as_tensor(v, dtype=torch.float32, device=pc.device).reshape(1)
            for v in (translation1, translation2, angle, inter_gelslim_distance)]
    out = _render_chunk(pc, *pose, spec, tuple(image_size), mm_per_pixel, fill_iters, invert_affine)
    return out[0, 0], out[0, 1]


def render_depth_batch(
    pc,                     # (P, 3) mm — one object's sampled surface
    poses,                  # (B, 3) in_hand_pose rows (t1, t2, angle), meters and radians
    widths,                 # (B,) grasp widths, mm
    *,
    spec: PlaneSpec,
    image_size: Tuple[int, int] = (320, 427),
    mm_per_pixel: float = 12.0 / 320.0,
    fill_iters: int = 6,
    invert_affine: bool = False,
    lr_flip: bool = False,
    pose_chunk: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """All samples of an object -> (B, 2, H, W) float32 on the device,
    channel order (left, right), or (right, left) when lr_flip (ref
    :73-76). Inputs are arrays or tensors, moved to `device` (``cuda``
    unless it says otherwise). Poses render pose_chunk at a time (default:
    POINTS_PER_CHUNK points' worth); any chunk gives the same output, bit
    for bit."""
    dev = resolve_device(device)
    pc = torch.as_tensor(pc, dtype=torch.float32).to(dev)
    poses = torch.as_tensor(poses, dtype=torch.float32).to(dev)
    widths = torch.as_tensor(widths, dtype=torch.float32).to(dev).reshape(-1)
    n = poses.shape[0]
    chunk = pose_chunk or max(1, POINTS_PER_CHUNK // max(1, pc.shape[0]))
    h, w = image_size
    out = torch.empty((n, 2, h, w), dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)
        out[sl] = _render_chunk(pc, poses[sl, 0], poses[sl, 1], poses[sl, 2], widths[sl], spec,
                                (h, w), mm_per_pixel, fill_iters, invert_affine)
    # the chunks render (right, left)
    return out if lr_flip else out.flip(1)
