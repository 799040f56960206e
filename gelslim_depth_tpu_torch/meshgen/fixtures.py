"""Procedural NON-CONVEX test/demo meshes for the GT generator, the port's
copy of ``gelslim_depth_tpu/meshgen/fixtures.py`` (the same triangles).

The reference ships 34 real object STLs (ref mesh/*.stl) whose contact
faces are patterned plates — ridges, pockets, bumps, concavities. Those
binaries are not redistributable here, so this module builds the same
*shape class* procedurally:

- heightfield_plate_triangles: a manifold double-sided relief plate — both
  out-of-plane faces are heightfields base_half + h(u, v), triangulated
  over a grid and stitched with side walls. Every (u, v) has exactly one
  surface point per face, so the reference's Delaunay interpolation is
  well-posed on it.
- overhang_ridge_triangles: an extruded T-profile ridge whose cap
  overhangs its stem — a TRUE front/back double sheet over the overhang
  footprint. There the reference's 2-D Delaunay mixes the two sheets
  arbitrarily (ref depth_from_mesh.py:189-190 interpolates a 2-D scatter
  that contains both), while the min-splat rasterizer deterministically
  keeps the deepest penetration — the surface the gel physically touches.

Axis convention matches gelslim_plane='+y+z': axis 0 (x) is out-of-plane,
(u, v) = (y, z) are the in-plane axes. Units are mm (feed to the renderer
directly, pc_scale=1).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def _grid_faces(nu: int, nv: int) -> np.ndarray:
    """Two triangles per cell of an (nu x nv)-vertex grid -> (F, 3) vertex
    index triples (indices into the row-major flattened grid)."""
    iu, iv = np.meshgrid(np.arange(nu - 1), np.arange(nv - 1), indexing="ij")
    a = (iu * nv + iv).ravel()
    b = a + nv
    faces = np.concatenate(
        [np.stack([a, b, a + 1], 1), np.stack([a + 1, b, b + 1], 1)], 0
    )
    return faces


def heightfield_plate_triangles(
    height_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    extent: Tuple[float, float] = (14.0, 18.0),
    base_half: float = 5.3,
    grid: Tuple[int, int] = (96, 120),
) -> np.ndarray:
    """Manifold double-sided relief plate -> (T, 3, 3) float32 triangles.

    Both out-of-plane faces sit at +-(base_half + h(u, v)) with
    h = height_fn(u, v) >= 0 evaluated on a grid over
    [-extent0/2, extent0/2] x [-extent1/2, extent1/2]; side walls stitch
    the two boundary rings. The relief is mirrored, so both fingers see
    the same pattern (like a grasped patterned plate)."""
    eu, ev = extent
    nu, nv = grid
    u = np.linspace(-eu / 2, eu / 2, nu, dtype=np.float32)
    v = np.linspace(-ev / 2, ev / 2, nv, dtype=np.float32)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    h = np.asarray(height_fn(uu, vv), np.float32)
    if (h < 0).any():
        raise ValueError("height_fn must be non-negative (relief above the base)")
    x = base_half + h

    top = np.stack([x, uu, vv], axis=-1).reshape(-1, 3)
    bot = np.stack([-x, uu, vv], axis=-1).reshape(-1, 3)
    faces = _grid_faces(nu, nv)
    tris = [top[faces], bot[faces][:, ::-1]]  # bottom flipped for orientation

    # side walls: connect matching boundary vertices of the two faces
    idx = np.arange(nu * nv).reshape(nu, nv)
    boundary = np.concatenate(
        [idx[0, :], idx[1:, -1], idx[-1, -2::-1], idx[-2::-1, 0]]
    )
    for a, b in zip(boundary, np.roll(boundary, -1)):
        tris.append(
            np.asarray(
                [[top[a], top[b], bot[b]], [top[a], bot[b], bot[a]]], np.float32
            )
        )
    return np.concatenate(tris).astype(np.float32)


# -- ready-made relief patterns (the reference's object classes) -------------

def ridged_height_fn(n_ridges: int = 3, ridge_h: float = 1.4, ridge_w: float = 2.2,
                     extent_u: float = 14.0):
    """Flat-topped ridges running along v, with smooth (cosine) shoulders —
    the 'pattern_*' object class."""
    centers = np.linspace(-extent_u / 2, extent_u / 2, n_ridges + 2)[1:-1]

    def h(u, v):
        out = np.zeros_like(u)
        for c in centers:
            d = np.abs(u - c)
            flat = ridge_w / 2
            shoulder = 0.8
            prof = np.where(
                d <= flat, 1.0,
                np.where(d <= flat + shoulder,
                         0.5 * (1 + np.cos(np.pi * (d - flat) / shoulder)), 0.0),
            )
            out = np.maximum(out, ridge_h * prof)
        return out

    return h


def pocket_height_fn(plateau_h: float = 1.2, pockets=((-3.0, -4.0, 2.2), (2.5, 3.5, 3.0))):
    """A raised plateau with smooth circular pockets (concavities) sunk into
    it — pockets as (center_u, center_v, radius)."""

    def h(u, v):
        out = np.full_like(u, plateau_h)
        for cu, cv, r in pockets:
            d = np.sqrt((u - cu) ** 2 + (v - cv) ** 2)
            w = 1.2  # shoulder width
            depth = np.where(
                d <= r, 1.0,
                np.where(d <= r + w, 0.5 * (1 + np.cos(np.pi * (d - r) / w)), 0.0),
            )
            out = np.minimum(out, plateau_h * (1.0 - depth))
        return out

    return h


def bumps_height_fn(n: int = 5, amp: float = 1.5, sigma: float = 1.6, seed: int = 0,
                    extent: Tuple[float, float] = (14.0, 18.0)):
    """Random smooth Gaussian bumps (the 'hemisphere/stud' class)."""
    rng = np.random.RandomState(seed)
    cus = rng.uniform(-extent[0] / 2 + 2, extent[0] / 2 - 2, n)
    cvs = rng.uniform(-extent[1] / 2 + 2, extent[1] / 2 - 2, n)
    amps = rng.uniform(0.5, 1.0, n) * amp

    def h(u, v):
        out = np.zeros_like(u)
        for cu, cv, a in zip(cus, cvs, amps):
            out = np.maximum(out, a * np.exp(-((u - cu) ** 2 + (v - cv) ** 2) / (2 * sigma**2)))
        return out

    return h


def overhang_ridge_triangles(
    slab_half: float = 5.0,
    stem_w: float = 1.6,
    cap_w: float = 4.2,
    stem_h: float = 1.2,
    cap_h: float = 1.0,
    length: float = 14.0,
    slab_extent: float = 12.0,
    n_seg: int = 80,
) -> np.ndarray:
    """Extruded T-profile: slab face with a T ridge whose cap overhangs the
    stem on both sides — a genuine two-sheet region (cap top above slab
    face) over the overhang ring. Mirrored on both out-of-plane faces.
    Returns (T, 3, 3) float32 triangles; extrusion runs along axis 2 (z)."""

    def profile(side: float) -> np.ndarray:
        """(P, 2) polyline of (x, u) pairs walked left -> right across one
        face (side = +1 top face, -1 bottom)."""
        s, sw, cw = slab_half, stem_w / 2, cap_w / 2
        x0, x1, x2 = s, s + stem_h, s + stem_h + cap_h
        pts = [
            (x0, -slab_extent / 2),
            (x0, -sw), (x1, -sw),          # slab -> up the stem's left wall
            (x1, -cw), (x2, -cw),          # out under the cap (OVERHANG), up
            (x2, cw), (x1, cw),            # across the cap top, down
            (x1, sw), (x0, sw),            # back under the cap, down the stem
            (x0, slab_extent / 2),
        ]
        return np.asarray([(side * x, u) for x, u in pts], np.float32)

    zs = np.linspace(-length / 2, length / 2, n_seg, dtype=np.float32)
    tris = []
    for side in (1.0, -1.0):
        prof = profile(side)
        # vertices: (P, n_seg, 3)
        verts = np.stack(
            [
                np.repeat(prof[:, 0:1], n_seg, 1),
                np.repeat(prof[:, 1:2], n_seg, 1),
                np.broadcast_to(zs, (len(prof), n_seg)),
            ],
            axis=-1,
        )
        for p in range(len(prof) - 1):
            a, b = verts[p], verts[p + 1]
            for k in range(n_seg - 1):
                tris.append([a[k], b[k], b[k + 1]])
                tris.append([a[k], b[k + 1], a[k + 1]])
    return np.asarray(tris, np.float32)
