"""Area-weighted uniform surface sampling (Open3D sample_points_uniformly
equivalent, ref depth_from_mesh.py:56-57), vectorized in numpy: pick faces
~ Categorical(face areas), then uniform barycentric points. The port's copy
of ``gelslim_depth_tpu/meshgen/sample.py``: the same seed gives the same
points, bit for bit.
"""

from __future__ import annotations

import numpy as np


def sample_surface_points(
    triangles: np.ndarray, n_points: int, *, seed: int = 0
) -> np.ndarray:
    """(T, 3, 3) triangle vertices -> (n_points, 3) uniform surface samples."""
    tri = np.asarray(triangles, np.float64)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero total surface area")
    rng = np.random.RandomState(seed)
    face_idx = rng.choice(len(areas), size=n_points, p=areas / total)
    # uniform barycentric via sqrt trick
    r1 = np.sqrt(rng.uniform(size=(n_points, 1)))
    r2 = rng.uniform(size=(n_points, 1))
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    t = tri[face_idx]
    pts = a * t[:, 0] + b * t[:, 1] + c * t[:, 2]
    return pts.astype(np.float32)
