"""Generate a self-contained demo workspace with the PyTorch port alone:
procedural STL meshes plus a reference-schema synthetic dataset tree, so the
port's pipeline (split -> generate-depth -> train -> test -> view) runs
without the real GelSlim dataset or the reference's shipped meshes.

The port's counterpart of ``scripts/make_demo_assets.py``: the same meshes,
the same seeded frames and the same text files (byte-equal STL and text,
``.pt`` files that load to the same arrays), written through the port's
``data.pt_io``, ``data.synthetic`` and ``meshgen.stl``. Imports torch,
numpy and scipy, never JAX or gelslim_depth_tpu.

Usage:
    python scripts/make_demo_assets_torch.py [workspace_dir]  # default ./demo
Then:
    export GELSLIM_DATA_PATH=<workspace_dir>/data
    python -m gelslim_depth_tpu_torch split-data cpu
    python -m gelslim_depth_tpu_torch generate-depth cpu --mesh_dir <workspace_dir>/mesh \
        --dataset_dir $GELSLIM_DATA_PATH/train_data --grasp_widths_file $GELSLIM_DATA_PATH/grasp_widths.txt
    python -m gelslim_depth_tpu_torch train demo --use_difference_image --max_epochs 20
"""

import argparse
import os
import sys

import numpy as np


def rod_mesh(length=0.030, radius=0.004, segments=24):
    """Capped cylinder along z, meters."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    lo, hi = -length / 2, length / 2
    tris = []
    for i in range(segments):
        a, b = ring[i], ring[(i + 1) % segments]
        p0, p1 = [a[0], a[1], lo], [b[0], b[1], lo]
        p2, p3 = [a[0], a[1], hi], [b[0], b[1], hi]
        tris += [[p0, p1, p2], [p1, p3, p2]]
        tris += [[[0, 0, lo], p1, p0], [[0, 0, hi], p2, p3]]
    return np.asarray(tris, np.float32)


def sphere_mesh(radius=0.008, n=600, seed=0):
    """The convex hull of n seeded points on a sphere, meters."""
    from scipy.spatial import ConvexHull

    rng = np.random.RandomState(seed)
    p = rng.normal(size=(n, 3))
    p = radius * p / np.linalg.norm(p, axis=1, keepdims=True)
    return p[ConvexHull(p).simplices].astype(np.float32)


def ridged_plate_mesh(size=0.020, n_ridges=3, ridge_h=0.004, thickness=0.010):
    """A plate with triangular ridges along x, a 'pattern'-like object;
    meters."""
    tris = []
    s = size / 2
    xs = np.linspace(-s, s, n_ridges * 2 + 1)
    top, base = thickness / 2 + ridge_h, thickness / 2
    for i in range(n_ridges):
        x0, x1, x2 = xs[2 * i], xs[2 * i + 1], xs[2 * i + 2]
        # two slanted faces a ridge, extruded along y as two triangles each
        for (xa, za), (xb, zb) in (((x0, base), (x1, top)), ((x1, top), (x2, base))):
            tris += [
                [[xa, -s, za], [xb, -s, zb], [xb, s, zb]],
                [[xa, -s, za], [xb, s, zb], [xa, s, za]],
            ]
    b = -thickness / 2  # slab bottom
    tris += [
        [[-s, -s, b], [s, -s, b], [s, s, b]],
        [[-s, -s, b], [s, s, b], [-s, s, b]],
    ]
    return np.asarray(tris, np.float32)


def make_workspace(root: str) -> None:
    from gelslim_depth_tpu_torch.data.pt_io import save_pt
    from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object
    from gelslim_depth_tpu_torch.meshgen.stl import save_stl_binary

    mesh_dir = os.path.join(root, "mesh")
    data_dir = os.path.join(root, "data")
    os.makedirs(mesh_dir, exist_ok=True)
    os.makedirs(os.path.join(data_dir, "real_data"), exist_ok=True)

    meshes = {"demo_rod": rod_mesh(), "demo_sphere": sphere_mesh(), "demo_pattern": ridged_plate_mesh()}
    for name, tri in meshes.items():
        save_stl_binary(os.path.join(mesh_dir, f"{name}.stl"), tri)
        print(f"wrote {mesh_dir}/{name}.stl ({len(tri)} triangles)")

    rng = np.random.RandomState(0)
    # grasp widths must be smaller than each object's extent along the
    # out-of-plane (x, for the default '+y+z' plane) axis or no contact is
    # rendered: rod x-extent 8 mm, sphere 16 mm, pattern plate 20 mm
    width_ranges = {"demo_rod": (5.5, 7.0), "demo_sphere": (11.0, 14.0), "demo_pattern": (16.0, 19.0)}
    for name in meshes:
        obj = make_synthetic_object(rng, n=24, image_size=(320, 427))
        del obj["depth_image"]  # generate-depth renders it from the meshes
        lo, hi = width_ranges[name]
        obj["grasp_widths"] = rng.uniform(lo, hi, (24,)).astype(np.float32)
        save_pt(obj, os.path.join(data_dir, f"{name}.pt"))
        print(f"wrote {data_dir}/{name}.pt (24 samples)")

    with open(os.path.join(data_dir, "grasp_widths.txt"), "w") as f:
        f.write("demo_rod: None\ndemo_sphere: None\ndemo_pattern: None\n")
    open(os.path.join(data_dir, "real_data", "train_real_objects.txt"), "w").close()
    print(f"demo workspace ready at {root}/ (see the module docstring for next steps)")


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workspace_dir", nargs="?", default="demo", help="output workspace (default ./demo)")
    make_workspace(p.parse_args().workspace_dir)


if __name__ == "__main__":
    main()
