"""The port's meshgen against the JAX package's, on the same seeded inputs:
STL IO, surface sampling and the hole fill bit for bit; the renderer, the
generator, the host C++ renderer and ``make_mesh_contact_object`` to the
bar the JAX package holds its two renderers to (tests/test_meshgen.py,
TestNativeRenderer): RMSE < 0.005 mm and fewer than 1e-4 of the pixels off
by more than 1e-4 mm. Pixel indices are not bit-reproducible across
implementations (f32 cos/sin differ by ULPs), so a point on a rounding
boundary may land one pixel over; everything after the indices matches
exactly."""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gelslim_depth_tpu.data import synthetic as jax_synthetic
from gelslim_depth_tpu.data.pt_io import load_pt as jax_load_pt
from gelslim_depth_tpu.meshgen import depth_render as jdr, generator as jgen, sample as jsample, stl as jstl
from gelslim_depth_tpu_torch.data import synthetic as port_synthetic
from gelslim_depth_tpu_torch.data.pt_io import save_pt
from gelslim_depth_tpu_torch.meshgen import depth_render as tdr, fixtures, generator as tgen, sample as tsample
from gelslim_depth_tpu_torch.meshgen import stl as tstl

# by path: on a machine where another installed package owns the name
# `tests`, `from tests.torch_port_helpers import ...` finds that one
_spec = importlib.util.spec_from_file_location(
    "torch_port_helpers", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_helpers.py"))
_helpers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_helpers)
torch_threads = _helpers.torch_threads

FRAME = (320, 427)
MMPP = 12.0 / 320.0


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def sphere_triangles(radius=8.0, n=3000, seed=3):
    from scipy.spatial import ConvexHull

    rng = np.random.RandomState(seed)
    p = rng.normal(size=(n, 3))
    p = radius * p / np.linalg.norm(p, axis=1, keepdims=True)
    return p[ConvexHull(p).simplices].astype(np.float32)


MESHES = {
    "sphere": sphere_triangles,
    "ridged": lambda: fixtures.heightfield_plate_triangles(fixtures.ridged_height_fn()),
}


def contact_poses(rng, pts, n, perp=0):
    """n poses within +-2 mm (meters) at any angle, and widths that press
    0.3-1.5 mm into the cloud."""
    t = 0.002
    poses = np.stack([rng.uniform(-t, t, n), rng.uniform(-t, t, n), rng.uniform(0, 2 * np.pi, n)], 1)
    extent = pts[:, perp].max() - pts[:, perp].min()
    widths = extent - 2 * rng.uniform(0.3, 1.5, n)
    return poses.astype(np.float32), widths.astype(np.float32)


def assert_depth_bar(got, want):
    """The JAX package's bar between two renderers."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.max() <= 1e-6
    diff = np.abs(got - want)
    assert float(np.sqrt((diff ** 2).mean())) < 0.005
    assert (diff > 1e-4).mean() < 1e-4


def test_stl_both_ways_bit_for_bit(tmp_path):
    tri = MESHES["ridged"]()
    jp, tp = str(tmp_path / "j.stl"), str(tmp_path / "t.stl")
    jstl.save_stl_binary(jp, tri)
    tstl.save_stl_binary(tp, tri)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    want = jstl.load_stl(jp)
    for path in (jp, tp):
        got = tstl.load_stl(path)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    # ascii
    lines = ["solid plate"]
    for t in tri[:50]:
        lines.append(" facet normal 0 0 0\n  outer loop")
        lines += [f"   vertex {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}" for v in t]
        lines.append("  endloop\n endfacet")
    ap = tmp_path / "a.stl"
    ap.write_text("\n".join(lines + ["endsolid plate"]))
    assert np.array_equal(tstl.load_stl(str(ap)), jstl.load_stl(str(ap)))


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_surface_points_bit_equal(seed):
    for make in MESHES.values():
        tri = make()
        got = tsample.sample_surface_points(tri, 20_000, seed=seed)
        want = jsample.sample_surface_points(tri, 20_000, seed=seed)
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_plane_spec_all_strings():
    planes = [f"{s1}{a}{s2}{b}" for a in "xyz" for b in "xyz" if a != b for s1 in "+-" for s2 in "+-"]
    planes += [f"{a}{s1}{b}{s2}" for a in "xyz" for b in "xyz" if a != b for s1 in "+-" for s2 in "+-"]
    assert len(planes) == 48
    for plane in planes:
        assert tuple(tdr.plane_spec(plane)) == tuple(jdr.plane_spec(plane)), plane
    for bad in ("+x+x", "+y", "y+z", "+x+y+z"):
        with pytest.raises(ValueError):
            jdr.plane_spec(bad)
        with pytest.raises(ValueError):
            tdr.plane_spec(bad)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("perp", [0, 1, 2])
def test_affine2d_points(perp, invert):
    rng = np.random.RandomState(perp)
    pc = rng.uniform(-8, 8, (500, 3)).astype(np.float32)
    t1, t2, ang = (np.float32(v) for v in (1.3, -0.7, 2.1))
    want = np.asarray(jdr.affine2d_points(jnp.asarray(pc), perp, t1, t2, ang, invert))
    got = tdr.affine2d_points(torch.from_numpy(pc), perp, *(torch.tensor(v) for v in (t1, t2, ang)), invert)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # a batch of poses broadcasts against the cloud
    got_b = tdr.affine2d_points(torch.from_numpy(pc), perp, torch.tensor([[t1], [0.0]]),
                                torch.tensor([[t2], [0.0]]), torch.tensor([[ang], [0.0]]), invert)
    assert got_b.shape == (2, 500, 3)
    assert torch.equal(got_b[0], got) and torch.equal(got_b[1], torch.from_numpy(pc))


@pytest.mark.parametrize("occupancy", [0.02, 0.3])
def test_fill_holes_bit_equal(occupancy):
    rng = np.random.RandomState(11)
    grids = np.where(rng.uniform(size=(3, 2, 41, 53)) < occupancy,
                     -rng.uniform(0, 2, (3, 2, 41, 53)), np.inf).astype(np.float32)
    got = tdr._fill_holes(torch.from_numpy(grids), 6).numpy()
    for i in range(3):
        for f in range(2):
            want = np.asarray(jdr._fill_holes(jnp.asarray(grids[i, f]), 6))
            assert np.array_equal(got[i, f], want)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("lr_flip", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_render_depth_batch_vs_jax(mesh, lr_flip, invert):
    pts = jsample.sample_surface_points(MESHES[mesh](), 60_000, seed=4)
    poses, widths = contact_poses(np.random.RandomState(3), pts, 6)
    kw = dict(image_size=FRAME, mm_per_pixel=MMPP, fill_iters=6, invert_affine=invert, lr_flip=lr_flip)
    want = np.asarray(jdr.render_depth_batch(jnp.asarray(pts), jnp.asarray(poses), jnp.asarray(widths),
                                             spec=jdr.plane_spec("+y+z"), **kw))
    got = tdr.render_depth_batch(pts, poses, widths, spec=tdr.plane_spec("+y+z"), device="cpu", **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert want.min() < -0.3  # the poses press into the mesh
    assert_depth_bar(got.numpy(), want)


def test_render_depth_pair_vs_jax():
    pts = jsample.sample_surface_points(MESHES["ridged"](), 40_000, seed=2)
    poses, widths = contact_poses(np.random.RandomState(5), pts, 2)
    for pose, width in zip(poses, widths):
        kw = dict(image_size=FRAME, mm_per_pixel=MMPP, fill_iters=6)
        want = jdr.render_depth_pair(jnp.asarray(pts), *pose, width, spec=jdr.plane_spec("+y+z"), **kw)
        got = tdr.render_depth_pair(torch.from_numpy(pts), *pose, width, spec=tdr.plane_spec("+y+z"), **kw)
        for g, w in zip(got, want):
            assert g.shape == FRAME
            assert_depth_bar(g.numpy(), w)


def test_pose_chunks_bit_equal():
    pts = jsample.sample_surface_points(MESHES["sphere"](), 30_000, seed=6)
    poses, widths = contact_poses(np.random.RandomState(8), pts, 5)
    kw = dict(spec=tdr.plane_spec("-z+x"), image_size=(96, 128), mm_per_pixel=0.2, device="cpu")
    whole = tdr.render_depth_batch(pts, poses, widths, pose_chunk=5, **kw)
    assert whole.min() < -0.3
    for chunk in (1, 2, None):
        assert torch.equal(tdr.render_depth_batch(pts, poses, widths, pose_chunk=chunk, **kw), whole)


def _generator_dataset(root):
    """Two objects in meters: one with per-sample widths in its .pt, one
    with a fixed width in the widths file."""
    rng = np.random.RandomState(0)
    mesh_dir, data_dir = root / "mesh", root / "data"
    os.makedirs(mesh_dir)
    os.makedirs(data_dir)
    tri = MESHES["ridged"]()
    jstl.save_stl_binary(str(mesh_dir / "plate_a.stl"), tri / 1000.0)
    jstl.save_stl_binary(str(mesh_dir / "plate_b.stl"), sphere_triangles(7.0) / 1000.0)
    for name, n in (("plate_a", 4), ("plate_b", 3)):
        poses = np.stack([rng.uniform(-0.002, 0.002, n), rng.uniform(-0.002, 0.002, n),
                          rng.uniform(0, 2 * np.pi, n)], 1).astype(np.float32)
        save_pt({"tactile_image": np.zeros((n, 6, 8, 11), np.float32), "in_hand_pose": poses,
                 "grasp_widths": rng.uniform(11.0, 12.5, n).astype(np.float32)},
                str(data_dir / f"{name}_train.pt"))
    (root / "gw.txt").write_text("plate_a: None\nplate_b: 12.5\n")
    return mesh_dir, data_dir


def test_generator_vs_jax(tmp_path):
    mesh_dir, data_dir = _generator_dataset(tmp_path)
    jax_dir = tmp_path / "data_jax"
    shutil.copytree(data_dir, jax_dir)
    kw = dict(mesh_dir=str(mesh_dir), object_list=None, pc_scale=1000,
              grasp_widths_file=str(tmp_path / "gw.txt"), image_size=FRAME,
              grasp_width_offset=0.25, pc_sampling=50_000)
    jgen.DepthImageGenerator(dataset_dir=str(jax_dir), backend="jax", **kw).generate_depth_images_v1()
    gen = tgen.DepthImageGenerator(dataset_dir=str(data_dir), device="cpu", **kw)
    assert gen.backend == "torch"
    gen.generate_depth_images_v1()
    for name in ("plate_a_train.pt", "plate_b_train.pt"):
        got = jax_load_pt(str(data_dir / name))  # the JAX package reads the port's .pt
        want = jax_load_pt(str(jax_dir / name))
        assert got["depth_image"].dtype == np.float32 and want["depth_image"].min() < -0.3
        assert_depth_bar(got["depth_image"], want["depth_image"])
        for key in ("tactile_image", "in_hand_pose", "grasp_widths"):
            assert np.array_equal(got[key], want[key])


def test_native_vs_jax():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host renderer")
    from gelslim_depth_tpu_torch.meshgen.native_render import render_depth_batch_native

    pts = jsample.sample_surface_points(MESHES["ridged"](), 60_000, seed=4)
    poses, widths = contact_poses(np.random.RandomState(3), pts, 6)
    for lr_flip in (False, True):
        kw = dict(image_size=FRAME, mm_per_pixel=MMPP, fill_iters=6, lr_flip=lr_flip)
        want = np.asarray(jdr.render_depth_batch(jnp.asarray(pts), jnp.asarray(poses), jnp.asarray(widths),
                                                 spec=jdr.plane_spec("+y+z"), **kw))
        got = render_depth_batch_native(pts, poses, widths, spec=tdr.plane_spec("+y+z"), n_threads=2, **kw)
        assert got.dtype == np.float32
        assert_depth_bar(got, want)


def test_native_renderer_available_matches_jax():
    from gelslim_depth_tpu.meshgen.native_render import native_renderer_available as jax_available
    from gelslim_depth_tpu_torch.meshgen.native_render import native_renderer_available

    got = native_renderer_available()
    assert isinstance(got, bool) and got == jax_available()


def test_native_renderer_available_is_false_when_the_build_fails(monkeypatch):
    """The probe says False; _lib() still raises for its callers."""
    from gelslim_depth_tpu_torch.meshgen import native_render
    from gelslim_depth_tpu_torch.ops.kernels import build

    def no_compiler(name):
        raise RuntimeError(f"failed to build {name}")

    monkeypatch.setattr(build, "load_library", no_compiler)
    native_render._lib.cache_clear()
    try:
        assert native_render.native_renderer_available() is False
        with pytest.raises(RuntimeError, match="failed to build"):
            native_render._lib()
    finally:
        native_render._lib.cache_clear()


def test_native_backend_raises_without_its_library(tmp_path, monkeypatch):
    """A native renderer that cannot be built raises; nothing falls back."""
    from gelslim_depth_tpu_torch.meshgen import native_render
    from gelslim_depth_tpu_torch.ops.kernels import build

    def no_compiler(name):
        raise RuntimeError(f"failed to build {name}")

    monkeypatch.setattr(build, "load_library", no_compiler)
    native_render._lib.cache_clear()
    try:
        mesh_dir, data_dir = _generator_dataset(tmp_path)
        gen = tgen.DepthImageGenerator(str(mesh_dir), None, 1000, str(data_dir), str(tmp_path / "gw.txt"),
                                       image_size=(16, 21), pc_sampling=2000, backend="native")
        with pytest.raises(RuntimeError, match="failed to build"):
            gen.generate_depth_images_v1()
    finally:
        native_render._lib.cache_clear()


def test_no_quiet_cpu_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.render_depth_batch(pts, np.zeros((1, 3), np.float32), np.ones(1, np.float32),
                               spec=tdr.plane_spec("+y+z"))
    mesh_dir, data_dir = _generator_dataset(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.DepthImageGenerator(str(mesh_dir), None, 1000, str(data_dir), str(tmp_path / "gw.txt"))
    with pytest.raises(ValueError, match="backend"):
        tgen.DepthImageGenerator(str(mesh_dir), None, 1000, str(data_dir), str(tmp_path / "gw.txt"),
                                 device="cpu", backend="jax")


def test_make_mesh_contact_object_vs_jax(tmp_path):
    path = str(tmp_path / "plate.stl")
    tstl.save_stl_binary(path, MESHES["ridged"]())
    kw = dict(n=5, pc_scale=1.0, image_size=(96, 128), n_points=30_000)
    want = jax_synthetic.make_mesh_contact_object(np.random.RandomState(9), path, **kw)
    got = port_synthetic.make_mesh_contact_object(np.random.RandomState(9), path, device="cpu", **kw)
    assert set(got) == set(want)
    for key in ("in_hand_pose", "grasp_widths", "base_tactile_image"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert want["depth_image"].min() < -0.3
    assert_depth_bar(got["depth_image"], want["depth_image"])
    # the same draws: the tactile response agrees wherever the depth does
    same = np.repeat(got["depth_image"] == want["depth_image"], 3, axis=1)
    assert same.mean() > 0.999
    assert np.array_equal(got["tactile_image"][same], want["tactile_image"][same])


@pytest.mark.cuda
def test_card_vs_cpu_render():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for mesh in sorted(MESHES):
        pts = jsample.sample_surface_points(MESHES[mesh](), 100_000, seed=4)
        poses, widths = contact_poses(np.random.RandomState(3), pts, 16)
        for lr_flip in (False, True):
            kw = dict(spec=tdr.plane_spec("+y+z"), image_size=FRAME, mm_per_pixel=MMPP, lr_flip=lr_flip)
            got = tdr.render_depth_batch(pts, poses, widths, device="cuda", **kw)
            assert got.device.type == "cuda"
            want = tdr.render_depth_batch(pts, poses, widths, device="cpu", **kw)
            assert_depth_bar(got.cpu().numpy(), want.numpy())
