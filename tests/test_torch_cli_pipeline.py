"""The port's whole data-prep and training pipeline through its CLI on the
CPU: split-data -> generate-depth -> train -> test -> view, on a small
synthetic tree beside the JAX package's CLI on a copy of it. The split
files equal the JAX CLI's byte for byte; the rendered depth meets the bar
the JAX package holds its two renderers to (RMSE < 0.005 mm, fewer than
1e-4 of the pixels off by more than 1e-4 mm)."""

import os
import re
import shutil

import numpy as np
import pytest

from gelslim_depth_tpu.cli import main as jax_cli
from gelslim_depth_tpu.data.pt_io import load_pt as jax_load_pt
from gelslim_depth_tpu_torch.cli import main as cli
from gelslim_depth_tpu_torch.data.pt_io import save_pt
from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object, write_synthetic_dataset_tree
from gelslim_depth_tpu_torch.meshgen import fixtures, save_stl_binary
from tests.torch_port_helpers import torch_threads

SUBDIRS = ("train_data", "validation_data", "test_data")
IMAGE = ("32", "43")


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _loose_tree(root):
    """Two objects' loose .pt files without depth, their meshes in meters
    (ridged plates 13.4 mm thick), and a widths file: one object fixed,
    one per sample."""
    data, mesh = root / "data", root / "mesh"
    os.makedirs(data)
    os.makedirs(mesh)
    rng = np.random.RandomState(0)
    plate = fixtures.heightfield_plate_triangles(fixtures.ridged_height_fn(), grid=(48, 60)) / 1000.0
    for name in ("plateA", "plateB"):
        obj = make_synthetic_object(rng, n=10, image_size=(32, 43))
        del obj["depth_image"]  # generate-depth renders it
        obj["grasp_widths"] = rng.uniform(11.0, 12.5, 10).astype(np.float32)
        save_pt(obj, str(data / f"{name}.pt"))
        save_stl_binary(str(mesh / f"{name}.stl"), plate)
    (data / "grasp_widths.txt").write_text("plateA: 12.0\nplateB: None\n")
    os.makedirs(data / "real_data")
    (data / "real_data" / "train_real_objects.txt").write_text("")
    return data, mesh


def _generate_depth(main, data, mesh, *gpu):
    for sub in SUBDIRS:
        assert main([
            "generate-depth", *gpu, "--mesh_dir", str(mesh), "--dataset_dir", os.path.join(data, sub),
            "--grasp_widths_file", os.path.join(data, "grasp_widths.txt"),
            "--image_size", *IMAGE, "--pc_sampling", "20000", "--grasp_width_offset", "0.25",
        ]) == 0


def test_full_pipeline_vs_jax_cli(tmp_path, monkeypatch):
    data, mesh = _loose_tree(tmp_path)
    jax_data = tmp_path / "data_jax"
    shutil.copytree(data, jax_data)
    monkeypatch.chdir(tmp_path)

    # 1. split: the same files as the JAX CLI's, byte for byte
    assert cli(["split-data", "cpu", "--data_path", str(data)]) == 0
    assert jax_cli(["split-data", "cpu", "--data_path", str(jax_data)]) == 0
    assert not os.path.exists(data / "plateA.pt")
    for sub in SUBDIRS:
        names = sorted(os.listdir(data / sub))
        assert names == sorted(os.listdir(jax_data / sub)) and len(names) == 2
        for name in names:
            assert (data / sub / name).read_bytes() == (jax_data / sub / name).read_bytes(), name

    # 2. depth: the port's renderer on the CPU against the JAX CLI's
    _generate_depth(cli, str(data), mesh, "cpu")
    _generate_depth(jax_cli, str(jax_data), mesh)
    for sub in SUBDIRS:
        for name in os.listdir(data / sub):
            got = jax_load_pt(str(data / sub / name))
            want = jax_load_pt(str(jax_data / sub / name))
            assert got["depth_image"].shape == want["depth_image"].shape == (len(got["tactile_image"]), 2, 32, 43)
            diff = np.abs(got["depth_image"] - want["depth_image"])
            assert float(np.sqrt((diff ** 2).mean())) < 0.005 and (diff > 1e-4).mean() < 1e-4
            if sub == "train_data":
                assert want["depth_image"].min() < -0.3  # the grasps press into the plates
            for key in ("tactile_image", "base_tactile_image", "in_hand_pose", "grasp_widths"):
                assert np.array_equal(got[key], want[key])

    # 3. train two epochs, then fine-tune one from its weights
    common = ["--data_path", str(data), "--use_difference_image", "--dims", "8", "16",
              "--batch_size", "8", "--downsample_factor", "0.25"]
    assert cli(["train", "pipe", "cpu", "--max_epochs", "2", *common]) == 0
    wdir = tmp_path / "train_output" / "weights"
    for f in ("pipe.npz", "pipe.json", "config_pipe.py", "train_state.npz"):
        assert (wdir / f).exists(), f
    assert cli(["train", "pipe_ft", "cpu", "--max_epochs", "1", "--starting_weights", "pipe", *common]) == 0
    assert (wdir / "pipe_ft.npz").exists()

    # 4. the test harness on the trained weights
    assert cli(["test", "pipe", "cpu", "test_data", "--data_path", str(data), "--weights_dir", str(wdir)]) == 0
    assert (tmp_path / "test_output" / "depth_predictions.png").exists()

    # 5. the viewer
    assert cli(["view", "train_data", "plateA", "--data_path", str(data)]) == 0
    assert (tmp_path / "pt_images" / "plateA.png").exists()


def test_train_channels_last(tmp_path, monkeypatch):
    """train --channels_last bakes every split NHWC and trains NHWC: rc 0,
    and the same epoch losses as the NCHW run (the jax package's NHWC bar,
    tests/test_trainer.py:324-329)."""
    write_synthetic_dataset_tree(str(tmp_path / "data"), n_per_object=4, image_size=(32, 43), seed=3)
    monkeypatch.chdir(tmp_path)
    losses = {}
    for flag in ([], ["--channels_last"]):
        out = tmp_path / f"out{len(flag)}"
        assert cli(["train", "nhwc", "cpu", "--data_path", str(tmp_path / "data"), "--output_dir", str(out),
                    "--use_difference_image", "--dims", "8", "16", "--batch_size", "4", "--max_epochs", "2",
                    *flag]) == 0
        lines = (out / "loss_values" / "nhwc.txt").read_text().splitlines()
        losses[bool(flag)] = [[float(v) for v in re.findall(r"loss: ([0-9.]+)", ln)] for ln in lines
                              if ln.startswith("Train loss")]
    assert len(losses[True]) == 2
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5, atol=1e-7)
