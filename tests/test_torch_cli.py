"""The port's serving commands (``python -m gelslim_depth_tpu_torch``) on
synthetic data, run on the CPU through the reference's ``gpu`` positional:
the ``test`` harness on a reference config .py + torch .pth, ``quantize``
on a checkpoint the JAX package wrote (the same activation scales as the
JAX command, rtol 1e-6), ``export --check``, and the refusals. Mirrors
tests/test_cli.py.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gelslim_depth_tpu.cli import main as jax_cli_main
from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.train.checkpoint import save_weights as jax_save_weights
from gelslim_depth_tpu_torch.cli import main as cli_main
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.data.pt_io import save_pt
from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object
from gelslim_depth_tpu_torch.export import ExportedPredictor
from gelslim_depth_tpu_torch.inference import QuantizedPredictor
from gelslim_depth_tpu_torch.utils.device import device_from_gpu_arg

_spec = importlib.util.spec_from_file_location(
    "torch_fixture", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixture.py"))
_fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixture)

CFG_KW = dict(
    CNN_dimensions=(4, 8),
    input_tactile_image_size=(16, 21),
    image_normalization_method="0_255_to_0_1",
    depth_normalization_method="min_max_to_0_-1",
    depth_normalization_parameters=(-1.9, 0.0),
    norm_scale=0.9,
    use_difference_image=True,
)


def _has_matplotlib():
    return importlib.util.find_spec("matplotlib") is not None


def _jax_checkpoint(wdir, name):
    """A checkpoint in the JAX package's format, written by the JAX package."""
    cfg = JaxConfig(weights_name=name, **CFG_KW)
    sd = _fixture.make_state_dict(np.random.RandomState(0), CFG_KW["CNN_dimensions"])
    params, stats = import_torch_state_dict(sd, cfg.unet_config())
    jax_save_weights(wdir, cfg, params, stats, emit_torch_pth=False)


def _dataset(root, sub, *, base=True, n=6, size=(32, 43)):
    data = root / "data" / sub
    os.makedirs(data)
    obj = make_synthetic_object(np.random.RandomState(0), n=n, image_size=size)
    if not base:
        del obj["base_tactile_image"]
    save_pt(obj, str(data / f"obj_{sub}.pt"))
    return str(root / "data")


def test_cli_reference_artifact_migration(tmp_path, monkeypatch):
    """test on a reference-style config .py + torch .pth: the migration path
    for reference users, no conversion step."""
    monkeypatch.chdir(tmp_path)
    dims = (4, 8)
    cfg = GelslimConfig(
        weights_name="mig", CNN_dimensions=dims, input_tactile_image_size=(8, 11),
        depth_normalization_parameters=(-1.9, 0.0), use_difference_image=True,
        image_normalization_method="0_255_to_0_1", norm_scale=0.9,
    )
    cfg.emit_python_config(str(tmp_path / "config_mig.py"))
    sd = _fixture.make_state_dict(np.random.RandomState(0), dims)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "mig.pth"))
    data = _dataset(tmp_path, "test_data", size=(16, 22))

    assert cli_main([
        "test", "mig", "cpu", "test_data", "--data_path", data,
        "--config_module", str(tmp_path / "config_mig.py"), "--torch_pth", str(tmp_path / "mig.pth"),
    ]) == 0
    assert os.path.exists(tmp_path / "test_output" / "depth_predictions.png") == _has_matplotlib()


def test_cli_quantize_command(tmp_path, monkeypatch, capsys):
    """quantize: a JAX-written checkpoint + a dataset dir in, <name>_int8.npz
    out, loadable by QuantizedPredictor.from_checkpoint; its activation
    scales are the JAX command's on the same files; test --int8 reads it."""
    monkeypatch.chdir(tmp_path)
    wdir, jwdir = str(tmp_path / "weights"), str(tmp_path / "jax_weights")
    _jax_checkpoint(wdir, "qcli")
    _jax_checkpoint(jwdir, "qcli")
    data = _dataset(tmp_path, "train_data")

    assert cli_main(["quantize", "qcli", "cpu", "--weights_dir", wdir, "--data_path", data,
                     "--calib_frames", "4"]) == 0
    assert "calibration delta vs float graph" in capsys.readouterr().out
    assert os.path.exists(os.path.join(wdir, "qcli_int8.npz"))
    qpred = QuantizedPredictor.from_checkpoint(wdir, device="cpu")
    assert qpred.delta_mm < 0.05

    assert jax_cli_main(["quantize", "qcli", "cpu", "--weights_dir", jwdir, "--data_path", data,
                         "--calib_frames", "4"]) == 0
    jq = QuantizedPredictor.from_checkpoint(jwdir, device="cpu")
    ours, theirs = qpred.q.act_scales(), jq.q.act_scales()
    assert sorted(ours) == sorted(theirs)
    for site in ours:
        np.testing.assert_allclose(ours[site], theirs[site], rtol=1e-6, err_msg=site)

    assert cli_main(["test", "qcli", "cpu", "train_data", "--data_path", data, "--weights_dir", wdir,
                     "--int8"]) == 0
    out = capsys.readouterr().out
    assert "int8 artifact: calibration delta" in out and "mm RMSE vs ground truth" in out
    assert os.path.exists(tmp_path / "test_output" / "depth_predictions.png") == _has_matplotlib()


def test_cli_export_command(tmp_path, monkeypatch):
    """export: checkpoint in, .gsx artifact out, checked against the live
    predictor and loadable by ExportedPredictor."""
    monkeypatch.chdir(tmp_path)
    wdir = str(tmp_path / "weights")
    _jax_checkpoint(wdir, "xcli")
    assert cli_main([
        "export", "xcli", "cpu", "--weights_dir", wdir, "--f32",
        "--batch_sizes", "2", "--output_size", "32", "43", "--frame_size", "32", "43", "--check",
    ]) == 0
    path = os.path.join(wdir, "xcli.gsx")
    served = ExportedPredictor.load(path)
    assert served.meta["kind"] == "float32" and served.meta["platforms"] == ["cpu"]
    rng = np.random.RandomState(1)
    out = served(rng.uniform(0, 255, (2, 6, 32, 43)).astype(np.float32),
                 rng.uniform(0, 255, (6, 32, 43)).astype(np.float32))
    assert tuple(out.shape) == (2, 2, 32, 43)


def test_cli_export_check_fails_as_system_exit(tmp_path, monkeypatch):
    """--check raises SystemExit, not an assert, when the artifact deviates."""
    monkeypatch.chdir(tmp_path)
    wdir = str(tmp_path / "weights")
    _jax_checkpoint(wdir, "xbad")
    real_load = ExportedPredictor.load

    def load_and_corrupt(path, **kw):
        served = real_load(path, **kw)
        served._graphs = {b: (lambda g: lambda f, b_: g(f, b_) + 1.0)(g) for b, g in served._graphs.items()}
        return served

    monkeypatch.setattr(ExportedPredictor, "load", staticmethod(load_and_corrupt))
    with pytest.raises(SystemExit, match="export check FAILED"):
        cli_main(["export", "xbad", "cpu", "--weights_dir", wdir, "--batch_sizes", "1",
                  "--output_size", "32", "43", "--frame_size", "32", "43", "--check"])


def test_cli_quantize_refuses_missing_base_for_diff_config(tmp_path, monkeypatch):
    """A difference-image config must not calibrate on raw frames when the
    dataset carries no base_tactile_image."""
    monkeypatch.chdir(tmp_path)
    wdir = str(tmp_path / "weights")
    _jax_checkpoint(wdir, "qnb")
    data = _dataset(tmp_path, "train_data", base=False)
    with pytest.raises(FileNotFoundError, match="base_tactile_image"):
        cli_main(["quantize", "qnb", "cpu", "--weights_dir", wdir, "--data_path", data, "--calib_frames", "4"])


def test_cli_test_int8_rejects_conflicting_flags(tmp_path):
    with pytest.raises(SystemExit):
        cli_main(["test", "w", "cpu", "sub", "--int8", "--torch_pth", str(tmp_path / "x.pth")])


@pytest.mark.parametrize("gpu,want", [(None, "cuda"), ("cpu", "cpu"), ("0", "cuda:0"), ("3", "cuda:3"),
                                      ("tpu", ValueError), ("cuda:x", ValueError)])
def test_gpu_positional(gpu, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            device_from_gpu_arg(gpu)
    else:
        assert device_from_gpu_arg(gpu) == want


def test_dispatcher(capsys):
    assert cli_main(["--help"]) == 0
    out = capsys.readouterr().out
    assert all(f"gelslim_depth_tpu_torch {cmd} " in out for cmd in
               ("train", "test", "split-data", "generate-depth", "view", "quantize", "export"))
    assert "not ported" not in out
    assert cli_main(["--version"]) == 0
    assert capsys.readouterr().out.strip()
    for cmd in ("train", "test", "split-data", "generate-depth", "view", "quantize", "export"):
        with pytest.raises(SystemExit) as e:
            cli_main([cmd, "--help"])
        assert e.value.code == 0
        assert capsys.readouterr().out.startswith(f"usage: gelslim-depth-tpu-torch {cmd}")
    assert cli_main(["nope"]) == 2
    with pytest.raises(SystemExit):  # 'tpu' is refused, through argparse
        cli_main(["export", "w", "tpu"])
