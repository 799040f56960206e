"""The port's convergence script (scripts/train_convergence_torch.py)
against the JAX package's (scripts/train_convergence.py), on the CPU at a
small size: the synthetic corpus bit for bit; the real-geometry corpus at
the meshgen bar (RMSE < 0.005 mm, tests/test_torch_meshgen.py); the whole
pipeline at dims (8, 16, 32) in float32 from the same starting weights,
val_loss_init and two epochs of history at rtol 1e-4 (float32 training in
another summation order, as tests/test_torch_trainer.py); the summary's
keys; and the script run with JAX blocked."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.data.dataset import bake_dataset as jax_bake
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.train import Trainer as JaxTrainer
from gelslim_depth_tpu_torch.meshgen import fixtures, save_stl_binary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (8, 16, 32)
SIZE = (32, 43)
SMALL = dict(train_duals=24, eval_duals=8, per_object=12)  # 48 / 16 / 16 finger samples: 3 train steps an epoch
BLOCKED = ("jax", "jaxlib", "optax", "gelslim_depth_tpu")


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_script = _load("train_convergence", "scripts/train_convergence.py")
port_script = _load("train_convergence_torch", "scripts/train_convergence_torch.py")
_helpers = _load("torch_port_helpers", "tests/torch_port_helpers.py")
_fixture = _load("torch_fixture", "tests/torch_fixture.py")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with _helpers.torch_threads(2):
        yield


def _assert_objects_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_make_corpus_bit_for_bit():
    kw = dict(image_size=(24, 32), per_object=7)
    for n_duals, seed in ((16, 100), (9, 200)):
        _assert_objects_equal(port_script.make_corpus(n_duals, seed, **kw), jax_script.make_corpus(n_duals, seed, **kw))


def test_make_corpus_realstl_vs_jax(tmp_path):
    """Two fixture plates, one in mm and one in meters, so both sides of
    the unit-scale rule run; 3 dual frames, 2 an object."""
    mesh_dir = tmp_path / "mesh"
    mesh_dir.mkdir()
    save_stl_binary(str(mesh_dir / "a_ridged_mm.stl"), fixtures.heightfield_plate_triangles(fixtures.ridged_height_fn()))
    save_stl_binary(str(mesh_dir / "b_bumps_m.stl"),
                    fixtures.heightfield_plate_triangles(fixtures.bumps_height_fn()) / 1000.0)
    kw = dict(image_size=(48, 64), per_object=2)
    want = jax_script.make_corpus_realstl(3, 7, str(mesh_dir), **kw)
    got = port_script.make_corpus_realstl(3, 7, str(mesh_dir), device="cpu", **kw)
    assert [len(o["grasp_widths"]) for o in got] == [2, 1]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("in_hand_pose", "grasp_widths", "base_tactile_image"):
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
        assert w["depth_image"].min() < -0.3
        diff = np.abs(g["depth_image"] - w["depth_image"])
        assert float(np.sqrt((diff ** 2).mean())) < 0.005
        assert (diff > 1e-4).mean() < 1e-4
        same = np.repeat(g["depth_image"] == w["depth_image"], 3, axis=1)
        assert np.array_equal(g["tactile_image"][same], w["tactile_image"][same])


def _jax_pipeline(sd, tmp_path):
    """The JAX script's pipeline (scripts/train_convergence.py:162-212) at
    DIMS, float32, from the reference-layout state dict sd: its corpus, its
    config and bake, val_loss_init, then fit."""
    cfg = JaxConfig(
        weights_name="tiny", CNN_dimensions=DIMS, batch_size=16, input_tactile_image_size=(160, 213),
        image_normalization_method="0_255_to_0_1", depth_normalization_method="min_max_to_0_-1",
        norm_scale=0.9, use_difference_image=True, train_indefinitely=True, early_stop_mode="reference",
        downsample_factor=1.0,
    )
    bake_kw = dict(use_difference_image=True, image_normalization_method="0_255_to_0_1",
                   depth_normalization_method="min_max_to_0_-1", norm_scale=0.9, downsample_factor=1.0)

    def corpus(n, seed):
        return jax_script.make_corpus(n, seed, image_size=SIZE, per_object=SMALL["per_object"])

    train = jax_bake(preloaded=corpus(SMALL["train_duals"], 100), **bake_kw)
    frozen = dict(depth_normalization_parameters=train.depth_normalization_parameters,
                  image_normalization_parameters=train.image_normalization_parameters)
    val = jax_bake(preloaded=corpus(SMALL["eval_duals"], 200), **bake_kw, **frozen)
    test = jax_bake(preloaded=corpus(SMALL["eval_duals"], 300), **bake_kw, **frozen)
    tr = JaxTrainer(cfg, train, val, test, output_dir=str(tmp_path), seed=0, enable_plots=False,
                    starting_weights=import_torch_state_dict(sd, cfg.unet_config()), log_fn=lambda m: None)
    val_loss_init = float(tr._eval_epoch(val, seed=1))
    return val_loss_init, tr.fit(max_epochs=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sd = _fixture.make_state_dict(np.random.RandomState(1), DIMS)
    out = tmp_path_factory.mktemp("out")
    summary, history = port_script.run(
        "tiny", epochs=2, out=str(out), device="cpu", compute_dtype=torch.float32, dims=DIMS, image_size=SIZE,
        starting_weights={k: torch.from_numpy(v) for k, v in sd.items()},
        workdir=str(tmp_path_factory.mktemp("work")), **SMALL)
    return out, summary, history, _jax_pipeline(sd, tmp_path_factory.mktemp("jax"))


def test_pipeline_matches_jax(runs):
    out, summary, history, (val_loss_init, want) = runs
    np.testing.assert_allclose(summary["val_loss_init"], val_loss_init, rtol=1e-4)
    assert set(history) == set(want)
    for k in want:
        assert len(history[k]) == 2
        np.testing.assert_allclose(history[k], want[k], rtol=1e-4, err_msg=k)
    assert history["train_loss"][1] < history["train_loss"][0]
    assert summary["epochs"] == 2 and summary["train_samples"] == 2 * SMALL["train_duals"]
    with open(out / "tiny.txt") as f:
        logged = [[float(v) for v in line.replace(",", "").split()[2::3]] for line in f if line.startswith("Train loss")]
    np.testing.assert_allclose(np.asarray(logged).T, [history[k] for k in ("train_loss", "validation_loss", "test_loss")],
                               atol=5e-7)  # the log's six decimals


def test_summary_keys_and_artifacts(runs):
    """The JAX script's summary keys (its newest artifact, which carries
    early_stop_mode and early_stopped), plus "device"; the log, the config
    and the frozen normalization beside it."""
    out, summary, _, _ = runs
    with open(os.path.join(REPO, "artifacts", "convergence", "unet_earlystop_convergence_summary.json")) as f:
        jax_keys = set(json.load(f))
    with open(out / "tiny_summary.json") as f:
        written = json.load(f)
    assert set(written) == jax_keys | {"device"} and written == summary
    assert written["device"] == "cpu" and written["early_stop_mode"] == "off" and written["early_stopped"] is False
    with open(out / "tiny.json") as f:
        cfg = json.load(f)
    assert cfg["CNN_dimensions"] == list(DIMS) and cfg["train_indefinitely"] is True
    assert cfg["input_tactile_image_size"] == list(SIZE) and cfg["depth_normalization_parameters"][0] < 0


def test_refuses_the_jax_artifact_directory(tmp_path):
    with pytest.raises(ValueError, match="JAX package"):
        port_script.run("x", out=os.path.join(REPO, "artifacts", "convergence"), device="cpu")


def test_script_runs_with_jax_blocked(tmp_path):
    script = textwrap.dedent(
        f"""
        import sys

        class Blocker:
            BLOCKED = {BLOCKED!r}
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in self.BLOCKED:
                    raise ImportError(f"{{name}} blocked for this test")
        sys.meta_path.insert(0, Blocker())

        import importlib.util
        import torch
        torch.set_num_threads(2)
        spec = importlib.util.spec_from_file_location("tc", {os.path.join(REPO, "scripts", "train_convergence_torch.py")!r})
        tc = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tc)
        s, _ = tc.run("blocked", epochs=1, train_duals=4, eval_duals=2, per_object=2, out="out", device="cpu",
                   dims=(4, 8), image_size=(16, 22), workdir="work", early_stop="primed")
        assert s["epochs"] == 1 and s["early_stop_mode"] == "primed"
        if not torch.cuda.is_available():  # the default device is the card
            try:
                tc.run("cuda", epochs=1, train_duals=2, eval_duals=2, out="out2")
            except RuntimeError as e:
                assert "no CUDA device" in str(e)
            else:
                raise AssertionError("ran without a card")
        assert not any(m.split(".")[0] in Blocker.BLOCKED for m in sys.modules)
        print("NO-JAX-OK")
        """
    )
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, cwd=str(tmp_path),
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONPATH": REPO}, timeout=300)
    assert "NO-JAX-OK" in r.stdout, f"stdout: {r.stdout[-2000:]}\nstderr: {r.stderr[-3000:]}"
