"""The port's Trainer against the JAX package's, on the same baked data and
starting weights (made with numpy from a seed), on the CPU: the loss
history (rtol 1e-4: float32 training in another summation order), the log
lines, the checkpoints, and resume within and across the two packages."""

import re

import numpy as np
import pytest
import torch

import jax

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.data.dataset import bake_dataset as jax_bake
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.train import Trainer as JaxTrainer
from gelslim_depth_tpu.train import load_checkpoint as jax_load_checkpoint
from gelslim_depth_tpu_torch import GelslimConfig, Predictor, Trainer, bake_dataset
from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object
from tests.torch_fixture import make_state_dict
from tests.torch_port_helpers import torch_threads

DIMS = (8, 16, 32)
BAKE = dict(use_difference_image=True, image_normalization_method="0_255_to_0_1", norm_scale=0.9)
CFG = dict(weights_name="tiny", CNN_dimensions=DIMS, batch_size=8, input_tactile_image_size=(16, 21),
           image_normalization_method="0_255_to_0_1", depth_normalization_method="min_max_to_0_-1",
           norm_scale=0.9, use_difference_image=True, val_loss_SMA_window=3,
           validation_loss_count_threshold=20, training_learning_rate=3e-3)
TIMES = re.compile(r"^(Time for epoch: |Training time: ).*")



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield

@pytest.fixture(scope="module")
def data():
    """Train (28 finger samples: batches of 8, 8, 8, 4), val and test
    splits, each baked by both packages from the same objects, and seeded
    starting weights in both layouts."""
    rng = np.random.RandomState(0)
    splits = {name: [make_synthetic_object(rng, n=n, image_size=(32, 43)) for _ in range(k)]
              for name, k, n in (("train", 2, 7), ("val", 1, 5), ("test", 1, 3))}
    port, jax_ = {}, {}
    for name, objs in splits.items():
        frozen = {} if name == "train" else dict(
            depth_normalization_parameters=port["train"].depth_normalization_parameters,
            image_normalization_parameters=port["train"].image_normalization_parameters)
        port[name] = bake_dataset(preloaded=objs, device="cpu", **BAKE, **frozen)
        jax_[name] = jax_bake(preloaded=objs, **BAKE, **frozen)
    sd = make_state_dict(np.random.RandomState(1), DIMS)
    return port, jax_, sd


def _port_trainer(data, out, **kw):
    port, _, sd = data
    cfg = GelslimConfig(**{**CFG, **kw.pop("cfg", {})})
    logs = []
    tr = Trainer(cfg, port["train"], port["val"], port["test"], output_dir=str(out), device="cpu",
                 starting_weights={k: torch.from_numpy(v) for k, v in sd.items()}, log_fn=logs.append,
                 enable_plots=False, **kw)
    return tr, logs


def _jax_trainer(data, out, **kw):
    _, jax_, sd = data
    cfg = JaxConfig(**{**CFG, **kw.pop("cfg", {})})
    logs = []
    tr = JaxTrainer(cfg, jax_["train"], jax_["val"], jax_["test"], output_dir=str(out),
                    starting_weights=import_torch_state_dict(sd, cfg.unet_config()), log_fn=logs.append,
                    enable_plots=False, **kw)
    return tr, logs


def _untimed(lines):
    return [TIMES.sub(r"\1<time>", line) for line in lines]


def _assert_history_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_history_logs_and_checkpoints_match_jax(data, tmp_path):
    port_tr, port_logs = _port_trainer(data, tmp_path / "port")
    jax_tr, jax_logs = _jax_trainer(data, tmp_path / "jax")
    got, want = port_tr.fit(max_epochs=2), jax_tr.fit(max_epochs=2)
    _assert_history_close(got, want)
    assert got["train_loss"][1] < got["train_loss"][0]
    assert _untimed(port_logs) == _untimed(jax_logs)
    with open(tmp_path / "port" / "loss_values" / "tiny.txt") as f:
        assert f.read().splitlines() == port_logs

    # the frozen config artifacts and the best-val EMA checkpoint, which the
    # JAX package reads and the port serves from
    wdir = tmp_path / "port" / "weights"
    for name in ("tiny.npz", "tiny.json", "config_tiny.py", "tiny.pth"):
        assert (wdir / name).exists(), name
    cfg, params, stats = jax_load_checkpoint(str(wdir))
    assert cfg.depth_normalization_parameters == port_tr.config.depth_normalization_parameters
    _, jparams, _ = jax_load_checkpoint(str(tmp_path / "jax" / "weights"))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-3, atol=2e-3)
    pred = Predictor.from_checkpoint(str(wdir), device="cpu")
    assert set(pred.state_dict) == set(port_tr.ema_state_dict())
    frames = np.random.RandomState(2).uniform(0, 255, (2, 6, 32, 43)).astype(np.float32)
    out = pred.predict_dual_frames(frames, frames[0], (32, 43))
    assert out.shape == (2, 2, 32, 43) and torch.isfinite(out).all()


def test_resumed_run_continues_the_exact_trajectory(data, tmp_path):
    straight, _ = _port_trainer(data, tmp_path / "a")
    straight.fit(max_epochs=4)
    first, _ = _port_trainer(data, tmp_path / "b")
    first.fit(max_epochs=2)
    first.save_resume_state()
    resumed, logs = _port_trainer(data, tmp_path / "b")
    resumed.load_resume_state()
    assert resumed.epoch == 2 and resumed.min_validation_loss == first.min_validation_loss
    hist = resumed.fit(max_epochs=4)
    assert hist == straight.history
    for k, v in straight.state.tensors().items():
        assert torch.equal(resumed.state.tensors()[k], v), k
    assert "[INFO] EPOCH: 3" in logs and "[INFO] EPOCH: 2" not in logs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_state_resumes_in_the_other_package(data, tmp_path, writer):
    """One epoch in the writer, save_resume_state; the other package loads
    it and runs the second epoch, which equals the writer's own second."""
    make_writer, make_reader = (_jax_trainer, _port_trainer) if writer == "jax" else (_port_trainer, _jax_trainer)
    w, _ = make_writer(data, tmp_path)
    w.fit(max_epochs=1)
    w.save_resume_state()
    r, _ = make_reader(data, tmp_path)
    r.load_resume_state()
    assert r.epoch == 1 and int(r.state.step) == int(w.state.step) == 4
    hist = r.fit(max_epochs=2)
    want = w.fit(max_epochs=2)
    _assert_history_close(hist, want)
    assert hist["train_loss"][0] == want["train_loss"][0]  # carried in the sidecar
