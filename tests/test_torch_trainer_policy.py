"""The port's Trainer policy on the CPU: the SMA early stop in both modes
against the JAX Trainer's, the resume sidecar's three degraded cases, the
epoch snapshots, periodic resume files and the plots."""

import json
import os

import numpy as np
import pytest
import torch

from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.data.dataset import bake_dataset as jax_bake
from gelslim_depth_tpu.models.torch_import import import_torch_state_dict
from gelslim_depth_tpu.train import Trainer as JaxTrainer
from gelslim_depth_tpu_torch import GelslimConfig, Trainer, bake_dataset
from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object
from tests.torch_fixture import make_state_dict
from tests.torch_port_helpers import torch_threads

DIMS = (8, 16)
BAKE = dict(use_difference_image=True, image_normalization_method="0_255_to_0_1", norm_scale=0.9)
CFG = dict(weights_name="tiny", CNN_dimensions=DIMS, batch_size=8, image_normalization_method="0_255_to_0_1",
           norm_scale=0.9, use_difference_image=True)



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield

@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    train = [make_synthetic_object(rng, n=6, image_size=(32, 43)) for _ in range(2)]
    val = [make_synthetic_object(rng, n=4, image_size=(32, 43))]
    sd = make_state_dict(np.random.RandomState(1), DIMS)
    return train, val, sd


def _bake(bake, objs, val):
    train = bake(preloaded=objs, **BAKE)
    frozen = dict(depth_normalization_parameters=train.depth_normalization_parameters,
                  image_normalization_parameters=train.image_normalization_parameters)
    return train, bake(preloaded=val, **BAKE, **frozen)


def _port_trainer(data, out, **cfg):
    objs, val_objs, sd = data
    train, val = _bake(lambda **kw: bake_dataset(device="cpu", **kw), objs, val_objs)
    return Trainer(GelslimConfig(**{**CFG, **cfg}), train, val, val, output_dir=str(out), device="cpu",
                   starting_weights={k: torch.from_numpy(v) for k, v in sd.items()},
                   log_fn=lambda m: None, enable_plots=False)


@pytest.mark.parametrize("mode", ["reference", "primed"])
def test_early_stop_matches_jax(data, tmp_path, mode):
    """lr 0: only the BN running statistics move the validation loss. The
    reference's zero-filled window rises while it fills and trips at epoch
    threshold + 1 whatever the losses; the primed window trips only on a
    genuine rise, later."""
    cfg = dict(training_learning_rate=0.0, val_loss_SMA_window=3, validation_loss_count_threshold=2,
               early_stop_mode=mode)
    port = _port_trainer(data, tmp_path / "p", **cfg)
    objs, val_objs, sd = data
    train, val = _bake(jax_bake, objs, val_objs)
    jcfg = JaxConfig(**{**CFG, **cfg})
    jax_tr = JaxTrainer(jcfg, train, val, val, output_dir=str(tmp_path / "j"), log_fn=lambda m: None,
                        starting_weights=import_torch_state_dict(sd, jcfg.unet_config()), enable_plots=False)
    got, want = port.fit(max_epochs=6), jax_tr.fit(max_epochs=6)
    assert len(got["train_loss"]) == len(want["train_loss"])
    assert (len(got["train_loss"]) == 3) == (mode == "reference")
    assert port.early_stop_tripped == jax_tr.early_stop_tripped
    # a resumed trainer replays the window from the history
    port.save_resume_state()
    again = _port_trainer(data, tmp_path / "p", **cfg)
    again.load_resume_state()
    assert again.early_stop_tripped == port.early_stop_tripped
    assert again._upward_counter == port._upward_counter and again._prev_sma == port._prev_sma


def test_degraded_resume_pairs_warn_and_reset_the_loop(data, tmp_path):
    tr = _port_trainer(data, tmp_path)
    tr.fit(max_epochs=1)
    tr.save_resume_state()
    sidecar = os.path.join(tr.weights_dir, "train_state_loop.json")
    with open(sidecar) as f:
        loop = json.load(f)
    for case, edit, match in (
        ("no step", lambda d: d.pop("step"), "has no 'step' key"),
        ("torn", lambda d: d.update(step=d["step"] + 1), "out of sync"),
        ("missing", None, "no loop-bookkeeping sidecar"),
    ):
        if edit is None:
            os.remove(sidecar)
        else:
            bad = dict(loop)
            edit(bad)
            with open(sidecar, "w") as f:
                json.dump(bad, f)
        fresh = _port_trainer(data, tmp_path)
        with pytest.warns(UserWarning, match=match):
            fresh.load_resume_state()
        # the device state is restored, the loop starts over
        assert int(fresh.state.step) == int(tr.state.step), case
        assert fresh.epoch == 0 and fresh.history["train_loss"] == [], case


def test_snapshots_resume_files_and_plots(data, tmp_path):
    objs, val_objs, sd = data
    train, val = _bake(lambda **kw: bake_dataset(device="cpu", **kw), objs, val_objs)
    cfg = GelslimConfig(**CFG, train_indefinitely=True, save_at_epochs=[1], val_loss_SMA_window=2,
                        validation_loss_count_threshold=0, num_images_to_display_live=2)
    logs = []
    tr = Trainer(cfg, train, val, val, output_dir=str(tmp_path), device="cpu", seed=3, log_fn=logs.append,
                 resume_every_epochs=2)
    hist = tr.fit(max_epochs=3)
    assert len(hist["train_loss"]) == 3 and all(np.isfinite(v) for vs in hist.values() for v in vs)
    w = tmp_path / "weights"
    assert (w / "tiny_epoch1.npz").exists() and not (w / "tiny_epoch0.npz").exists()
    assert (w / "train_state.npz").exists() and (w / "train_state_loop.json").exists()
    with open(w / "train_state_loop.json") as f:
        assert json.load(f)["epoch"] == 2
    assert any(m.startswith("Validation loss stopped decreasing at epoch") for m in logs)
    assert (tmp_path / "loss_curves" / "tiny.png").exists()
    for split in ("train", "validation", "test"):
        assert (tmp_path / "live_display" / f"tiny_{split}_images.png").exists()
    # seeded fresh weights: the same seed, the same start
    again = Trainer(cfg, train, val, val, output_dir=str(tmp_path / "b"), device="cpu", seed=3,
                    log_fn=lambda m: None, enable_plots=False)
    assert again.fit(max_epochs=3) == hist
