"""The convergence study (scripts/study_convergence_torch.py) on the CPU at
a small size (dims (8, 16, 32), 2 epochs): each seed arm starts from the
draw the Trainer makes for that seed, and seed 0's arm trains exactly as the
recipe's own run; the raw-weight evaluation is ``make_eval_step(use_ema=False)``
on the epoch's batches; the float32-conv-output arm gives float32 into the
batch norm and puts the conv and the TF32 flag back; the study's verdicts
and report."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from gelslim_depth_tpu_torch.models import unet as unet_mod
from gelslim_depth_tpu_torch.models.unet import init_unet, reinit_weights_normal, unet_apply
from gelslim_depth_tpu_torch.train.steps import create_train_state, eval_epoch, make_eval_step, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (8, 16, 32)
SMALL = dict(epochs=2, train_duals=24, eval_duals=8, per_object=12, dims=DIMS, image_size=(32, 43), device="cpu")


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


study = _load("study_convergence_torch", "scripts/study_convergence_torch.py")
recipe = _load("train_convergence_torch", "scripts/train_convergence_torch.py")
_helpers = _load("torch_port_helpers", "tests/torch_port_helpers.py")
UCFG = recipe.make_config("x", dims=DIMS).unet_config()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with _helpers.torch_threads(2):
        yield


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_starting_weights_are_the_trainers_draw(seed):
    got = study.starting_weights(UCFG, seed)
    gen = torch.Generator().manual_seed(seed)
    params, stats = init_unet(UCFG, gen)
    want = {**reinit_weights_normal(params, gen), **stats}
    state = create_train_state(UCFG, make_optimizer(), generator=torch.Generator().manual_seed(seed), device="cpu")
    assert set(got) == set(want) == set(state.params) | set(state.batch_stats)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], {**state.params, **state.batch_stats}[k]), k
    other = study.starting_weights(UCFG, seed + 1)
    assert not torch.equal(got["inc.double_conv.0.weight"], other["inc.double_conv.0.weight"])


def test_arm_settings():
    assert study.arm_settings("seed3") == (3, torch.bfloat16, False)
    assert study.arm_settings("f32") == (0, torch.float32, False)
    assert study.arm_settings("f32conv") == (0, torch.bfloat16, True)
    with pytest.raises(ValueError):
        study.arm_settings("seedx")


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("study"))
    seed0 = study.run_arm("seed0", out, workdir=str(tmp_path_factory.mktemp("w0")), **SMALL)
    f32conv = study.run_arm("f32conv", out, workdir=str(tmp_path_factory.mktemp("w1")), **SMALL)
    _, plain = recipe.run("plain", out=str(tmp_path_factory.mktemp("plain")), compute_dtype=torch.bfloat16,
                          workdir=str(tmp_path_factory.mktemp("w2")), **SMALL)
    return out, seed0, f32conv, plain


def test_seed0_arm_trains_as_the_recipe(arms):
    """Seed 0's arm, its weights given and the raw weights evaluated, gives
    the recipe's own bf16 run (the Trainer's seed-0 draw) bit for bit."""
    _, seed0, _, plain = arms
    for k in ("train_loss", "validation_loss", "test_loss"):
        assert seed0["history"][k] == plain[k], k
    assert len(seed0["history"]["raw_validation_loss"]) == len(seed0["history"]["raw_test_loss"]) == 2


def test_study_json_and_verdicts(arms):
    out, seed0, f32conv, _ = arms
    for s in (seed0, f32conv):
        with open(os.path.join(out, s["arm"], "study.json")) as f:
            assert json.load(f)["arm"] == s["arm"]
        assert s["epochs"] == 2 and s["device"] == "cpu"
        val = study.log_precision(s["history"]["validation_loss"])
        assert s["ema"]["val_min"] == min(val) and s["ema"]["val_min_epoch"] == int(np.argmin(val)) + 1
        assert s["ema"]["val_second"] == max(val)
        assert s["ema"]["stable_tail_ratio"] == pytest.approx(np.median(val) / min(val))
        assert s["train_median_last10"] == pytest.approx(np.median(s["history"]["train_loss"]))
        assert s["raw"]["held_out_mm"] > 0 and np.isfinite(s["raw"]["stable_tail_ratio"])
    assert f32conv["f32_conv_outputs"] and not seed0["f32_conv_outputs"]
    assert unet_mod._conv_pad1 is study._CONV_PAD1
    table = study.report(out)
    assert table.count("\n") == 1 + 1 + 2 * 2  # header, rule, the committed run, two arms x (ema, raw)
    assert "seed0 (committed)" in table and "| f32conv | raw |" in table


def test_raw_eval_is_the_eval_step_without_ema(tmp_path):
    record = {"validation_loss": [], "test_loss": []}
    train, val, test = recipe.bake_splits(*(recipe.make_corpus(n, seed, (32, 43), 12)
                                            for n, seed in ((24, 100), (8, 200), (8, 300))), device="cpu")
    trainer = study.raw_eval_trainer(recipe.Trainer, record)(
        recipe.make_config("t", dims=DIMS), train, val, test, output_dir=str(tmp_path), device="cpu",
        compute_dtype=torch.bfloat16, enable_plots=False, log_fn=lambda m: None)
    trainer._eval_epoch(val, seed=1)  # the init evaluation records nothing
    history = trainer.fit(max_epochs=2)
    assert len(record["validation_loss"]) == len(record["test_loss"]) == 2
    step = make_eval_step(UCFG, use_ema=False, compute_dtype=torch.bfloat16, masked=True)
    for ds, key, seed in ((val, "validation_loss", 2001), (test, "test_loss", 3001)):
        perm, masks = trainer._epoch_indices(ds, seed)
        want = float(eval_epoch(step, trainer.state, ds.tactile_image, ds.depth_image, perm, masks))
        assert record[key][-1] == want
    assert record["validation_loss"] != history["validation_loss"]  # the EMA is not the raw weights


def test_f32_conv_outputs():
    gen = torch.Generator().manual_seed(5)
    params, stats = init_unet(UCFG, gen)
    x = torch.randn(2, 3, 16, 24, generator=gen)
    seen = []
    with study.f32_conv_outputs():
        assert not torch.backends.cudnn.allow_tf32
        conv = unet_mod._conv_pad1

        def spy(a, w, halo=None):
            y = conv(a, w, halo)
            seen.append((a.dtype, w.dtype, y.dtype))
            torch.testing.assert_close(y, torch.nn.functional.conv2d(a.float(), w.float(), padding=1), rtol=0,
                                       atol=0)
            return y

        unet_mod._conv_pad1 = spy
        unet_apply(UCFG, params, stats, x, train=True, compute_dtype=torch.bfloat16)
    assert seen and all(s == (torch.bfloat16, torch.bfloat16, torch.float32) for s in seen)
    assert unet_mod._conv_pad1 is study._CONV_PAD1 and torch.backends.cudnn.allow_tf32
