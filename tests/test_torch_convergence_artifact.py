"""Replay the port's flagship convergence artifacts (artifacts/convergence_torch/),
made on the card by scripts/train_convergence_torch.py: the reference recipe
(Adam 1e-3 wd 1e-6, EMA 0.995, batch 16, difference images, 160x213,
flagship dims 64..1024, bfloat16) on the JAX run's corpus (the same seeds,
>=5k finger samples). The rules are those of
tests/test_convergence_artifact.py, in this file's own copy of its parser
and SMA replay, so that a regression of the port's long-horizon learning
(EMA ramp, BatchNorm drift, the NaN guard, early stop) shows as a parse or
trajectory failure. One bar crosses the packages: the port's best val loss
is within 10x of the JAX artifact's, so a trainer that stalls at the
epoch-1 level fails."""

import glob
import json
import os
import re

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART_DIR = os.path.join(REPO, "artifacts", "convergence_torch")
JAX_FLAGSHIP = os.path.join(REPO, "artifacts", "convergence", "unet_synth_convergence_summary.json")

LOSS_RE = re.compile(
    r"Train loss: ([0-9.eE+-]+),\s+Validation loss: ([0-9.eE+-]+), "
    r"Test loss: ([0-9.eE+-]+)"
)

SUMMARIES = sorted(glob.glob(os.path.join(ART_DIR, "*_summary.json")))


def _mode(path):
    with open(path) as f:
        return json.load(f)["early_stop_mode"]


FLAGSHIP = [p for p in SUMMARIES if _mode(p) == "off"]
EARLYSTOP = [p for p in SUMMARIES if _mode(p) != "off"]

artifact_files = pytest.mark.parametrize("summary_path", FLAGSHIP, ids=[os.path.basename(p) for p in FLAGSHIP])
all_artifact_files = pytest.mark.parametrize("summary_path", SUMMARIES, ids=[os.path.basename(p) for p in SUMMARIES])
earlystop_files = pytest.mark.parametrize("summary_path", EARLYSTOP, ids=[os.path.basename(p) for p in EARLYSTOP])


def _artifact(summary_path):
    with open(summary_path) as f:
        summary = json.load(f)
    log_path = os.path.join(ART_DIR, summary["name"] + ".txt")
    assert os.path.exists(log_path), log_path
    return summary, log_path


def _parse_log(log_path):
    epochs, times = [], []
    with open(log_path) as f:
        for line in f:
            m = LOSS_RE.search(line)
            if m:
                epochs.append(tuple(float(g) for g in m.groups()))
            elif line.startswith("Time for epoch:"):
                times.append(float(line.split(":")[1]))
    return epochs, times


def test_artifacts_exist():
    names = {os.path.basename(p) for p in SUMMARIES}
    assert {"unet_synth_convergence_summary.json", "unet_earlystop_convergence_summary.json"} <= names, names
    assert FLAGSHIP and EARLYSTOP
    for path in SUMMARIES:
        summary, _ = _artifact(path)
        assert os.path.exists(os.path.join(ART_DIR, summary["name"] + ".json")), "no frozen config"


@all_artifact_files
def test_made_on_the_card(summary_path):
    """The summary's device is nvidia-smi's 'name, power limit' line."""
    summary, _ = _artifact(summary_path)
    name, limit = (s.strip() for s in summary["device"].split(","))
    assert "H100" in name and re.fullmatch(r"[0-9.]+ W", limit), summary["device"]


@artifact_files
def test_log_is_reference_format_and_flagship_scale(summary_path):
    summary, log_path = _artifact(summary_path)
    epochs, times = _parse_log(log_path)
    assert len(epochs) >= 50, f"only {len(epochs)} epochs logged"
    assert len(times) == len(epochs)
    assert summary["epochs"] == len(epochs)
    assert summary["train_samples"] >= 5000
    assert summary["batch_size"] == 16
    assert "adam(1e-3" in summary["recipe"] and "EMA 0.995" in summary["recipe"]


@artifact_files
def test_validation_loss_converges(summary_path):
    """>=100x learning from the initial weights' val loss, the minimum in
    the last half of the run, a stable tail, and train loss far below its
    start (tests/test_convergence_artifact.py:107-149)."""
    summary, log_path = _artifact(summary_path)
    epochs, _ = _parse_log(log_path)
    train = [e[0] for e in epochs]
    val = [e[1] for e in epochs]
    test = [e[2] for e in epochs]

    assert min(val) > 0 and all(v > 0 for v in val)
    drop_init = summary["val_loss_init"] / min(val)
    assert drop_init >= 100, f"val loss fell only {drop_init:.1f}x from init"
    # the log prints 6 decimals, so log-derived ratios match the summary's
    # full-precision ones only to the rounding of the smallest losses
    assert summary["val_drop_ratio_init"] == pytest.approx(drop_init, rel=0.05)
    assert summary["val_drop_ratio"] == pytest.approx(val[0] / min(val), rel=0.05)
    assert summary["val_loss_min"] == pytest.approx(min(val), abs=5e-7)
    assert int(np.argmin(val)) >= len(val) // 2, int(np.argmin(val))
    assert min(val) <= val[0] / 10
    tail = sorted(val[-5:])
    assert tail[len(tail) // 2] <= 10 * min(val), (tail, min(val))
    assert train[-1] <= train[0] / 100
    assert train[-1] <= val[-1]
    assert sorted(test[-5:])[2] <= 10 * min(test)


@artifact_files
def test_best_val_loss_within_10x_of_jax(summary_path):
    """The same corpus from the same seeds and the same recipe: the port's
    best val loss within 10x of the JAX run's (4.41e-5). A trainer that
    stalls at the epoch-1 level (~7e-4) fails."""
    summary, _ = _artifact(summary_path)
    with open(JAX_FLAGSHIP) as f:
        jax_min = json.load(f)["val_loss_min"]
    assert jax_min / 10 <= summary["val_loss_min"] <= 10 * jax_min, (summary["val_loss_min"], jax_min)


def _sma_trip_epoch(val, mode, window_len=10, threshold=5):
    """The Trainer's SMA rule replayed over logged val losses (window
    val_loss_SMA_window, a trip after more than
    validation_loss_count_threshold upward-SMA epochs in a row; 'primed'
    seeds the window with the first val loss): the 1-based epoch where it
    first fires, or None."""
    window = np.zeros(window_len)
    prev_sma, upward = 0.0, 0
    for i, v in enumerate(val):
        if mode == "primed" and i == 0:
            window[:] = v
            prev_sma = float("inf")
        window[i % window_len] = v
        sma = float(window.mean())
        upward = upward + 1 if sma > prev_sma else 0
        prev_sma = sma
        if upward > threshold:
            return i + 1
    return None


@earlystop_files
def test_early_stop_agrees_with_the_rule(summary_path):
    """The run stopped exactly where the replayed rule first fires, or the
    rule never fires and the run did not stop."""
    summary, log_path = _artifact(summary_path)
    epochs, _ = _parse_log(log_path)
    val = [e[1] for e in epochs]
    assert summary["epochs"] == len(epochs)
    assert summary["train_samples"] >= 5000
    assert summary["batch_size"] == 16
    trip = _sma_trip_epoch(val, summary["early_stop_mode"])
    if summary["early_stopped"]:
        assert trip == len(val), f"run has {len(val)} epochs but the rule fires at {trip}"
    else:
        assert trip is None, f"the rule fires at epoch {trip} but the run went on to {len(val)}"


@all_artifact_files
def test_epoch_times_are_sane_and_recorded(summary_path):
    summary, log_path = _artifact(summary_path)
    _, times = _parse_log(log_path)
    med = sorted(times)[len(times) // 2]
    assert summary["epoch_time_s_median"] == pytest.approx(med, rel=1e-6)
    assert med < 120, f"median epoch {med:.1f}s"
    assert max(times[1:]) < 3 * med, "late-run epoch-time blowup"
    assert summary["samples_per_sec_median"] == pytest.approx(summary["train_samples"] / med, rel=1e-6)
