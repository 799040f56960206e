"""Flagship-scale training convergence run of the PyTorch/CUDA port.

The port's counterpart of ``scripts/train_convergence.py``, with the same
arguments and defaults: the reference recipe at flagship scale on the card,

  - the flagship U-Net (dims 64..1024) at the production 160x213 input,
  - a seeded synthetic corpus of >=5k finger samples (Gaussian contact
    indentations on noisy bases, ``data/synthetic.py``), or with
    ``--corpus realstl`` depth rendered by the port's meshgen from STLs,
  - the reference training recipe: batch 16, Adam(1e-3, wd 1e-6), EMA
    0.995, difference images, image norm 0_255_to_0_1, depth norm
    min_max_to_0_-1 with norm_scale 0.9 (ref config_unet_bigdata.py:38-43),
    train_indefinitely unless --early_stop is primed or reference,
  - bfloat16 compute, 60 epochs.

Outputs, under --out (default artifacts/convergence_torch/; never
artifacts/convergence/, which the JAX package's artifact test and
bench.py read):
  <name>.txt          the reference-format loss log (ref train_unet.py:491-498)
  <name>_summary.json the JAX script's summary keys, plus "device": the
                      card's name and power limit as nvidia-smi prints them
  <name>_curve.png    log-scale loss curves, when matplotlib is there
  <name>.json         the frozen config
The ~124 MB weights stay in the work directory, which the run prints.

Usage: python scripts/train_convergence_torch.py [--epochs 60] [--train_duals 2500]
       [--early_stop primed]

Imports torch, numpy and gelslim_depth_tpu_torch, never JAX or
gelslim_depth_tpu. Runs on cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gelslim_depth_tpu_torch import GelslimConfig, Trainer, bake_dataset  # noqa: E402
from gelslim_depth_tpu_torch.data.synthetic import make_mesh_contact_object, make_synthetic_object  # noqa: E402
from gelslim_depth_tpu_torch.meshgen import load_stl  # noqa: E402
from gelslim_depth_tpu_torch.utils.device import resolve_device  # noqa: E402

FLAGSHIP_DIMS = (64, 128, 256, 512, 1024)
IMAGE_SIZE = (160, 213)
SPLIT_SEEDS = (100, 200, 300)  # train, val, test corpora
BAKE = dict(
    use_difference_image=True,
    image_normalization_method="0_255_to_0_1",
    depth_normalization_method="min_max_to_0_-1",
    norm_scale=0.9,
    downsample_factor=1.0,  # the corpus is made at the training resolution
)
# the JAX package's artifacts, which its replay test and bench.py read
JAX_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts", "convergence")


def make_corpus_realstl(n_duals: int, seed: int, mesh_dir: str, image_size=IMAGE_SIZE, per_object: int = 100,
                        device=None):
    """Real-geometry corpus: objects of `per_object` dual frames, each
    rendered by the port's meshgen from one STL of `mesh_dir` in turn
    (``make_mesh_contact_object``, on `device`), from one RandomState(seed).
    Mesh unit scale is detected: a mesh whose bounding box is under 1 is
    in meters, else in mm."""
    stems = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(mesh_dir, "*.stl")))
    if not stems:
        raise FileNotFoundError(f"no STLs under {mesh_dir}")
    rng = np.random.RandomState(seed)
    objs = []
    made = 0
    i = 0
    while made < n_duals:
        path = os.path.join(mesh_dir, f"{stems[i % len(stems)]}.stl")
        tri = load_stl(path)
        extent = float((tri.reshape(-1, 3).max(0) - tri.reshape(-1, 3).min(0)).max())
        scale = 1000.0 if extent < 1.0 else 1.0
        n = min(per_object, n_duals - made)
        objs.append(make_mesh_contact_object(rng, path, n=n, pc_scale=scale, image_size=image_size, device=device))
        made += n
        i += 1
    return objs


def make_corpus(n_duals: int, seed: int, image_size=IMAGE_SIZE, per_object: int = 100):
    """Objects of `per_object` dual frames each, from one RandomState(seed):
    distinct bases and contact statistics per object, like distinct real
    objects. The default synthetic profile, as the JAX script uses (its
    docstring records the harder profiles that were tried and why they
    were dropped)."""
    rng = np.random.RandomState(seed)
    objs = []
    made = 0
    while made < n_duals:
        n = min(per_object, n_duals - made)
        objs.append(make_synthetic_object(rng, n=n, image_size=image_size))
        made += n
    return objs


def make_config(name: str, batch_size: int = 16, early_stop: str = "off", dims=FLAGSHIP_DIMS) -> GelslimConfig:
    """The JAX script's GelslimConfig, field for field."""
    return GelslimConfig(
        weights_name=name,
        CNN_dimensions=tuple(dims),
        batch_size=batch_size,
        input_tactile_image_size=IMAGE_SIZE,
        image_normalization_method=BAKE["image_normalization_method"],
        depth_normalization_method=BAKE["depth_normalization_method"],
        norm_scale=BAKE["norm_scale"],
        use_difference_image=True,
        train_indefinitely=early_stop == "off",
        early_stop_mode="primed" if early_stop == "primed" else "reference",
        downsample_factor=BAKE["downsample_factor"],
    )


def bake_splits(train_objs, val_objs, test_objs, device=None):
    """The train split's bake, then val and test under its frozen
    normalization."""
    train = bake_dataset(preloaded=train_objs, device=device, **BAKE)
    frozen = dict(
        depth_normalization_parameters=train.depth_normalization_parameters,
        image_normalization_parameters=train.image_normalization_parameters,
    )
    val = bake_dataset(preloaded=val_objs, device=device, **BAKE, **frozen)
    test = bake_dataset(preloaded=test_objs, device=device, **BAKE, **frozen)
    return train, val, test


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; the
    device's type off the card."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[device.index or 0].strip()


def summarize(name, history, val_loss_init, epoch_times, *, train_samples, batch_size, corpus, early_stop,
              early_stop_tripped, device_line):
    """The JAX script's summary (scripts/train_convergence.py:237-266), plus
    the device it ran on."""
    val = history["validation_loss"]
    et = sorted(epoch_times)
    best = int(np.argmin(val))
    return {
        "name": name,
        "epochs": len(val),
        "train_samples": int(train_samples),
        "batch_size": batch_size,
        "recipe": "adam(1e-3,wd 1e-6), EMA 0.995, bf16, diff images, 160x213, "
                  f"flagship dims, corpus={corpus}",
        "train_loss_first": history["train_loss"][0],
        "train_loss_final": history["train_loss"][-1],
        "val_loss_init": val_loss_init,
        "val_loss_first": val[0],
        "val_loss_final": val[-1],
        "val_loss_min": min(val),
        "val_loss_min_epoch": best + 1,
        "early_stop_mode": early_stop,
        # the trainer's own stop condition; under train_indefinitely a
        # tripped SMA only logs, so 'off' always records False
        "early_stopped": early_stop != "off" and bool(early_stop_tripped),
        "test_loss_at_best_val": history["test_loss"][best],
        "val_drop_ratio": val[0] / max(min(val), 1e-30),
        "val_drop_ratio_init": val_loss_init / max(min(val), 1e-30),
        "epoch_time_s_median": et[len(et) // 2],
        "epoch_time_s_min": et[0],
        "epoch_time_s_max": et[-1],
        "samples_per_sec_median": train_samples / et[len(et) // 2],
        "device": device_line,
    }


def plot_curve(path, name, history, train_samples):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(7, 4.5))
    xs = np.arange(1, len(history["validation_loss"]) + 1)
    for key, label in (("train_loss", "train"), ("validation_loss", "validation"), ("test_loss", "test")):
        ax.semilogy(xs, history[key], label=label)
    ax.set_xlabel("epoch")
    ax.set_ylabel("MSE (normalized depth)")
    ax.set_title(f"{name}: flagship U-Net, reference recipe, {train_samples} samples")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def run(name: str, *, epochs: int = 60, train_duals: int = 2500, eval_duals: int = 300, batch_size: int = 16,
        corpus: str = "synth", mesh_dir=None, early_stop: str = "off", out: str = "artifacts/convergence_torch",
        device=None, compute_dtype: torch.dtype = torch.bfloat16, starting_weights=None, dims=FLAGSHIP_DIMS,
        image_size=IMAGE_SIZE, per_object: int = 100, workdir=None):
    """Bake the corpus, train, write the artifacts under `out`; returns the
    summary and the loss history. `device`, `compute_dtype`, `starting_weights` (a
    reference-layout state dict), `dims`, `image_size`, `per_object` and
    `workdir` exist for tests at a small size on the CPU."""
    if os.path.realpath(out) == os.path.realpath(JAX_OUT):
        raise ValueError(f"--out {out}: that directory holds the JAX package's artifacts")
    device = resolve_device(device)
    print(f"device: {card_line(device)}", flush=True)
    if corpus == "realstl":
        if mesh_dir is None:
            raise ValueError("--corpus realstl needs --mesh_dir")

        def make(n_duals, seed):
            return make_corpus_realstl(n_duals, seed, mesh_dir, image_size, per_object, device=device)
    else:
        def make(n_duals, seed):
            return make_corpus(n_duals, seed, image_size, per_object)
    print(f"baking corpus ({corpus})...", flush=True)
    train, val, test = bake_splits(*(make(n, seed) for n, seed in zip((train_duals, eval_duals, eval_duals),
                                                                     SPLIT_SEEDS)), device=device)
    print(f"train {len(train)} / val {len(val)} / test {len(test)} finger samples "
          f"@ {train.input_tactile_image_size}", flush=True)

    workdir = workdir or tempfile.mkdtemp(prefix="convergence_")
    config = make_config(name, batch_size, early_stop, dims)
    trainer = Trainer(config, train, val, test, output_dir=workdir, device=device, compute_dtype=compute_dtype,
                      seed=0, starting_weights=starting_weights, enable_plots=False)
    # the learning evidence's anchor: the val loss under the initial
    # weights, before any training (the log starts after epoch 1)
    val_loss_init = trainer._eval_epoch(val, seed=1)
    print(f"val loss at initialization: {val_loss_init:.6f}", flush=True)

    history = trainer.fit(max_epochs=epochs)

    os.makedirs(out, exist_ok=True)
    shutil.copyfile(trainer.loss_file, os.path.join(out, f"{name}.txt"))
    with open(trainer.loss_file) as f:
        epoch_times = [float(line.split(":")[1]) for line in f if line.startswith("Time for epoch:")]
    if not history["validation_loss"] or not epoch_times:
        raise SystemExit(f"no epochs ran (--epochs {epochs}); nothing to summarize, no artifact written")
    summary = summarize(name, history, val_loss_init, epoch_times, train_samples=len(train),
                        batch_size=batch_size, corpus=corpus, early_stop=early_stop,
                        early_stop_tripped=trainer.early_stop_tripped, device_line=card_line(device))
    with open(os.path.join(out, f"{name}_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    plot_curve(os.path.join(out, f"{name}_curve.png"), name, history, len(train))
    shutil.copyfile(os.path.join(trainer.weights_dir, f"{name}.json"), os.path.join(out, f"{name}.json"))
    print(f"artifacts in {out}; weights in {trainer.weights_dir}", flush=True)
    return summary, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--train_duals", type=int, default=2500, help="dual frames; x2 finger samples after the split")
    ap.add_argument("--eval_duals", type=int, default=300)
    ap.add_argument("--name", default=None, help="artifact name; default unet_<corpus>_convergence")
    ap.add_argument("--out", default="artifacts/convergence_torch")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--corpus", choices=("synth", "realstl"), default="synth",
                    help="synth: Gaussian-indentation fixtures; realstl: depth rendered by the port's meshgen "
                         "from the STLs under --mesh_dir")
    ap.add_argument("--mesh_dir", default=None)
    ap.add_argument("--early_stop", choices=("off", "primed", "reference"), default="off",
                    help="off: train_indefinitely (the published run's mode); primed: the SMA early stop, its "
                         "window seeded with the first val loss; reference: the reference's zeros-seeded window "
                         "(ref train_unet.py:316-322,459-475)")
    args = ap.parse_args()
    name = args.name or f"unet_{args.corpus}_convergence"
    run(name, epochs=args.epochs, train_duals=args.train_duals, eval_duals=args.eval_duals,
        batch_size=args.batch_size, corpus=args.corpus, mesh_dir=args.mesh_dir, early_stop=args.early_stop,
        out=args.out)


if __name__ == "__main__":
    main()
