"""Study of the port's flagship convergence run: the recipe of
``scripts/train_convergence_torch.py`` (its defaults: flagship dims at
160x213, batch 16, 5,000 / 600 / 600 finger samples from seeds 100 / 200 /
300, 60 epochs) driven through its ``run()`` in arms that each change one
thing against the committed run (bf16, init seed 0):

  seed<K>   bf16 from the initial weights of seed K: ``init_unet`` and then
            ``reinit_weights_normal`` on ``torch.Generator().manual_seed(K)``,
            the draw the Trainer makes for ``seed=K``, given to ``run`` as
            ``starting_weights``
  f32       float32 compute (``run(compute_dtype=torch.float32)``) from seed 0
  f32conv   bf16 from seed 0, each 3x3 conv's output kept in float32 into its
            batch norm: the bf16 inputs and weights go through a float32
            conv with TF32 off, so the products are exact and the sums
            float32, as XLA computes a bf16 conv when it may keep excess
            precision (its default). The upconvs and the head stay bf16.

Every arm also evaluates the raw weights (not the EMA) on val and test at
the end of each epoch, with the same batches and running statistics as
the EMA evaluation (``make_eval_step(use_ema=False)``).

For each arm it writes under ``--out`` (default
``chiprun_out/convergence_study/``; never under ``artifacts/``)
``<arm>/``: ``run()``'s artifacts, and ``<arm>/study.json``: for the EMA
and the raw weights, the replay's stable-tail verdict (the median of the
last 5 val losses over the minimum, at most 10), the minimum and the
second-lowest val loss, the minimum's epoch, the held-out error in mm at
the best val epoch (sqrt(test loss) x (max - min) / norm_scale of the
train split's depth normalization); and the median train loss over the
last 10 epochs (51-60 of 60). ``--report`` prints them as one table,
beside the committed seed-0 run in ``artifacts/convergence_torch/``.

Usage: python scripts/study_convergence_torch.py --arm seed1 [--arm f32 ...]
       python scripts/study_convergence_torch.py --report

Imports torch, numpy and gelslim_depth_tpu_torch, never JAX or
gelslim_depth_tpu. Runs on cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib.util
import json
import os
import re
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gelslim_depth_tpu_torch.models import unet as unet_mod  # noqa: E402
from gelslim_depth_tpu_torch.models.unet import init_unet, reinit_weights_normal  # noqa: E402
from gelslim_depth_tpu_torch.train.steps import eval_epoch, make_eval_step  # noqa: E402

OUT = os.path.join("chiprun_out", "convergence_study")
COMMITTED = os.path.join(REPO, "artifacts", "convergence_torch", "unet_synth_convergence")
TAIL, TAIL_RULE, TRAIN_WINDOW = 5, 10.0, 10  # the replay's stable tail; epochs 51-60 of 60


def _load_recipe():
    """scripts/train_convergence_torch.py as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location("train_convergence_torch",
                                                  os.path.join(REPO, "scripts", "train_convergence_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def starting_weights(unet_cfg, seed: int):
    """The reference-layout state dict of seed `seed`'s initial weights: the
    draw ``create_train_state`` makes from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    params, stats = init_unet(unet_cfg, gen)
    return {**reinit_weights_normal(params, gen), **stats}


def arm_settings(arm: str):
    """(init seed, compute dtype, float32 conv outputs) of an arm name."""
    if arm == "f32":
        return 0, torch.float32, False
    if arm == "f32conv":
        return 0, torch.bfloat16, True
    m = re.fullmatch(r"seed(\d+)", arm)
    if m is None:
        raise ValueError(f"arm {arm!r}: want seed<K>, f32 or f32conv")
    return int(m.group(1)), torch.bfloat16, False


def raw_eval_trainer(base, record):
    """A subclass of the Trainer `base` that, after each epoch's EMA
    evaluation of val and test, evaluates the raw weights on the same
    batches with the same running statistics, appending to
    record['validation_loss'] and record['test_loss']."""

    class RawEvalTrainer(base):
        def _eval_epoch(self, ds, seed):
            loss = super()._eval_epoch(ds, seed)
            if seed >= 2000:  # fit's val (2000 + epoch) and test (3000 + epoch) passes
                step = make_eval_step(self.unet_cfg, use_ema=False, compute_dtype=self.compute_dtype, masked=True,
                                      channels_last=self.channels_last)
                perm, masks = self._epoch_indices(ds, seed)
                raw = float(eval_epoch(step, self.state, *self._arrays(ds), perm, masks))
                split = "validation_loss" if seed < 3000 else "test_loss"
                record[split].append(raw)
                print(f"raw weights, epoch {self.epoch + 1}: {split} {raw:.6e}", flush=True)
            return loss

    return RawEvalTrainer


_CONV_PAD1 = unet_mod._conv_pad1


def _conv_pad1_f32_out(x, w, halo=None):
    """The DoubleConv's conv with a float32 output: x and w arrive in
    bfloat16, whose values float32 holds exactly."""
    return _CONV_PAD1(x.float(), w.float(), halo)


@contextlib.contextmanager
def f32_conv_outputs():
    """Within: every 3x3 conv of ``unet_apply`` gives float32 out of
    bfloat16 inputs and weights, TF32 off."""
    tf32 = torch.backends.cudnn.allow_tf32
    unet_mod._conv_pad1, torch.backends.cudnn.allow_tf32 = _conv_pad1_f32_out, False
    try:
        yield
    finally:
        unet_mod._conv_pad1, torch.backends.cudnn.allow_tf32 = _CONV_PAD1, tf32


def log_precision(values):
    """The losses as the Trainer's log prints them (6 decimals), which the
    replay test reads."""
    return [float(f"{v:.6f}") for v in values]


def held_out_mm(test_loss: float, config: dict) -> float:
    lo, hi = config["depth_normalization_parameters"][:2]
    return float(np.sqrt(test_loss) * (hi - lo) / config["norm_scale"])


def verdict(val, test, config: dict) -> dict:
    """The stable-tail verdict and the val minimum of one loss trajectory,
    on the log's precision; the held-out mm from the test loss at the best
    val epoch, at full precision."""
    v = log_precision(val)
    best = int(np.argmin(v))
    lowest = sorted(v)
    tail = float(np.median(v[-TAIL:]))
    return {
        "stable_tail_ratio": tail / lowest[0],
        "stable_tail_holds": tail <= TAIL_RULE * lowest[0],
        "val_tail_median": tail,
        "val_min": lowest[0],
        "val_second": lowest[1],
        "val_min_epoch": best + 1,
        "held_out_mm": held_out_mm(test[best], config),
    }


def run_arm(arm: str, out: str = OUT, **run_kw) -> dict:
    """One arm through the recipe's ``run()``; run_kw reaches it (epochs,
    corpus sizes, and device, dims, image_size for tests at a small size).
    Returns and writes ``<out>/<arm>/study.json``."""
    recipe = _load_recipe()
    seed, dtype, f32conv = arm_settings(arm)
    dims = run_kw.get("dims", recipe.FLAGSHIP_DIMS)
    weights = starting_weights(recipe.make_config("x", dims=dims).unet_config(), seed)
    raw = {"validation_loss": [], "test_loss": []}
    arm_out = os.path.join(out, arm)
    recipe.Trainer = raw_eval_trainer(recipe.Trainer, raw)
    with f32_conv_outputs() if f32conv else contextlib.nullcontext():
        summary, history = recipe.run(f"unet_synth_convergence_{arm}", out=arm_out, compute_dtype=dtype,
                                      starting_weights=weights, **run_kw)
    with open(os.path.join(arm_out, f"unet_synth_convergence_{arm}.json")) as f:
        config = json.load(f)
    study = {
        "arm": arm, "init_seed": seed, "compute_dtype": str(dtype).replace("torch.", ""),
        "f32_conv_outputs": f32conv, "device": summary["device"], "epochs": summary["epochs"],
        "train_median_last10": float(np.median(history["train_loss"][-TRAIN_WINDOW:])),
        "ema": verdict(history["validation_loss"], history["test_loss"], config),
        "raw": verdict(raw["validation_loss"], raw["test_loss"], config),
        "history": {**history, "raw_validation_loss": raw["validation_loss"], "raw_test_loss": raw["test_loss"]},
        "summary": summary,
    }
    with open(os.path.join(arm_out, "study.json"), "w") as f:
        json.dump(study, f, indent=1)
    return study


def committed_row() -> dict:
    """The committed seed-0 run (EMA only), from its log and summary."""
    with open(COMMITTED + "_summary.json") as f:
        summary = json.load(f)
    with open(COMMITTED + ".json") as f:
        config = json.load(f)
    with open(COMMITTED + ".txt") as f:
        losses = [[float(x) for x in re.findall(r"[\d.]+(?:e-?\d+)?", line)]
                  for line in f if line.startswith("Train loss:")]
    train, val, test = (list(c) for c in zip(*losses))
    row = verdict(val, test, config)
    row["held_out_mm"] = held_out_mm(summary["test_loss_at_best_val"], config)  # the log's 6 decimals lose it
    return {"arm": "seed0 (committed)", "device": summary["device"], "epochs": len(val),
            "train_median_last10": float(np.median(train[-TRAIN_WINDOW:])), "ema": row, "raw": None}


def report(out: str = OUT) -> str:
    rows = [committed_row()]
    for path in sorted(glob.glob(os.path.join(out, "*", "study.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    lines = ["| arm | weights | stable tail (median/min) | val min (epoch) | val 2nd | train median, last 10 "
             "| held-out mm | device |", "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        for which in ("ema", "raw"):
            v = r[which]
            if v is None:
                continue
            lines.append(f"| {r['arm']} | {which} | {v['stable_tail_ratio']:.2f} "
                         f"({'holds' if v['stable_tail_holds'] else 'fails'}) | {v['val_min']:.2e} "
                         f"({v['val_min_epoch']}) | {v['val_second']:.2e} | {r['train_median_last10']:.3e} "
                         f"| {v['held_out_mm']:.4f} | {r['device']} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arm", action="append", default=[], help="seed<K>, f32 or f32conv; repeat to run several")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--train_duals", type=int, default=2500)
    ap.add_argument("--eval_duals", type=int, default=300)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--report", action="store_true", help="print the arms under --out beside the committed run")
    args = ap.parse_args()
    for arm in args.arm:
        study = run_arm(arm, args.out, epochs=args.epochs, train_duals=args.train_duals, eval_duals=args.eval_duals)
        print(json.dumps({k: study[k] for k in ("arm", "device", "train_median_last10", "ema", "raw")}), flush=True)
    if args.report:
        print(report(args.out), flush=True)


if __name__ == "__main__":
    main()
