"""Checkpoint loading: the ``<name>.npz`` + ``<name>.json`` pair that the
JAX package's ``train/checkpoint.py::save_weights`` writes.

The ``.npz`` is flat, keyed by pytree paths (``params/inc/conv1_w``,
``batch_stats/up_0/bn2_var``, ...); it is unflattened here by key name into
nested dicts of numpy arrays, the layout ``models.params_from_jax`` reads.
The save side is not ported yet.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Tuple

import numpy as np

from gelslim_depth_tpu_torch.config import GelslimConfig


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _resolve_checkpoint_name(ckpt_dir: str) -> str:
    """Pick the checkpoint name in a save_weights directory.

    Directories produced by long runs legitimately contain the best-val
    checkpoint PLUS epoch-pinned snapshots `<name>_epoch<e>` (ref
    train_unet.py:485-490 policy), so "exactly one .json" is wrong. Rule:
    if one candidate is the bare weights_name and every other candidate is
    that name plus an `_epoch<N>` suffix, prefer the bare name (the
    best-validation weights). Anything else is genuinely ambiguous."""
    cands = sorted(
        f[:-5]
        for f in os.listdir(ckpt_dir)
        if f.endswith(".json") and not f.endswith("state.json")
    )
    if not cands:
        raise FileNotFoundError(f"no checkpoint .json in {ckpt_dir}")
    if len(cands) == 1:
        return cands[0]
    bases = {re.sub(r"_epoch\d+$", "", c) for c in cands}
    if len(bases) == 1:
        base = bases.pop()
        if base in cands:
            return base
        # only epoch-pinned snapshots: take the latest epoch
        return max(cands, key=lambda c: int(re.search(r"_epoch(\d+)$", c).group(1)))
    raise ValueError(f"ambiguous checkpoint dir {ckpt_dir}: {cands}; pass name=")


def load_checkpoint(ckpt_dir: str, name: str = None) -> Tuple[GelslimConfig, Any, Any]:
    """Load (config, params, batch_stats) from a save_weights directory;
    params and batch_stats are nested dicts of numpy arrays."""
    if name is None:
        name = _resolve_checkpoint_name(ckpt_dir)
    config = GelslimConfig.from_json(os.path.join(ckpt_dir, f"{name}.json"))
    with np.load(os.path.join(ckpt_dir, f"{name}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return config, _unflatten(flat, "params/"), _unflatten(flat, "batch_stats/")
