"""Checkpoints in the JAX package's formats
(``gelslim_depth_tpu/train/checkpoint.py``), read and written:
- ``save_weights`` / ``load_checkpoint``: ``<name>.npz`` + ``<name>.json``
  (and optionally ``config_<name>.py`` and a reference-layout ``<name>.pth``);
- ``save_train_state`` / ``load_train_state``: the full resumable state
  (parameters, statistics, Adam moments and count, EMA shadow, count and
  decay, step) in ``<name>.npz`` under the JAX package's keys, optax's
  ``opt_state/1/.mu/...`` included, so a run saved by either package
  resumes in the other; written atomically and durably;
- ``save_quantized`` / ``load_quantized``: ``<name>_int8.npz`` +
  ``<name>_int8.json``, the int8 model of ``models/quantize.py``.

Each ``.npz`` is flat, keyed by pytree paths (``params/inc/conv1_w``,
``batch_stats/up_0/bn2_var``, ``w8/up_1/conv2``, ...) in the JAX package's
layouts (HWIO conv kernels); ``models.params_to_jax`` and
``models.params_from_jax`` convert them to and from the port's state dict.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch.config import GelslimConfig


def replace_durable(tmp: str, path: str) -> None:
    """os.replace(tmp, path) with fsync of the data and the directory:
    atomic against preemption and durable against a host crash, which
    could otherwise surface a zero-length file at the final path."""
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        # the directory fsync is best effort (some filesystems refuse it);
        # the data fsync already bounds the damage to a lost rename
        pass


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


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


def save_weights(
    ckpt_dir: str,
    config: GelslimConfig,
    state_dict,
    *,
    name: str = None,
    emit_torch_pth: bool = True,
    emit_python_config: bool = True,
) -> str:
    """The reference's checkpoint unit: weights + frozen config. Writes
    <dir>/<name>.npz and <name>.json, which the JAX package's
    ``load_checkpoint`` reads, and optionally config_<name>.py and the
    reference-layout <name>.pth. state_dict is reference-layout."""
    from gelslim_depth_tpu_torch.models.torch_import import params_to_jax

    name = name or config.weights_name
    os.makedirs(ckpt_dir, exist_ok=True)
    params, stats = params_to_jax(state_dict, config.unet_config())
    np.savez(os.path.join(ckpt_dir, f"{name}.npz"),
             **_flatten(params, "params/"), **_flatten(stats, "batch_stats/"))
    config.save_json(os.path.join(ckpt_dir, f"{name}.json"))
    if emit_python_config:
        config.emit_python_config(os.path.join(ckpt_dir, f"config_{name}.py"))
    if emit_torch_pth:
        torch.save({k: torch.as_tensor(v).detach().cpu().float() for k, v in state_dict.items()
                    if not k.endswith("num_batches_tracked")},
                   os.path.join(ckpt_dir, f"{name}.pth"))
    return os.path.join(ckpt_dir, f"{name}.npz")


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
        # train-state files and the Trainer's resume sidecar are no candidates
        if f.endswith(".json") and not f.endswith(("state.json", "_loop.json"))
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


def save_quantized(ckpt_dir: str, config: GelslimConfig, q, *, name: str = None) -> str:
    """Persist a ``QuantizedUNet`` so serving can skip re-calibration: one
    <name>_int8.npz holding the float params/stats, the int8 weights (HWIO,
    or the JAX row-split pack for an upconv) with their scales, the static
    activation scales as JSON bytes, and the calibration fitness delta, plus
    the frozen config in <name>_int8.json (its own name, so that it never
    clobbers a float checkpoint's <name>.json)."""
    from gelslim_depth_tpu_torch.models.quantize import hwio_from_ohwi, rowsplit_to_jax
    from gelslim_depth_tpu_torch.models.torch_import import params_to_jax

    name = name or config.weights_name
    os.makedirs(ckpt_dir, exist_ok=True)
    params, stats = params_to_jax(q.net.state_dict(), q.cfg)
    flat = {**_flatten(params, "params/"), **_flatten(stats, "batch_stats/")}
    for site in q.sites:
        w = q.w8(site).cpu()
        w = rowsplit_to_jax(w, q.cfg.upconv_stride) if site.endswith("/upconv") else hwio_from_ohwi(w)
        flat[f"w8/{site}"] = w.numpy()
        flat[f"w_scale/{site}"] = q.w_scale(site).cpu().numpy()
    flat["float_delta"] = np.asarray(np.float32(q.float_delta.item()))
    flat["act_scale_json"] = np.frombuffer(json.dumps(q.act_scales()).encode(), dtype=np.uint8)
    path = os.path.join(ckpt_dir, f"{name}_int8.npz")
    np.savez(path, **flat)
    config.save_json(os.path.join(ckpt_dir, f"{name}_int8.json"))
    return path


def load_quantized(ckpt_dir: str, name: str = None):
    """Load a save_quantized artifact, the port's or the JAX package's ->
    (config, QuantizedUNet on the CPU)."""
    from gelslim_depth_tpu_torch.models.quantize import (
        QuantizedUNet, _quantized_sites, ohwi_from_hwio, rowsplit_from_jax,
    )
    from gelslim_depth_tpu_torch.models.torch_import import params_from_jax
    from gelslim_depth_tpu_torch.models.unet import UNet

    if name is None:
        cands = sorted(f[:-9] for f in os.listdir(ckpt_dir) if f.endswith("_int8.npz"))
        if not cands:
            raise FileNotFoundError(f"no *_int8.npz quantized artifact in {ckpt_dir}")
        if len(cands) > 1:
            raise ValueError(f"ambiguous quantized artifacts in {ckpt_dir}: {cands}; pass name=")
        name = cands[0]
    cfg_path = os.path.join(ckpt_dir, f"{name}_int8.json")
    if not os.path.exists(cfg_path):  # artifacts from before the rename
        cfg_path = os.path.join(ckpt_dir, f"{name}.json")
    config = GelslimConfig.from_json(cfg_path)
    unet_cfg = config.unet_config()
    with np.load(os.path.join(ckpt_dir, f"{name}_int8.npz")) as z:
        flat = {k: z[k] for k in z.files}
    w8, w_scale = {}, {}
    # the sites the artifact carries, with or without int8 upconvs
    for key in flat:
        if key.startswith("w8/"):
            site = key[len("w8/"):]
            scale_key = f"w_scale/{site}"
            if scale_key not in flat:
                raise KeyError(
                    f"quantized artifact {name}_int8.npz carries {key} but "
                    f"not {scale_key} — truncated or corrupt file?"
                )
            t = torch.from_numpy(np.array(flat[key]))
            w8[site] = rowsplit_from_jax(t) if site.endswith("/upconv") else ohwi_from_hwio(t)
            w_scale[site] = torch.from_numpy(np.array(flat[scale_key], dtype=np.float32))
    # ... but a valid artifact carries at least every baseline conv site
    missing = [f"w8/{b}/{c}" for b, c in _quantized_sites(unet_cfg) if f"{b}/{c}" not in w8]
    if missing:
        raise KeyError(
            f"quantized artifact {name}_int8.npz is missing int8 weight "
            f"arrays {missing} — truncated or corrupt file?"
        )
    if "act_scale_json" not in flat:
        raise KeyError(
            f"quantized artifact {name}_int8.npz is missing the "
            f"act_scale_json activation-scale record — truncated or "
            f"corrupt file?"
        )
    act_scale = json.loads(bytes(flat["act_scale_json"]).decode())
    net = UNet(unet_cfg)
    net.load_state_dict(params_from_jax(_unflatten(flat, "params/"), _unflatten(flat, "batch_stats/"), unet_cfg))
    # the baseline sites first, in the order the forward runs them
    order = [f"{b}/{c}" for b, c in _quantized_sites(unet_cfg)]
    sites = order + sorted(s for s in w8 if s not in order)
    return config, QuantizedUNet(
        net, {s: w8[s] for s in sites}, {s: w_scale[s] for s in sites},
        {k: float(v) for k, v in act_scale.items()}, float(flat["float_delta"]),
    )


# the optax chain (add_decayed_weights, scale_by_adam, scale) keeps its
# Adam state at index 1
_ADAM = "opt_state/1/."


def save_train_state(ckpt_dir: str, state, *, name: str = "train_state") -> str:
    """Full resumable state in the JAX package's ``save_train_state`` layout."""
    from gelslim_depth_tpu_torch.models.torch_import import to_jax_tree

    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {}
    for prefix, tree in (("params/", state.params), ("batch_stats/", state.batch_stats),
                         (f"{_ADAM}mu/", state.opt_state.mu), (f"{_ADAM}nu/", state.opt_state.nu),
                         ("ema_shadow/", state.ema.shadow)):
        flat.update(_flatten(to_jax_tree(tree), prefix))
    flat[f"{_ADAM}count"] = np.asarray(np.int32(state.opt_state.count.item()))
    flat["__num_updates"] = np.asarray(np.int32(state.ema.num_updates.item()))
    flat["__ema_decay"] = np.asarray(state.ema.decay)
    flat["__step"] = np.asarray(np.int32(state.step.item()))
    path = os.path.join(ckpt_dir, f"{name}.npz")
    tmp = os.path.join(ckpt_dir, f"{name}.tmp.npz")
    np.savez(tmp, **flat)
    replace_durable(tmp, path)
    return path


def load_train_state(ckpt_dir: str, *, name: str = "train_state", device="cpu"):
    """A ``save_train_state`` file of either package -> the port's
    ``TrainState`` on device."""
    from gelslim_depth_tpu_torch.models.torch_import import from_jax_tree
    from gelslim_depth_tpu_torch.train.ema import EmaState
    from gelslim_depth_tpu_torch.train.steps import AdamState, TrainState

    with np.load(os.path.join(ckpt_dir, f"{name}.npz")) as z:
        flat = {k: z[k] for k in z.files}

    def tree(prefix):
        return {k: v.to(device) for k, v in from_jax_tree(_unflatten(flat, prefix)).items()}

    def count(key):
        return torch.tensor(int(flat[key]), dtype=torch.int32, device=device)

    return TrainState(
        params=tree("params/"),
        batch_stats=tree("batch_stats/"),
        opt_state=AdamState(count(f"{_ADAM}count"), tree(f"{_ADAM}mu/"), tree(f"{_ADAM}nu/")),
        ema=EmaState(tree("ema_shadow/"), count("__num_updates"), float(flat["__ema_decay"])),
        step=count("__step"),
    )
