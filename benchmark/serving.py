"""What every serving loop shares: the program's predictor for a
configuration, the seeded inputs it serves, the plain reference of the
same model, and the comparison of the depth the window's calls produced
against the reference's (``compare_depth``), which decides ``correct``.

The program is ``gelslim_depth_tpu_torch``; the reference
(``benchmark/reference``) takes nothing the program made: it works the
int8 scheme's quantization out again from the same weights and
calibration dual frames.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from benchmark import inputs
from benchmark.reference import serving as ref_serving

REFERENCE_BLOCK = 8  # dual frames a reference pass


def gelslim_config(cfg: dict):
    """The program's ``GelslimConfig`` for a configuration file's fields."""
    from gelslim_depth_tpu_torch import GelslimConfig

    fields = {f.name for f in dataclasses.fields(GelslimConfig)}
    return GelslimConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields})


def serving_system(cell, sd, calib_frames, base, device):
    """The program's predictor for the configuration: ``Predictor`` in the
    compute dtype, quantized through ``Predictor.quantize`` on the
    calibration dual frames for int8."""
    from gelslim_depth_tpu_torch import Predictor

    cfg = cell.config
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]
    pred = Predictor(gelslim_config(cfg), {k: v.clone() for k, v in sd.items()}, compute_dtype=dtype, device=device)
    if cfg["precision"] == "int8":
        return pred.quantize(calib_frames, base)
    return pred


def serving_reference(cell, sd, calib_frames, base):
    """(the reference's predict, the predict of its plain bfloat16
    computation or None): the float32 U-Net, with the int8 scheme's
    quantization worked out again for int8; for bf16 also the same model
    computed in bfloat16, whose error against the float32 one is the
    scale the comparison is stated in."""
    cfg = cell.config
    quant = ref_serving.calibrate(cfg, sd, calib_frames, base, 127) if cfg["precision"] == "int8" else None
    scale = None
    if cfg["precision"] == "bf16":
        def scale(frames):
            return ref_serving.predict(cfg, sd, frames, base, dtype=torch.bfloat16)
    return (lambda frames: ref_serving.predict(cfg, sd, frames, base, quant)), scale


def serving_inputs(cell, seed: int, device) -> Tuple[List, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(pool of call inputs, base frame, calibration dual frames, state
    dict): one sensor's session, its first dual frames the pool's and its
    last the calibration's, and the weights. The pool's inputs sit on the
    card or, as numpy arrays, on the host (the traffic's ``inputs_on``)."""
    cfg, tr = cell.config, cell.traffic
    n, pool, n_cal = tr["dual_frames_per_call"], tr["pool"], cfg["calibration_dual_frames"]
    frames, base, _ = inputs.session(inputs.generator(device, seed, inputs.FRAMES), n * pool + n_cal,
                                     tuple(cfg["frame_size"]), device)
    calib = frames[n * pool:].clone()
    if tr["inputs_on"] == "host":
        pool_inputs = [frames[i * n:(i + 1) * n].cpu().numpy() for i in range(pool)]
    else:
        pool_inputs = [frames[i * n:(i + 1) * n].clone() for i in range(pool)]
    del frames
    sd = inputs.serving_weights(cfg, inputs.generator(device, seed, inputs.WEIGHTS), device)
    return pool_inputs, base, calib, sd


def _lost(checked: int) -> Dict[str, float]:
    return {"worst_frame_rmse_mm": math.inf, "worst_frame_own_ratio": math.inf, "mean_error_excess": math.inf,
            "frames_checked": checked}


def compare_depth(kept, pool_inputs, predict_ref, device, predict_scale=None) -> Dict[str, float]:
    """The depth of the kept calls (pairs of a pool index and the call's
    output) against the reference's, in blocks of ``REFERENCE_BLOCK``
    dual frames. An output that is misshapen or not finite reads
    infinite in every number.

    - ``worst_frame_rmse_mm``: the largest RMSE in mm of one checked dual
      frame's depth against the reference's.
    - ``worst_frame_own_ratio``: the largest, over the checked dual
      frames, of the RMSE of that frame's error less the mean error of all
      checked frames, over the RMSE of the reference's depths about their
      mean. A model's rounding error is mostly a pattern that every frame
      shares, and the mean takes it out; what is left is the error that
      belongs to the frame. An answer that belongs to another frame (a
      swapped, stale or left-out one) reads about 1 or more, however
      close the frames' depths lie in mm.
    - with predict_scale, ``mean_error_excess``: the RMSE of the mean
      error of the checked frames over the same of predict_scale's depth,
      less 1 (a plain bfloat16 computation's own error reads 0). The mean
      keeps the pattern that a model's rounding lays on every frame and
      averages out what the rounding of a frame's own input adds, so a
      coarser computation's pattern shows however much the frames differ.

    Besides, as counts: the RMSE over all of them, the frames checked,
    and the RMSE of the reference's depths about their mean."""
    errors, wants = [], []
    scale_error_sum = None
    checked = 0
    for idx, out in kept:
        frames = torch.as_tensor(pool_inputs[idx], device=device)
        got = torch.as_tensor(out)
        if got.shape[:1] != frames.shape[:1]:
            return _lost(checked)
        for s in range(0, frames.shape[0], REFERENCE_BLOCK):
            want = predict_ref(frames[s:s + REFERENCE_BLOCK])
            g = got[s:s + REFERENCE_BLOCK].to(want.device, torch.float32)
            if g.shape != want.shape:
                return _lost(checked)
            err = g - want
            errors.append(err)
            wants.append(want)
            checked += want.shape[0]
            if predict_scale is not None:
                scale_err = (predict_scale(frames[s:s + REFERENCE_BLOCK]) - want).sum(dim=0)
                scale_error_sum = scale_err if scale_error_sum is None else scale_error_sum + scale_err
    if not checked:
        return _lost(0)
    err, want = torch.cat(errors), torch.cat(wants)
    del errors, wants

    def finite(t):
        return torch.nan_to_num(t, nan=math.inf)

    per_frame = finite(torch.sqrt(torch.mean(torch.square(err), dim=(1, 2, 3))))
    own = torch.sqrt(torch.mean(torch.square(err - err.mean(dim=0)), dim=(1, 2, 3)))
    spread = float(torch.sqrt(torch.mean(torch.square(want - want.mean(dim=0)))))
    out = {"worst_frame_rmse_mm": float(per_frame.max()),
           "worst_frame_own_ratio": float(finite(own).max()) / spread if spread > 0 else math.inf,
           "depth_rmse_mm": float(finite(torch.sqrt(torch.mean(torch.square(err))))),
           "depth_spread_mm": spread,
           "frames_checked": checked}
    if scale_error_sum is not None:
        mean_scale = float(torch.sqrt(torch.mean(torch.square(scale_error_sum / checked))))
        mean_err = float(finite(torch.sqrt(torch.mean(torch.square(err.mean(dim=0))))))
        out["mean_error_excess"] = mean_err / mean_scale - 1.0
    return out
