"""The port's entry point: fused dual-GelSlim serving on the flagship model
(the unet_bigdata-shape U-Net, 320x427 frames in, mm depth out), the
counterpart of ``__graft_entry__.entry``.

    fn, (frames, base) = entry()
    depth_mm = fn(frames, base)   # (2, 2, 320, 427), bfloat16 U-Net

Runs on ``cuda`` unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import numpy as np
import torch

from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor
from gelslim_depth_tpu_torch.models.unet import init_unet

FRAME = (320, 427)


def flagship_config() -> GelslimConfig:
    """The flagship serving config, field for field
    ``__graft_entry__._flagship_config()``."""
    return GelslimConfig(
        CNN_dimensions=(64, 128, 256, 512, 1024),
        input_tactile_image_size=(160, 213),
        image_normalization_method="0_255_to_0_1",
        depth_normalization_method="min_max_to_0_-1",
        depth_normalization_parameters=(-1.9180814027786255, 0.0),
        norm_scale=0.9,
        use_difference_image=True,
    )


def entry(device=None):
    """Returns (fn, (frames, base)): fn(frames, base) -> (N, 2, 320, 427) mm
    depth from raw (N, 6, 320, 427) dual-sensor frames and a (6, 320, 427)
    base frame, through a bfloat16 ``Predictor`` with seed-0 weights
    (``init_unet``: the JAX package's initializer's distribution, not its
    values). The example frames are the JAX entry's, on the device."""
    config = flagship_config()
    params, stats = init_unet(config.unet_config(), torch.Generator().manual_seed(0))
    pred = Predictor(config, {**params, **stats}, compute_dtype=torch.bfloat16, device=device)

    def fn(frames, base):
        return pred.predict_dual_frames(frames, base, FRAME)

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.uniform(0, 255, (2, 6, *FRAME)).astype(np.float32)).to(pred.device)
    base = torch.from_numpy(rng.uniform(0, 255, (6, *FRAME)).astype(np.float32)).to(pred.device)
    return fn, (frames, base)
