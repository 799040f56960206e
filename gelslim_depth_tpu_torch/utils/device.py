"""The port's device rule: entry points run on ``cuda`` unless the caller
passes another device, and raise when asked for a card that is not there
rather than run on the CPU."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def device_from_gpu_arg(gpu: Optional[str]) -> str:
    """The reference commands' ``gpu`` positional (ref train_unet.py:58) as
    a device: 'cpu' selects the CPU, an ordinal n selects cuda:n, and no
    argument selects cuda. Anything else, 'tpu' included, raises."""
    if gpu is None:
        return "cuda"
    if gpu == "cpu":
        return "cpu"
    if gpu.isdigit():
        return f"cuda:{int(gpu)}"
    raise ValueError(f"device {gpu!r}: want 'cpu' or a CUDA ordinal (0, 1, ...)")
