"""The port's device rule: entry points run on ``cuda`` unless the caller
passes another device, and raise when asked for a card that is not there
rather than run on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev
