"""The U-Net's activations by name (the reference's ``activation`` knob),
below every user: the U-Net's graphs and the kernels' plain twins."""

import torch
import torch.nn.functional as F

_ACTIVATIONS = {"relu": F.relu, "tanh": torch.tanh, "mish": lambda x: x * torch.tanh(F.softplus(x))}


def activation_fn(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation {name!r}; expected relu|tanh|mish")
    return _ACTIVATIONS[name]
