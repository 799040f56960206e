"""``.pt`` tensor-dict files, read and written with torch.

The reference's datasets are dicts of tensors written by ``torch.save``
(ref README.md:33-44, general_dataset.py:64). The port's counterpart of
``gelslim_depth_tpu/data/pt_io.py``: ``load_pt`` reads what either of the
JAX package's writers makes (``torch.save``, and the hand-pickled zip of
``_save_pt_torchfree``, bfloat16 included) with ``torch.load(weights_only=True)``;
``save_pt`` writes a ``torch.save`` archive, which the JAX package's
torch-free reader parses. The JAX package's native C++ bulk reader is not
carried: it lives in ``gelslim_depth_tpu.native``, which the port does not
import.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def load_pt(path: str) -> Dict[str, Any]:
    """A ``.pt`` dict -> a dict of CPU tensors (other values as stored)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_pt(obj: Dict[str, Any], path: str) -> None:
    """Save a dict of arrays or tensors as a torch-loadable ``.pt``."""

    def to_tensor(v):
        if not isinstance(v, np.ndarray):
            return v
        return torch.from_numpy(np.array(v))  # a contiguous, writable copy

    torch.save({k: to_tensor(v) for k, v in obj.items()}, path)
