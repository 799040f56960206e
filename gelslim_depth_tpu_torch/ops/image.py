"""Difference-image op.

``get_difference_image`` re-centers a signed RGB difference into [0, 255]:
``((img - base) + 255) / 2`` (ref: processing_utils/image_utils.py:6-10).
The Gaussian depth blur is not on the serving path and is not ported yet.
"""

from __future__ import annotations

import torch


def get_difference_image(tactile_image: torch.Tensor, base_tactile_image: torch.Tensor) -> torch.Tensor:
    """Signed difference re-centered from [-255, 255] into [0, 255]."""
    return (tactile_image - base_tactile_image + 255.0) / 2.0
