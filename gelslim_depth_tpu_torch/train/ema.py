"""Exponential moving average of parameters as a pure update, the port of
``gelslim_depth_tpu/train/ema.py`` (torch_ema.ExponentialMovingAverage
semantics; the reference updates it after every optimizer step and
validates, tests and checkpoints under the averaged weights, ref
train_utils/train_unet.py:309,376,389,480-483):

- decay ramp: with use_num_updates, the decay at update t (counted after
  the increment) is min(decay, (1 + t) / (10 + t));
- update: shadow <- shadow - (1 - d) * (shadow - param), over trainable
  parameters only; BatchNorm running statistics ride along from the live
  model, as torch_ema tracks only parameters that require grad.

The count stays a device tensor, so an update needs no host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class EmaState:
    shadow: Dict[str, torch.Tensor]  # mirrors the parameters
    num_updates: torch.Tensor  # int32 scalar, -1 when the ramp is off
    decay: float


def ema_init(params: Dict[str, torch.Tensor], decay: float = 0.995, use_num_updates: bool = True) -> EmaState:
    device = next(iter(params.values())).device
    return EmaState(
        shadow={k: v.detach().clone() for k, v in params.items()},
        num_updates=torch.tensor(0 if use_num_updates else -1, dtype=torch.int32, device=device),
        decay=float(decay),
    )


@torch.no_grad()
def ema_update(state: EmaState, params: Dict[str, torch.Tensor]) -> EmaState:
    on = state.num_updates >= 0
    n = torch.where(on, state.num_updates + 1, state.num_updates)
    ramp = (1.0 + n.float()) / (10.0 + n.float())
    d = torch.where(on, torch.clamp(ramp, max=state.decay), torch.full_like(ramp, state.decay))
    keys = list(state.shadow)
    shadow = [state.shadow[k] for k in keys]
    diff = torch._foreach_sub(shadow, [params[k] for k in keys])
    torch._foreach_mul_(diff, 1.0 - d)
    return EmaState(shadow=dict(zip(keys, torch._foreach_sub(shadow, diff))), num_updates=n, decay=state.decay)
