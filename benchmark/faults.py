"""Faults planted in the timed path, under the serving call: each wraps the
program's ``inference.fused_predict_dual`` (which every predictor's
``predict_dual_frames`` calls) so that a run's comparison is seen to come
out not correct. ``calibrate.py --faults`` reads them on the card at a
cell's own size; ``tests/test_bench_correct.py`` plants them on the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def half_batch(depth_fn):
    """Half of each call's dual frames left out: the other half's depth
    stands in for them."""
    def broken(config, net, frames, base, size, **kw):
        half = max(1, frames.shape[0] // 2)
        out = depth_fn(config, net, frames[:half], base, size, **kw)
        return torch.cat([out] * (frames.shape[0] // half + 1))[: frames.shape[0]]
    return broken


def swapped_answer(depth_fn):
    """One answer altered where it is produced: the first dual frame of
    each call gets the depth of the dual frame before it, the last of the
    call before (a call of one dual frame answers the frame before)."""
    last = []

    def broken(config, net, frames, base, size, **kw):
        out = depth_fn(config, net, frames, base, size, **kw)
        before = last[0] if last else out[:1]
        last[:] = [out[-1:].clone()]
        return torch.cat([before, out[1:]])
    return broken


def stale_input(depth_fn):
    """Every call answers the first call's frames, as a replayed capture
    whose input buffer is never refilled would."""
    first = []

    def broken(config, net, frames, base, size, **kw):
        if not first:
            first.append(frames.clone())
        return depth_fn(config, net, first[0], base, size, **kw)
    return broken


FAULTS = {f.__name__: f for f in (half_batch, swapped_answer, stale_input)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in the program's serving call for the block."""
    from gelslim_depth_tpu_torch import inference

    keep = inference.fused_predict_dual
    inference.fused_predict_dual = FAULTS[name](keep)
    try:
        yield
    finally:
        inference.fused_predict_dual = keep
