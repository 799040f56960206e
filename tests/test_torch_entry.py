"""The port's entry point (gelslim_depth_tpu_torch/entry.py) against
__graft_entry__.py: the flagship config field for field, and the
(fn, args) contract. The full-width forward runs only on the card."""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__
from gelslim_depth_tpu_torch.entry import entry, flagship_config
from gelslim_depth_tpu_torch.ops.kernels import fused_preprocess_dual


def test_flagship_config_matches_graft_entry():
    ours, theirs = dataclasses.asdict(flagship_config()), dataclasses.asdict(__graft_entry__._flagship_config())
    # the port's fields of its own, the transformers' widths and the post's
    # resize where it differs from the front end's, are unset for the U-Net
    for own in ("dpt", "depth_pro", "output_interp_method"):
        assert ours.pop(own) is None
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert ours[k] == (list(v) if isinstance(v, tuple) and isinstance(ours[k], list) else v), k


def test_entry_contract_on_cpu():
    fn, (frames, base) = entry(device="cpu")
    assert callable(fn)
    assert tuple(frames.shape) == (2, 6, 320, 427) and tuple(base.shape) == (6, 320, 427)
    assert frames.dtype == base.dtype == torch.float32
    assert frames.device.type == base.device.type == "cpu"
    rng = np.random.RandomState(0)  # the JAX entry's frames, drawn the same way
    np.testing.assert_array_equal(frames.numpy(), rng.uniform(0, 255, (2, 6, 320, 427)).astype(np.float32))
    np.testing.assert_array_equal(base.numpy(), rng.uniform(0, 255, (6, 320, 427)).astype(np.float32))


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.cuda
def test_cuda_entry_runs_the_flagship():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn, args = entry()
    before = fused_preprocess_dual.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, 2, 320, 427) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and float(out.max()) <= 0.0
    assert fused_preprocess_dual.launches == before + 1
