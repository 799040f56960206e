"""Helpers shared by the port's CPU tests (`tests/test_torch_*.py`)."""

import collections
import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op CPU threads set to n for the block. The suite runs
    in several worker processes on one machine; each torch op spreading
    over every core in each of them oversubscribes the cores, and OpenMP's
    waiting threads then slow the ops by orders of magnitude."""
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


# -- the transformers' heads: the conv biases and conv_epilogue ------------------


def previous_residual_unit(m, x):
    """A ``ResidualConvUnit`` as it ran before its second conv's bias and
    skip add became one ``conv_epilogue``: that conv with its bias, then
    ``+ x``."""
    from gelslim_depth_tpu_torch.models.dpt import _bias_relu

    h = _bias_relu(F.conv2d(torch.relu(x), m.conv1.weight, padding=1), m.conv1_scale, m.conv1_shift)
    return F.conv2d(h, m.conv2.weight, m.conv2.bias, padding=1) + x


def previous_fusion_block(m, x, skip, size=None):
    """A ``FeatureFusionBlock`` as it ran before: its residual units as
    ``previous_residual_unit``, its 1x1 ``out_conv`` with its bias."""
    from gelslim_depth_tpu_torch.models import dpt

    if skip is not None:
        x = x + previous_residual_unit(m.resConfUnit1, skip)
    x = previous_residual_unit(m.resConfUnit2, x)
    if m.deconv is not None:
        x = F.conv_transpose2d(x, m.deconv.weight, stride=2)
    elif size is not None:
        x = dpt.bilinear_resize(x, size)
    return F.conv2d(x, m.out_conv.weight, m.out_conv.bias)


@contextlib.contextmanager
def conv_calls():
    """Records each ``F.conv2d`` and ``F.conv_transpose2d`` call made in
    the block: (the function's name, whether it was passed a bias)."""
    calls = []
    originals = F.conv2d, F.conv_transpose2d

    def spy(name, fn):
        def call(input, weight, bias=None, *args, **kwargs):
            calls.append((name, bias is not None))
            return fn(input, weight, bias, *args, **kwargs)
        return call

    F.conv2d, F.conv_transpose2d = spy("conv2d", originals[0]), spy("conv_transpose2d", originals[1])
    try:
        yield calls
    finally:
        F.conv2d, F.conv_transpose2d = originals


def card_route(monkeypatch):
    """The transformers' head convs with their biases in ``conv_epilogue``,
    as on the card, on the CPU too (where the op's CPU implementation,
    aten's adds, computes them)."""
    from gelslim_depth_tpu_torch.models import dpt

    monkeypatch.setattr(dpt, "_epilogue_bias", lambda x: True)


def spy_epilogues(monkeypatch, *modules):
    """Counts the ``conv_epilogue`` calls that the modules make, by form
    (``residual``, ``bias``, ``bn``), then runs the op."""
    from gelslim_depth_tpu_torch.ops.kernels.conv_epilogue import conv_epilogue

    forms = collections.Counter()

    def spy(y, **kw):
        forms["residual" if kw.get("residual") is not None else "bias" if kw.get("bias") is not None else "bn"] += 1
        return conv_epilogue(y, **kw)

    for module in modules:
        monkeypatch.setattr(module, "conv_epilogue", spy)
    return forms
