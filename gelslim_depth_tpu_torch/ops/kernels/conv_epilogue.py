"""The epilogue of a float conv in one pass: the upconv's bias or the folded
eval BatchNorm, the activation, the rounding to the compute dtype and,
where an int8 conv reads the result, its int8 quantization.

``conv_epilogue`` checks its arguments and calls the custom op
``torch.ops.gelslim.conv_epilogue``, whose CUDA implementation launches
the hand-written kernel ``csrc/conv_epilogue.cu`` (the source's header says
what it replaces, what bounds it and how it is laid out) and whose CPU
implementation computes ``conv_epilogue_reference``, the chain of PyTorch
ops that the U-Net ran there before, op for op. There is no fallback from
the kernel to the plain version: on CUDA it launches or raises. As an op
it is traced by ``torch.export``. A plain CUDA tensor outside tracing
launches the op's CUDA implementation directly: the U-Net makes 22 of
these launches a bf16 call, and the custom op's dispatch in Python costs
more host time than the four aten ops each launch replaces, which bounds
a one-frame call.

The kernel reads ``y`` as it comes from the conv, NCHW-contiguous or
channels-last, and returns the compute-dtype result in the same layout, or
the int8 one NHWC. It takes the two forms the U-Net calls: an upconv's
bias, in y's dtype, with no activation; a BatchNorm's float32 vectors with
its activation. It rounds where the chain rounds (a bfloat16 bias add in
float32, then to bfloat16; the BatchNorm affine and the activation in
float32, then the cast) and quantizes as ``quant_act`` does, so the two
routes agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gelslim_depth_tpu_torch.ops.activation import activation_fn
from gelslim_depth_tpu_torch.ops.kernels.conv_int8 import ACTIVATIONS, quant_act


def bind(lib: ctypes.CDLL):
    """The C entry of a built csrc/conv_epilogue.cu, typed."""
    fn = lib.conv_epilogue
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 6 + [ll, i, ll, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    return bind(load_library("conv_epilogue"))


def channels_last(y: torch.Tensor) -> bool:
    """Whether the kernel reads y as NHWC in memory: channels-last and not
    NCHW-contiguous (where both hold, the two orders are one)."""
    return not y.is_contiguous() and y.is_contiguous(memory_format=torch.channels_last)


def _check(y, bias, bn_mul, bn_add, act, q_scale):
    if y.ndim != 4 or y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"y must be a float32 or bfloat16 (N, C, H, W) tensor, got {y.dtype} {tuple(y.shape)}")
    if not (y.is_contiguous() or y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("y must be NCHW-contiguous or channels-last")
    if act not in ACTIVATIONS:
        raise ValueError(f"act {act!r}: expected one of {ACTIVATIONS}")
    if bias is not None and bn_mul is None and bn_add is None:
        if act != "none":
            raise ValueError(f"a bias takes no activation, got act {act!r}")
        vectors = (("bias", bias, y.dtype),)
    elif bias is None and bn_mul is not None and bn_add is not None:
        if act == "none":
            raise ValueError("a BatchNorm takes an activation, got act 'none'")
        vectors = (("bn_mul", bn_mul, torch.float32), ("bn_add", bn_add, torch.float32))
    else:
        raise ValueError("give either bias, or bn_mul and bn_add")
    c = y.shape[1]
    for name, v, dtype in vectors:
        if v.dtype != dtype or v.numel() != c or v.device != y.device or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of {c} elements on {y.device}")
    if q_scale is not None and (q_scale.dtype != torch.float32 or q_scale.numel() != 1 or q_scale.device != y.device):
        raise ValueError(f"q_scale must be a float32 one-element tensor on {y.device}")


def conv_epilogue(
    y: torch.Tensor,  # float32 | bfloat16 (N, C, H, W), NCHW or channels-last
    *,
    bias: Optional[torch.Tensor] = None,    # y's dtype, C elements: (C,) or (1, C, 1, 1)
    bn_mul: Optional[torch.Tensor] = None,  # float32, C elements
    bn_add: Optional[torch.Tensor] = None,  # float32, C elements
    act: str = "none",
    q_scale: Optional[torch.Tensor] = None,  # float32, one element
) -> torch.Tensor:
    """One of the two epilogues the U-Net's float convs have: an upconv's
    ``y + bias`` (``act`` "none"), or a DoubleConv conv's ``act(y * bn_mul
    + bn_add)`` (``act`` relu, tanh or mish); rounded to y's dtype and
    returned in y's dtype and layout, or with ``q_scale`` quantized
    ``clamp(round(v / q_scale), -127, 127)`` into an int8 NHWC ``(N, H, W,
    C)`` tensor (``conv_epilogue_reference`` spells it out).

    On CUDA the op allocates the output with ``torch.empty`` and launches
    the kernel on the current stream without synchronizing; each launch
    adds one to ``conv_epilogue.launches`` (an empty y launches nothing).
    On the CPU it computes ``conv_epilogue_reference``. A tensor subclass
    (a fake tensor under ``torch.export``) or a compiling graph goes
    through the op's dispatch; a plain CUDA tensor launches at once."""
    _check(y, bias, bn_mul, bn_add, act, q_scale)
    if y.is_cuda and type(y) is torch.Tensor and not torch.compiler.is_compiling():
        return _launch(y, bias, bn_mul, bn_add, act, q_scale)
    return torch.ops.gelslim.conv_epilogue(y, bias, bn_mul, bn_add, act, q_scale)


conv_epilogue.launches = 0


def _out(y: torch.Tensor, q_scale: Optional[torch.Tensor]) -> torch.Tensor:
    if q_scale is None:
        return torch.empty_like(y)
    n, c, h, w = y.shape
    return y.new_empty((n, h, w, c), dtype=torch.int8)


@torch.library.custom_op("gelslim::conv_epilogue", mutates_args=(), device_types="cuda")
def _op(y: torch.Tensor, bias: Optional[torch.Tensor], bn_mul: Optional[torch.Tensor],
        bn_add: Optional[torch.Tensor], act: str, q_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel, on CUDA tensors that the public wrapper has checked."""
    return _launch(y, bias, bn_mul, bn_add, act, q_scale)


def _launch(y, bias, bn_mul, bn_add, act, q_scale):
    out = _out(y, q_scale)
    if out.numel():
        n, c, h, w = y.shape
        dev = y.get_device()
        err = _kernel_fn()(
            y.data_ptr(), out.data_ptr(), None if bias is None else bias.data_ptr(),
            None if bn_mul is None else bn_mul.data_ptr(), None if bn_add is None else bn_add.data_ptr(),
            None if q_scale is None else q_scale.data_ptr(), n, c, h * w, channels_last(y),
            y.dtype == torch.bfloat16, ACTIVATIONS.index(act), dev, torch._C._cuda_getCurrentRawStream(dev),
        )
        if err != 0:
            raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error {err}")
        conv_epilogue.launches += 1
    return out


@_op.register_kernel("cpu")
def _op_cpu(y, bias, bn_mul, bn_add, act, q_scale):
    return conv_epilogue_reference(y, bias=bias, bn_mul=bn_mul, bn_add=bn_add, act=act, q_scale=q_scale)


@_op.register_fake
def _op_fake(y, bias, bn_mul, bn_add, act, q_scale):
    return _out(y, q_scale)


def conv_epilogue_reference(y, *, bias=None, bn_mul=None, bn_add=None, act="none", q_scale=None):
    """Plain PyTorch composition of the same function (the kernel's twin),
    the U-Net's chain of ops: an upconv's ``y + bias``, or a DoubleConv's
    ``act(y * bn_mul + bn_add)`` cast to y's dtype, then ``quant_act`` of
    the NHWC result where ``q_scale`` is given."""
    _check(y, bias, bn_mul, bn_add, act, q_scale)
    c = (1, -1, 1, 1)
    if bias is not None:
        v = y + bias.view(c)
    else:
        v = activation_fn(act)(y * bn_mul.view(c) + bn_add.view(c)).to(y.dtype)
    if q_scale is None:
        return v
    return quant_act(v.permute(0, 2, 3, 1).contiguous(), q_scale)
