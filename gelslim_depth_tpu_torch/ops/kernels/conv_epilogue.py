"""The epilogue of a float conv in one pass: the conv's bias or the folded
eval BatchNorm, the activation, the rounding to the compute dtype and,
where an int8 conv reads the result, its int8 quantization; or the bias and
a residual unit's skip add.

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
the int8 one NHWC. It takes three forms. The U-Net calls two: an upconv's
bias, in y's dtype, with no activation; a BatchNorm's float32 vectors with
its activation. On the card the transformers' heads (``models/dpt.py``,
``models/depth_pro.py``), whose convs run on cuDNN without their bias,
call the bias form at every conv that has a bias but the residual units'
second, and there the residual form: the bias, then the unit's skip add of
``residual``, a tensor of y's shape, dtype and layout, each add rounded to
y's dtype as aten's two bf16 adds round (``round(round(y + bias) +
residual)``; one read of y and of the residual and one write, against the
three passes of aten's bias add and skip add). It rounds where the chain
rounds (a bfloat16 bias add in float32, then to bfloat16; the BatchNorm
affine and the activation in float32, then the cast) and quantizes as
``quant_act`` does, so the two routes agree bit for bit.

The destination form (``into``): the bias or BatchNorm form of a
channels-last y stores its result into one or two given views instead of
a tensor of its own, through a second custom op,
``gelslim::conv_epilogue_into``, which mutates them. The bf16 U-Net's last
epilogue of a level stores the skip into its own tensor and into the
lower channels of the up block's concat buffer, and the upconv's bias
epilogue into the upper channels at the pad offset, so no pad or concat
pass runs (``models/unet.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from gelslim_depth_tpu_torch.ops.activation import activation_fn
from gelslim_depth_tpu_torch.ops.kernels.conv_int8 import ACTIVATIONS, quant_act


def bind(lib: ctypes.CDLL):
    """The C entry of a built csrc/conv_epilogue.cu, typed."""
    fn = lib.conv_epilogue
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 7 + [ll, i, ll, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def bind_into(lib: ctypes.CDLL):
    """The destination form's C entry of a built csrc/conv_epilogue.cu, typed."""
    fn = lib.conv_epilogue_into
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 4 + [p, ll, ll, ll] * 2 + [ll, i, ll, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    return bind(load_library("conv_epilogue"))


@functools.cache
def _into_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    return bind_into(load_library("conv_epilogue"))


def channels_last(y: torch.Tensor) -> bool:
    """Whether the kernel reads y as NHWC in memory: channels-last and not
    NCHW-contiguous (where both hold, the two orders are one)."""
    return not y.is_contiguous() and y.is_contiguous(memory_format=torch.channels_last)


def _check_into(y, into):
    """Destinations of the destination form: one or two channels-last views
    of y's shape, dtype and device (channels contiguous, each of W, H and N
    strided past what it holds; any such strides), the channels starting at
    a multiple of 8 within their pixel; y channels-last."""
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("into takes a channels-last y")
    if len(into) not in (1, 2):
        raise ValueError(f"into takes one or two destinations, got {len(into)}")
    shape = y.shape
    for d in into:
        if not isinstance(d, torch.Tensor) or d.shape != shape or d.dtype != y.dtype or d.device != y.device:
            raise ValueError(f"a destination must be a {y.dtype} tensor of y's shape {tuple(shape)} on {y.device}")
        sn, sc, sh, sw = d.stride()
        if shape[1] > 1 and sc != 1:
            raise ValueError("a destination must be channels-last: its channels contiguous")
        held = shape[1]
        for size, stride in ((shape[3], sw), (shape[2], sh), (shape[0], sn)):  # W, H, N: each past all it holds
            if size > 1:
                if stride < held:
                    raise ValueError("a destination must be a channels-last view whose W, H and N strides do not "
                                     f"overlap, got strides {d.stride()}")
                held += stride * (size - 1)
        if d.storage_offset() % max(sw, 1) % 8:
            raise ValueError(f"a destination's channels must start at a multiple of 8 in their pixel, got offset "
                             f"{d.storage_offset()} with pixel stride {sw}")


def _check(y, bias, bn_mul, bn_add, act, q_scale, residual, into=None):
    if y.ndim != 4 or y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"y must be a float32 or bfloat16 (N, C, H, W) tensor, got {y.dtype} {tuple(y.shape)}")
    if not (y.is_contiguous() or y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("y must be NCHW-contiguous or channels-last")
    if act not in ACTIVATIONS:
        raise ValueError(f"act {act!r}: expected one of {ACTIVATIONS}")
    if residual is not None:
        if bias is None or bn_mul is not None or bn_add is not None or act != "none":
            raise ValueError("a residual takes a bias, and no BatchNorm vectors or activation")
        if q_scale is not None:
            raise ValueError("a residual takes no q_scale: its sum is stored in y's dtype")
        order = torch.channels_last if channels_last(y) else torch.contiguous_format
        if (residual.shape != y.shape or residual.dtype != y.dtype or residual.device != y.device
                or not residual.is_contiguous(memory_format=order)):
            raise ValueError(f"the residual must be a {y.dtype} tensor of y's shape {tuple(y.shape)} on {y.device}, "
                             f"laid out as y ({'channels-last' if order is torch.channels_last else 'NCHW'})")
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
    if into is not None:
        if q_scale is not None or residual is not None:
            raise ValueError("into takes the bias or the BatchNorm form: no q_scale and no residual")
        _check_into(y, into)


def conv_epilogue(
    y: torch.Tensor,  # float32 | bfloat16 (N, C, H, W), NCHW or channels-last
    *,
    bias: Optional[torch.Tensor] = None,    # y's dtype, C elements: (C,) or (1, C, 1, 1)
    bn_mul: Optional[torch.Tensor] = None,  # float32, C elements
    bn_add: Optional[torch.Tensor] = None,  # float32, C elements
    act: str = "none",
    q_scale: Optional[torch.Tensor] = None,  # float32, one element
    residual: Optional[torch.Tensor] = None,  # y's shape, dtype and layout
    into: Optional[Sequence[torch.Tensor]] = None,  # one or two channels-last views of y's shape and dtype
) -> Optional[torch.Tensor]:
    """A conv's ``y + bias`` (``act`` "none"), or a DoubleConv conv's
    ``act(y * bn_mul + bn_add)`` (``act`` relu, tanh or mish); rounded to
    y's dtype and returned in y's dtype and layout, or with ``q_scale``
    quantized ``clamp(round(v / q_scale), -127, 127)`` into an int8 NHWC
    ``(N, H, W, C)`` tensor. With ``residual`` (a bias, no activation, no
    ``q_scale``): ``(y + bias) + residual``, each add rounded to y's dtype
    (``conv_epilogue_reference`` spells it out). With ``into`` (the bias or
    BatchNorm form of a channels-last y, no ``q_scale``, no residual): the
    result is stored into each of one or two destinations and None is
    returned; a destination is a view of y's shape and dtype whose channels
    are contiguous and start at a multiple of 8 within their pixel, with
    any H and W strides (the U-Net's up blocks pass the halves of their
    concat buffers).

    On CUDA the op allocates the output with ``torch.empty`` (with
    ``into``, nothing) and launches the kernel on the current stream
    without synchronizing; each call adds one to
    ``conv_epilogue.launches``, in the residual form one to
    ``conv_epilogue.residual_launches`` too, and with ``into`` one to
    ``conv_epilogue.into_launches`` (an empty y launches nothing). On the
    CPU it computes ``conv_epilogue_reference``. A tensor subclass (a fake
    tensor under ``torch.export``) or a compiling graph goes through the
    op's dispatch (with ``into``, ``gelslim::conv_epilogue_into``, which
    mutates its destinations); a plain CUDA tensor launches at once."""
    _check(y, bias, bn_mul, bn_add, act, q_scale, residual, into)
    direct = y.is_cuda and type(y) is torch.Tensor and not torch.compiler.is_compiling()
    if into is not None:
        into = list(into)
        if direct and all(type(d) is torch.Tensor for d in into):
            _launch_into(y, bias, bn_mul, bn_add, act, into)
        else:
            torch.ops.gelslim.conv_epilogue_into(y, bias, bn_mul, bn_add, act, into)
        return None
    if direct:
        return _launch(y, bias, bn_mul, bn_add, act, q_scale, residual)
    return torch.ops.gelslim.conv_epilogue(y, bias, bn_mul, bn_add, act, q_scale, residual)


conv_epilogue.launches = 0
conv_epilogue.residual_launches = 0
conv_epilogue.into_launches = 0


def _out(y: torch.Tensor, q_scale: Optional[torch.Tensor]) -> torch.Tensor:
    if q_scale is None:
        return torch.empty_like(y)
    n, c, h, w = y.shape
    return y.new_empty((n, h, w, c), dtype=torch.int8)


@torch.library.custom_op("gelslim::conv_epilogue", mutates_args=(), device_types="cuda")
def _op(y: torch.Tensor, bias: Optional[torch.Tensor], bn_mul: Optional[torch.Tensor],
        bn_add: Optional[torch.Tensor], act: str, q_scale: Optional[torch.Tensor],
        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel, on CUDA tensors that the public wrapper has checked."""
    return _launch(y, bias, bn_mul, bn_add, act, q_scale, residual)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(y, bias, bn_mul, bn_add, act, q_scale, residual):
    out = _out(y, q_scale)
    if out.numel():
        n, c, h, w = y.shape
        dev = y.get_device()
        err = _kernel_fn()(
            y.data_ptr(), out.data_ptr(), _ptr(bias), _ptr(bn_mul), _ptr(bn_add), _ptr(q_scale), _ptr(residual),
            n, c, h * w, channels_last(y), y.dtype == torch.bfloat16, ACTIVATIONS.index(act), dev,
            torch._C._cuda_getCurrentRawStream(dev),
        )
        if err != 0:
            raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error {err}")
        conv_epilogue.launches += 1
        conv_epilogue.residual_launches += residual is not None
    return out


@_op.register_kernel("cpu")
def _op_cpu(y, bias, bn_mul, bn_add, act, q_scale, residual=None):
    return conv_epilogue_reference(y, bias=bias, bn_mul=bn_mul, bn_add=bn_add, act=act, q_scale=q_scale,
                                   residual=residual)


@_op.register_fake
def _op_fake(y, bias, bn_mul, bn_add, act, q_scale, residual=None):
    return _out(y, q_scale)


@torch.library.custom_op("gelslim::conv_epilogue_into", mutates_args=("into",), device_types="cuda")
def _op_into(y: torch.Tensor, bias: Optional[torch.Tensor], bn_mul: Optional[torch.Tensor],
             bn_add: Optional[torch.Tensor], act: str, into: List[torch.Tensor]) -> None:
    """The destination form of the kernel, on CUDA tensors that the public
    wrapper has checked: stores into each tensor of ``into``."""
    _launch_into(y, bias, bn_mul, bn_add, act, into)


def _launch_into(y, bias, bn_mul, bn_add, act, into):
    if y.numel():
        n, c, h, w = y.shape
        dst = [(d.data_ptr(), d.stride(0), d.stride(2), d.stride(3)) for d in into] + [(None, 0, 0, 0)] * (2 - len(into))
        dev = y.get_device()
        err = _into_fn()(
            y.data_ptr(), _ptr(bias), _ptr(bn_mul), _ptr(bn_add), *dst[0], *dst[1],
            n, c, h, w, y.dtype == torch.bfloat16, ACTIVATIONS.index(act), dev, torch._C._cuda_getCurrentRawStream(dev),
        )
        if err != 0:
            raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error {err}")
        conv_epilogue.launches += 1
        conv_epilogue.into_launches += 1


@_op_into.register_kernel("cpu")
def _op_into_cpu(y, bias, bn_mul, bn_add, act, into):
    conv_epilogue_reference(y, bias=bias, bn_mul=bn_mul, bn_add=bn_add, act=act, into=into)


@_op_into.register_fake
def _op_into_fake(y, bias, bn_mul, bn_add, act, into):
    return None


def conv_epilogue_reference(y, *, bias=None, bn_mul=None, bn_add=None, act="none", q_scale=None, residual=None,
                            into=None):
    """Plain PyTorch composition of the same function (the kernel's twin),
    the chain of ops it replaces: a conv's ``y + bias``, then ``+
    residual`` where one is given, or a DoubleConv's ``act(y * bn_mul +
    bn_add)`` cast to y's dtype, then ``quant_act`` of the NHWC result
    where ``q_scale`` is given; with ``into``, the result copied into each
    destination, and None returned."""
    _check(y, bias, bn_mul, bn_add, act, q_scale, residual, into)
    c = (1, -1, 1, 1)
    if bias is not None:
        v = y + bias.view(c)
    else:
        v = activation_fn(act)(y * bn_mul.view(c) + bn_add.view(c)).to(y.dtype)
    if into is not None:
        for d in into:
            d.copy_(v)
        return None
    if residual is not None:
        return v + residual
    if q_scale is None:
        return v
    return quant_act(v.permute(0, 2, 3, 1).contiguous(), q_scale)
