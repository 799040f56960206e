"""int8 x int8 -> int32 convolution with a float32 dequant epilogue, NHWC.

``conv2d_int8`` launches the hand-written CUDA kernel ``csrc/conv2d_int8.cu``
for tensors on a CUDA device (the source's header says what it replaces,
what bounds it and how it is laid out), and computes
``conv2d_int8_reference``, the same function composed of plain PyTorch ops,
for tensors on the CPU. There is no fallback from the kernel to the plain
version: on CUDA it launches or raises.

The plain twin runs the convolution in float64, where every int8 x int8 sum
of the U-Net is exact (|acc| <= 3*3*1024*127^2 ~ 1.5e8, far below 2^53; float32
would not be, past 2^24), rounds it back to int32, then applies the epilogue
as separate float32 ops in the kernel's order. The kernel rounds each
multiply and add on its own too, so the two agree bit for bit up to the
activation, and exactly for relu.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = ("none", "relu", "tanh", "mish")  # the kernel's act codes, in order


class Epilogue(NamedTuple):
    """What follows ``float(acc) * scale[o]``, in this order: ``+ bias[o]``,
    the folded eval BatchNorm ``* bn_mul[o] + bn_add[o]``, the activation,
    the store in ``out_dtype``. ``shuffle = s > 1`` stores a 1x1 conv of
    ``s*s*C`` columns depth-to-space: column ``(di*s + dj)*C + o`` of pixel
    ``(n, i, j)`` goes to ``out[n, s*i + di, s*j + dj, o]`` (the row-split
    transposed conv whose kernel equals its stride)."""

    bias: Optional[torch.Tensor] = None    # float32 (Cout,)
    bn_mul: Optional[torch.Tensor] = None  # float32 (Cout,)
    bn_add: Optional[torch.Tensor] = None  # float32 (Cout,)
    act: str = "none"
    out_dtype: torch.dtype = torch.float32
    shuffle: int = 1


def bind(lib: ctypes.CDLL):
    """The C entry of a built csrc/conv2d_int8.cu, typed."""
    fn = lib.conv2d_int8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    return bind(load_library("conv2d_int8"))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(fn, qx, w, out, *, pad: int, scale, epilogue: Epilogue) -> int:
    """Launches ``fn`` (a bound C entry) on checked, contiguous CUDA tensors;
    returns its CUDA error code."""
    n, h, wd, cin = qx.shape
    cout, kh, kw, _ = w.shape
    with torch.cuda.device(qx.device):
        return fn(
            qx.data_ptr(), w.data_ptr(), out.data_ptr(), _ptr(scale), _ptr(epilogue.bias),
            _ptr(epilogue.bn_mul), _ptr(epilogue.bn_add), n, h, wd, cin, cout, kh, kw, pad,
            ACTIVATIONS.index(epilogue.act), int(epilogue.out_dtype == torch.bfloat16),
            max(1, epilogue.shuffle), torch.cuda.current_stream(qx.device).cuda_stream,
        )


def _check(qx, w, pad, scale, ep: Epilogue):
    if qx.ndim != 4 or w.ndim != 4 or qx.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(
            f"qx must be int8 (N, H, W, Cin) and w int8 (Cout, kh, kw, Cin), got "
            f"{qx.dtype} {tuple(qx.shape)} and {w.dtype} {tuple(w.shape)}"
        )
    n, h, wd, cin = qx.shape
    cout, kh, kw, wcin = w.shape
    if wcin != cin:
        raise ValueError(f"w has {wcin} input channels, qx {cin}")
    ho, wo = h + 2 * pad - kh + 1, wd + 2 * pad - kw + 1
    if pad < 0 or ho < 1 or wo < 1:
        raise ValueError(f"a {kh}x{kw} conv with pad {pad} has no output on a {h}x{wd} input")
    if ep.act not in ACTIVATIONS:
        raise ValueError(f"act {ep.act!r}: expected one of {ACTIVATIONS}")
    if ep.out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {ep.out_dtype}")
    if (ep.bn_mul is None) != (ep.bn_add is None):
        raise ValueError("bn_mul and bn_add go together")
    for name, v in (("scale", scale), ("bias", ep.bias), ("bn_mul", ep.bn_mul), ("bn_add", ep.bn_add)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (cout,) or v.device != qx.device):
            raise ValueError(f"{name} must be float32 ({cout},) on {qx.device}")
    if w.device != qx.device:
        raise ValueError("qx and w must be on one device")
    s = ep.shuffle
    if s > 1 and ((kh, kw, pad) != (1, 1, 0) or cout % (s * s)):
        raise ValueError(f"shuffle {s} needs a 1x1 conv, pad 0, and Cout a multiple of {s * s}")
    if s > 1:
        return (n, s * ho, s * wo, cout // (s * s))
    return (n, ho, wo, cout)


def conv2d_int8(
    qx: torch.Tensor,  # int8 (N, H, W, Cin)
    w: torch.Tensor,   # int8 (Cout, kh, kw, Cin)
    *,
    pad: int,
    scale: torch.Tensor,  # float32 (Cout,): in_scale * w_scale
    epilogue: Epilogue = Epilogue(),
) -> torch.Tensor:
    """Stride-1 conv with zero padding ``pad`` on each side, int32
    accumulation, and the dequant epilogue; returns NHWC in
    ``epilogue.out_dtype``.

    On CUDA the output is allocated with ``torch.empty`` and the kernel is
    launched on the current stream without synchronizing; each launch adds
    one to ``conv2d_int8.launches`` (an empty output launches nothing). CPU
    tensors go through ``conv2d_int8_reference`` and launch nothing."""
    out_shape = _check(qx, w, pad, scale, epilogue)
    if qx.device.type == "cpu":
        return conv2d_int8_reference(qx, w, pad=pad, scale=scale, epilogue=epilogue)
    if qx.device.type != "cuda":
        raise ValueError(f"no kernel for device {qx.device}")
    vectors = (scale, epilogue.bias, epilogue.bn_mul, epilogue.bn_add)
    if not (qx.is_contiguous() and w.is_contiguous() and all(v is None or v.is_contiguous() for v in vectors)):
        raise ValueError("conv2d_int8 takes contiguous tensors")

    out = torch.empty(out_shape, dtype=epilogue.out_dtype, device=qx.device)
    if out.numel() == 0:
        return out
    err = launch(_kernel_fn(), qx, w, out, pad=pad, scale=scale, epilogue=epilogue)
    if err != 0:
        raise RuntimeError(f"conv2d_int8 kernel launch failed: CUDA error {err}")
    conv2d_int8.launches += 1
    return out


conv2d_int8.launches = 0


def conv2d_int8_accumulate(qx: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """The exact int32 sums, NHWC: a float64 convolution, rounded back."""
    acc = F.conv2d(qx.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(), padding=pad)
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv2d_int8_reference(qx, w, *, pad, scale, epilogue: Epilogue = Epilogue()):
    """Plain PyTorch composition of the same function (the kernel's twin)."""
    from gelslim_depth_tpu_torch.models.unet import Activation

    _check(qx, w, pad, scale, epilogue)
    y = conv2d_int8_accumulate(qx, w, pad).float() * scale
    if epilogue.bias is not None:
        y = y + epilogue.bias
    if epilogue.bn_mul is not None:
        y = y * epilogue.bn_mul + epilogue.bn_add
    if epilogue.act != "none":
        y = Activation(epilogue.act)(y)
    y = y.to(epilogue.out_dtype)
    s = epilogue.shuffle
    if s > 1:
        n, h, wd, cols = y.shape
        c = cols // (s * s)
        y = y.reshape(n, h, wd, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(n, s * h, s * wd, c)
    return y.contiguous()
