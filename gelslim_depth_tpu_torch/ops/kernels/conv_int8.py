"""int8 x int8 -> int32 convolution with a float32 dequant epilogue, NHWC,
that can also requantize its output for the next int8 conv.

``conv2d_int8`` checks its arguments and calls the custom op
``torch.ops.gelslim.conv2d_int8``, whose CUDA implementation launches the
hand-written kernel ``csrc/conv2d_int8.cu`` (the source's header says what
it replaces, what bounds it and how it is laid out) and whose CPU
implementation computes ``conv2d_int8_reference``, the same function
composed of plain PyTorch ops. The op's device keys pick the route, one per
device: there is no fallback from the kernel to the plain version, on CUDA
it launches or raises. As an op it is traced by ``torch.export``.

The plain twin runs the convolution in float64, where every int8 x int8 sum
of the U-Net is exact (|acc| <= 3*3*1024*127^2 ~ 1.5e8, far below 2^53; float32
would not be, past 2^24), rounds it back to int32, then applies the epilogue
as separate float32 ops in the kernel's order, casts to the compute dtype
and quantizes that with ``quant_act``, the int8 graph's activation
quantizer, which the kernel's epilogue implements. The kernel
rounds each multiply and add on its own and divides by the scale in IEEE
float32 too, so the two agree bit for bit up to the activation, and exactly
for relu.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch.ops.activation import activation_fn

ACTIVATIONS = ("none", "relu", "tanh", "mish")  # the kernel's act codes, in order
PATHS = ("bytes", "wgmma")  # the kernel's mainloops, by the code it reports


class Epilogue(NamedTuple):
    """What follows ``float(acc) * scale[o]``, in this order: ``+ bias[o]``,
    the folded eval BatchNorm ``* bn_mul[o] + bn_add[o]``, the activation,
    the rounding to ``out_dtype`` (the compute dtype). ``shuffle = s > 1``
    stores a 1x1 conv of ``s*s*C`` columns depth-to-space: column
    ``(di*s + dj)*C + o`` of pixel ``(n, i, j)`` goes to
    ``out[n, s*i + di, s*j + dj, o]`` (the row-split transposed conv whose
    kernel equals its stride).

    ``q_scales`` asks for up to two int8 outputs, each the rounded value
    quantized at its own scale, ``clamp(round(v / s), -127, 127)`` (IEEE
    division, half to even), as ``quant_act`` does for its consumer;
    ``store_float`` keeps the ``out_dtype`` output beside them."""

    bias: Optional[torch.Tensor] = None    # float32 (Cout,)
    bn_mul: Optional[torch.Tensor] = None  # float32 (Cout,)
    bn_add: Optional[torch.Tensor] = None  # float32 (Cout,)
    act: str = "none"
    out_dtype: torch.dtype = torch.float32
    shuffle: int = 1
    q_scales: Tuple[torch.Tensor, ...] = ()  # float32, one element each
    store_float: bool = True


def bind(lib: ctypes.CDLL):
    """The C entry of a built csrc/conv2d_int8.cu, typed."""
    fn = lib.conv2d_int8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 12 + [i] * 17 + [ctypes.POINTER(i), p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    return bind(load_library("conv2d_int8"))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(fn, qx, w, out, qouts, *, pad: int, scale, epilogue: Epilogue, qx2=None, offset=(0, 0)):
    """Launches ``fn`` (a bound C entry) on checked, contiguous CUDA tensors:
    ``out`` the float output or None, ``qouts`` the int8 outputs. Returns
    (CUDA error code, the code of the mainloop it took)."""
    n, h, wd, cin = qx.shape
    _, h2, w2, cin2 = qx2.shape if qx2 is not None else (n, 0, 0, 0)
    cout, kh, kw, _ = w.shape
    qs = list(epilogue.q_scales) + [None] * (2 - len(epilogue.q_scales))
    qo = list(qouts) + [None] * (2 - len(qouts))
    path = ctypes.c_int(-1)
    with torch.cuda.device(qx.device):
        err = fn(
            qx.data_ptr(), _ptr(qx2), w.data_ptr(), _ptr(out), _ptr(qo[0]), _ptr(qo[1]),
            _ptr(scale), _ptr(epilogue.bias), _ptr(epilogue.bn_mul), _ptr(epilogue.bn_add),
            _ptr(qs[0]), _ptr(qs[1]),
            n, h, wd, cin, h2, w2, cin2, offset[0], offset[1], cout, kh, kw, pad,
            ACTIVATIONS.index(epilogue.act), int(epilogue.out_dtype == torch.bfloat16),
            max(1, epilogue.shuffle), len(epilogue.q_scales),
            ctypes.byref(path), torch.cuda.current_stream(qx.device).cuda_stream,
        )
    return err, path.value


def _check(qx, w, pad, scale, ep: Epilogue, qx2, offset):
    if qx.ndim != 4 or w.ndim != 4 or qx.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(
            f"qx must be int8 (N, H, W, Cin) and w int8 (Cout, kh, kw, Cin), got "
            f"{qx.dtype} {tuple(qx.shape)} and {w.dtype} {tuple(w.shape)}"
        )
    n, h, wd, cin = qx.shape
    cout, kh, kw, wcin = w.shape
    if qx2 is not None:
        if qx2.ndim != 4 or qx2.dtype != torch.int8 or qx2.shape[0] != n or qx2.device != qx.device:
            raise ValueError(f"qx2 must be int8 ({n}, H2, W2, C2) on {qx.device}, got {qx2.dtype} {tuple(qx2.shape)}")
        oy, ox = offset
        _, h2, w2, cin2 = qx2.shape
        if oy < 0 or ox < 0 or oy + h2 > h or ox + w2 > wd:
            raise ValueError(f"qx2 {h2}x{w2} at offset {offset} does not lie inside qx's {h}x{wd}")
        cin += cin2
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
    if len(ep.q_scales) > 2 or not (ep.q_scales or ep.store_float):
        raise ValueError(f"an epilogue stores 1 or 2 int8 outputs and/or the float one, got "
                         f"{len(ep.q_scales)} and store_float={ep.store_float}")
    for s in ep.q_scales:
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != qx.device:
            raise ValueError(f"q_scales must be float32 one-element tensors on {qx.device}")
    if w.device != qx.device:
        raise ValueError("qx and w must be on one device")
    s = ep.shuffle
    if s > 1 and ((kh, kw, pad) != (1, 1, 0) or cout % (s * s)):
        raise ValueError(f"shuffle {s} needs a 1x1 conv, pad 0, and Cout a multiple of {s * s}")
    return _out_shape(qx, w, pad, s)


def _out_shape(qx, w, pad: int, shuffle: int):
    n, h, wd, _ = qx.shape
    cout, kh, kw, _ = w.shape
    ho, wo = h + 2 * pad - kh + 1, wd + 2 * pad - kw + 1
    if shuffle > 1:
        return (n, shuffle * ho, shuffle * wo, cout // (shuffle * shuffle))
    return (n, ho, wo, cout)


def conv2d_int8(
    qx: torch.Tensor,  # int8 (N, H, W, C1)
    w: torch.Tensor,   # int8 (Cout, kh, kw, C1 + C2)
    *,
    pad: int,
    scale: torch.Tensor,  # float32 (Cout,): in_scale * w_scale
    epilogue: Epilogue = Epilogue(),
    qx2: Optional[torch.Tensor] = None,  # int8 (N, H2, W2, C2)
    offset: Tuple[int, int] = (0, 0),
):
    """Stride-1 conv with zero padding ``pad`` on each side, int32
    accumulation, and the epilogue. With ``qx2`` the conv reads the channel
    concat ``[qx, qx2 placed at offset (oy, ox) on qx's H x W, zero
    elsewhere]`` in place, with no copy of it.

    Returns the NHWC output in ``epilogue.out_dtype`` when the epilogue asks
    for no int8 output; else a tuple of the int8 outputs in ``q_scales``
    order, followed by the float output where ``store_float``.

    The call goes to the custom op ``torch.ops.gelslim.conv2d_int8``, the
    epilogue flattened into its arguments. On CUDA the op allocates the
    outputs with ``torch.empty`` and launches the kernel on the current
    stream without synchronizing; each launch adds one to
    ``conv2d_int8.launches`` and to its mainloop's count in
    ``conv2d_int8.launches_by_path`` (an empty output launches nothing).
    On the CPU the op computes ``conv2d_int8_reference`` and launches
    nothing."""
    _check(qx, w, pad, scale, epilogue, qx2, offset)
    ep = epilogue
    outs = torch.ops.gelslim.conv2d_int8(
        qx, w, pad, scale, ep.bias, ep.bn_mul, ep.bn_add, ep.act, ep.out_dtype, ep.shuffle,
        list(ep.q_scales), ep.store_float, qx2, [int(offset[0]), int(offset[1])],
    )
    return tuple(outs) if ep.q_scales else outs[0]


conv2d_int8.launches = 0
conv2d_int8.launches_by_path = dict.fromkeys(PATHS, 0)


@torch.library.custom_op("gelslim::conv2d_int8", mutates_args=(), device_types="cuda")
def _op(
    qx: torch.Tensor, w: torch.Tensor, pad: int, scale: torch.Tensor,
    bias: Optional[torch.Tensor], bn_mul: Optional[torch.Tensor], bn_add: Optional[torch.Tensor],
    act: str, out_dtype: torch.dtype, shuffle: int, q_scales: List[torch.Tensor], store_float: bool,
    qx2: Optional[torch.Tensor], offset: List[int],
) -> List[torch.Tensor]:
    """The kernel, on checked CUDA tensors (the public wrapper checks):
    the int8 outputs in ``q_scales`` order, then the float one."""
    ep = Epilogue(bias, bn_mul, bn_add, act, out_dtype, shuffle, tuple(q_scales), store_float)
    tensors = (qx, qx2, w, scale, bias, bn_mul, bn_add, *q_scales)
    if not all(t is None or t.is_contiguous() for t in tensors):
        raise ValueError("conv2d_int8 takes contiguous tensors")
    out_shape = _out_shape(qx, w, pad, shuffle)
    qouts = [torch.empty(out_shape, dtype=torch.int8, device=qx.device) for _ in q_scales]
    out = torch.empty(out_shape, dtype=out_dtype, device=qx.device) if store_float else None
    outs = [*qouts, out] if store_float else qouts
    if outs[0].numel():
        err, path = launch(_kernel_fn(), qx, w, out, qouts, pad=pad, scale=scale, epilogue=ep,
                           qx2=qx2, offset=tuple(offset))
        if err != 0:
            raise RuntimeError(f"conv2d_int8 kernel launch failed: CUDA error {err}")
        conv2d_int8.launches += 1
        conv2d_int8.launches_by_path[PATHS[path]] += 1
    return outs


@_op.register_kernel("cpu")
def _op_cpu(qx, w, pad, scale, bias, bn_mul, bn_add, act, out_dtype, shuffle, q_scales, store_float, qx2, offset):
    ep = Epilogue(bias, bn_mul, bn_add, act, out_dtype, shuffle, tuple(q_scales), store_float)
    outs = conv2d_int8_reference(qx, w, pad=pad, scale=scale, epilogue=ep, qx2=qx2, offset=tuple(offset))
    return list(outs) if q_scales else [outs]


@_op.register_fake
def _op_fake(qx, w, pad, scale, bias, bn_mul, bn_add, act, out_dtype, shuffle, q_scales, store_float, qx2, offset):
    shape = _out_shape(qx, w, pad, shuffle)
    qouts = [qx.new_empty(shape, dtype=torch.int8) for _ in q_scales]
    return [*qouts, qx.new_empty(shape, dtype=out_dtype)] if store_float else qouts


def conv2d_int8_accumulate(qx: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """The exact int32 sums, NHWC: a float64 convolution, rounded back."""
    acc = F.conv2d(qx.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(), padding=pad)
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def place(qx2: torch.Tensor, hw: Tuple[int, int], offset: Tuple[int, int]) -> torch.Tensor:
    """qx2 (N, H2, W2, C) zero-padded onto an H x W canvas at offset (oy, ox)."""
    (h, wd), (oy, ox) = hw, offset
    return F.pad(qx2, [0, 0, ox, wd - qx2.shape[2] - ox, oy, h - qx2.shape[1] - oy])


def quant_act(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """Static-scale symmetric int8 activation quantization:
    clamp(round(x / s), -127, 127), in float32, rounding half to even. The
    scale goes in as a 1-element tensor, not a 0-d one, so that a bfloat16 x
    is divided in float32 (type promotion) with no separate cast pass."""
    return (x / in_scale.reshape(1)).round_().clamp_(-127, 127).to(torch.int8)


def conv2d_int8_reference(qx, w, *, pad, scale, epilogue: Epilogue = Epilogue(), qx2=None, offset=(0, 0)):
    """Plain PyTorch composition of the same function (the kernel's twin):
    pad + concat, the conv, the epilogue, then each int8 output quantized
    from the rounded value by ``quant_act``."""
    _check(qx, w, pad, scale, epilogue, qx2, offset)
    if qx2 is not None:
        qx = torch.cat([qx, place(qx2, qx.shape[1:3], offset)], dim=-1)
    y = conv2d_int8_accumulate(qx, w, pad).float() * scale
    if epilogue.bias is not None:
        y = y + epilogue.bias
    if epilogue.bn_mul is not None:
        y = y * epilogue.bn_mul + epilogue.bn_add
    if epilogue.act != "none":
        y = activation_fn(epilogue.act)(y)
    y = y.to(epilogue.out_dtype)
    s = epilogue.shuffle
    if s > 1:
        n, h, wd, cols = y.shape
        c = cols // (s * s)
        y = y.reshape(n, h, wd, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(n, s * h, s * wd, c)
    y = y.contiguous()
    if not epilogue.q_scales:
        return y
    qouts = tuple(quant_act(y, q) for q in epilogue.q_scales)
    return (*qouts, y) if epilogue.store_float else qouts
