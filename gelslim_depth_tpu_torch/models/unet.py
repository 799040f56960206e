"""U-Net for tactile depth estimation: one float graph, walked by the eval
module ``UNet`` and by the functional ``unet_apply`` (train and eval), the
counterpart of ``gelslim_depth_tpu.models.unet.unet_apply``. The modules
only hold parameters, under the reference's state-dict keys
(``inc.double_conv.{0,1,3,4}``, ``down.{i}.maxpool_conv.1.double_conv.*``,
``up.{i}.up``, ``up.{i}.conv.double_conv.*``, ``outc.conv``), so a reference
``.pth`` loads with ``load_state_dict``.

Reference architecture quirks kept (ref gelslim_depth/models/unet.py):
- DoubleConv = (Conv k=kernel_size, padding hard-coded 1, bias=False ->
  BatchNorm -> activation) x2, padding 1 even for k != 3.
- Down = MaxPool(maxpool_size) + DoubleConv.
- Up = ConvTranspose(in -> in//2, k=kernel_size-1, stride=upconv_stride,
  bias=True), pad to the skip's size (left/top gets diff//2), concat
  [skip, up], DoubleConv. The decoder DoubleConvs are always 3x3.
- OutConv = 1x1 conv with bias.
- The activation knob is honored ('relu' | 'tanh' | 'mish').

``_walk`` is the graph, inc -> down_i -> up_j -> outc, over weights keyed
by those names, cast to the compute dtype and memory format where used (a
no-op for ``UNet``'s, which ``to_compute_dtype`` stores so). Each block runs
in a ``utils.profiling.span`` (``unet.block``), each conv call alone (with
a halo, its exchange too) in a ``unet.conv`` span. The callers pass in what differs: the weights, the
memory format and a DoubleConv's BatchNorm. Eval folds it into ``x * scale
+ shift``, ``scale = rsqrt(var + 1e-5) * weight`` (``UNet``'s
``fold_batch_norm`` buffers; ``unet_apply`` folds the given statistics each
call), and ``bn_act`` runs the affine, activation and cast as one
``conv_epilogue`` in a ``unet.epilogue`` span, as the upconv's bias add
runs; where autograd records, or in float64, the chain of aten ops that
the kernel equals bit for bit. Train passes the batch-statistics
BatchNorm. Off, a span costs a call and a ``with``.

Compute dtype: float32 runs every conv in full float32, TF32 off whatever
``torch.backends.cudnn.allow_tf32`` says, as the JAX package's
``Precision.HIGHEST`` does. bfloat16 follows the JAX package's
``unet_apply(compute_dtype=bfloat16)`` rounding for rounding:
- a conv's output stays bfloat16;
- the BN affine promotes to float32 (bf16 tensor times f32 vector), goes
  through the activation, and is cast back to bfloat16;
- the upconv output gets its bfloat16 bias added in bfloat16;
- the head conv adds its bias in bfloat16, then casts to float32.

Layout (``memory_format``): bfloat16 eval runs channels-last end to end
(the weights, the input made so once at the entry of ``inc``, and every
intermediate: convs, ``conv_epilogue``, pools, the up blocks' inputs), so
cuDNN runs its NHWC kernels with no NCHW<->NHWC transpose around them.
There each up block's input, the concat of the skip and the padded upconv
output, is one buffer that their epilogues write (``conv_epilogue``'s
destination form, ``_walk``), with no pad or concat pass. Everything else
keeps its input's layout, NCHW from every serving caller: with TF32 off,
cuDNN's float32 convs transpose in either layout, and on an H100 the
float32 train step ran slower in NHWC (105.0 against 93.4 ms; PERF.md).

``unet_apply`` takes reference-layout dictionaries of float32 parameters
and running statistics, cast inside the forward, so bfloat16 gradients
land on float32 masters; train mode normalizes with batch statistics
(optionally mask-weighted) and returns the running ones updated. Its
``channels_last=True`` means NHWC tensors in and out, as the JAX package's
does: their NCHW views are channels-last in memory. ``init_unet`` and
``reinit_weights_normal`` make a fresh model from a ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from gelslim_depth_tpu_torch.ops.activation import activation_fn
from gelslim_depth_tpu_torch.ops.kernels.conv_epilogue import conv_epilogue
from gelslim_depth_tpu_torch.utils.profiling import span

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    n_channels: int = 3
    n_classes: int = 1
    layer_dimensions: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    kernel_size: int = 3
    maxpool_size: int = 2
    upconv_stride: int = 2
    activation: str = "relu"

    @property
    def num_levels(self) -> int:
        return len(self.layer_dimensions)


class Activation(nn.Module):
    """``ops.activation`` as a module, at its index of the reference's
    DoubleConv ``nn.Sequential``."""

    def __init__(self, name: str):
        super().__init__()
        self.fn = activation_fn(name)
        self.name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


@contextlib.contextmanager
def _no_cudnn_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def records_grad(y: torch.Tensor) -> bool:
    """Whether autograd records an op on y: the forward then keeps the
    chain of aten ops that ``conv_epilogue`` replaces, which has gradients."""
    return torch.is_grad_enabled() and y.requires_grad


def full_precision(dtype: torch.dtype):
    """TF32 off for cuDNN's convs while float32 runs, as the JAX package's
    ``Precision.HIGHEST`` asks; bfloat16 leaves the flag alone. A train
    step holds it across its backward too. cuDNN still picks FFT and
    Winograd algorithms for some float32 gradients; on an H100 they left
    the flagship's gradients within 1.5x of exact float32 arithmetic's
    error against float64 (PERF.md)."""
    return _no_cudnn_tf32() if dtype == torch.float32 else contextlib.nullcontext()


def memory_format(dtype: torch.dtype, train: bool = False) -> torch.memory_format:
    """The float graph's memory format: channels-last end to end for
    bfloat16 eval; otherwise ``torch.preserve_format``, the input's layout
    (the module's docstring says why)."""
    return torch.channels_last if dtype == torch.bfloat16 and not train else torch.preserve_format


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, activation: str):
        super().__init__()
        act = Activation(activation)
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cout, k, padding=1, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS),
            act,
            nn.Conv2d(cout, cout, k, padding=1, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS),
            act,
        )
        self.fold_batch_norm()

    @torch.no_grad()
    def fold_batch_norm(self) -> None:
        """Eval BN i as ``x * bn{i}_scale + bn{i}_shift``, (1, C, 1, 1)
        buffers that the state dict does not hold."""
        for i, bn in enumerate((self.double_conv[1], self.double_conv[4])):
            inv = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
            shift = bn.bias - bn.running_mean * inv
            self.register_buffer(f"bn{i}_scale", inv.view(1, -1, 1, 1), persistent=False)
            self.register_buffer(f"bn{i}_shift", shift.view(1, -1, 1, 1), persistent=False)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: UNetConfig):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(cfg.maxpool_size),
            DoubleConv(cin, cout, cfg.kernel_size, cfg.activation),
        )


class Up(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: UNetConfig):
        super().__init__()
        self.stride = cfg.upconv_stride
        self.up = nn.ConvTranspose2d(cin, cin // 2, cfg.kernel_size - 1, stride=cfg.upconv_stride)
        # the reference's Up never forwards kernel_size to its DoubleConv
        self.conv = DoubleConv(cin, cout, 3, cfg.activation)


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


def _fused(y: torch.Tensor) -> bool:
    """Whether y's epilogue is one ``conv_epilogue``: not where autograd
    records, nor in float64, which the kernel does not take."""
    return y.dtype != torch.float64 and not records_grad(y)


def _concat_in_place(y: torch.Tensor, fmt: torch.memory_format, dtype: torch.dtype) -> bool:
    """Whether y's epilogue may store into an up block's concat buffer
    (the skip level's last conv output, or the upconv's): where the graph
    runs channels-last (bfloat16 eval), y is channels-last in the compute
    dtype and its epilogue is the kernel. Elsewhere (autograd recording,
    float64, the NCHW graphs, a conv output kept in float32) the up block
    pads and concatenates."""
    return (fmt == torch.channels_last and y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
            and _fused(y))


def bn_act(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, act: str, site: str,
           into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A DoubleConv conv's folded eval BatchNorm (its (1, C, 1, 1) scale
    and shift) and activation of the conv's output y, rounded to y's dtype:
    one ``conv_epilogue`` in a ``unet.epilogue`` span, or the aten chain
    where autograd records or y is float64. With into (a view of y's shape
    in an up block's concat buffer) the one launch stores the result there
    too."""
    if not _fused(y):
        return activation_fn(act)(y * scale + shift).to(y.dtype)
    with span("unet.epilogue", site):
        if into is None:
            return conv_epilogue(y, bn_mul=scale, bn_add=shift, act=act)
        out = torch.empty_like(y)
        conv_epilogue(y, bn_mul=scale, bn_add=shift, act=act, into=(out, into))
        return out


def _eval_norm(fold, act: str):
    """Eval BatchNorm: fold(prefix, i) is BatchNorm i's (scale, shift)."""
    return lambda y, prefix, i, site, into=None: (bn_act(y, *fold(prefix, i), act, site, into), None)


def _upconv_into(y: torch.Tensor, bias: torch.Tensor, half: torch.Tensor, top: int, left: int) -> None:
    """The upconv's bias epilogue stored straight into half, the upper
    channels of its up block's concat buffer, at the pad offset (top,
    left); the pad's rows and columns around it are zeroed alone."""
    (h, w), (rows, cols) = y.shape[2:], half.shape[2:]
    if top:
        half[:, :, :top].zero_()
    if top + h < rows:
        half[:, :, top + h:].zero_()
    if left:
        half[:, :, top:top + h, :left].zero_()
    if left + w < cols:
        half[:, :, top:top + h, left + w:].zero_()
    with span("unet.epilogue", "upconv"):
        conv_epilogue(y, bias=bias, into=(half[:, :, top:top + h, left:left + w],))


def _weight(w, key: str, dtype: torch.dtype, fmt: torch.memory_format) -> torch.Tensor:
    return w[key].to(dtype, memory_format=fmt)


def _conv_pad1(x, w, halo=None):
    """The DoubleConv's conv, zero padding 1; with halo (height-sharded
    serving) the rows above and below come from the neighbouring bands,
    and only the width is zero-padded."""
    if halo is None:
        return F.conv2d(x, w, padding=1)
    return F.conv2d(halo(x, 2), w, padding=(0, 1))


def _double_conv(x, *, prefix, w, norm, dtype, fmt, halo, probe, up_channels=0):
    """(conv -> BN -> activation -> compute dtype) x 2 of the DoubleConv at
    prefix: returns (y, what norm recorded for its two BatchNorms, the up
    block's concat buffer or None). With up_channels (a level whose output
    an up block reads as its skip), where ``_concat_in_place`` holds and C
    is a multiple of 8 (the upconv's channel offset in the buffer), the
    buffer is a new channels-last (N, C + up_channels, H, W) tensor and the
    second epilogue stores y into its lower C channels too. Pure but for
    that buffer, so recomputing it under torch.utils.checkpoint (which only
    records where no buffer is made) updates no statistic twice."""
    records, buf = [], None
    for i, site in enumerate(("conv1", "conv2")):
        if probe is not None:
            probe(site, x)
        weight = _weight(w, f"{prefix}.double_conv.{3 * i}.weight", dtype, fmt)
        with span("unet.conv", site):
            x = _conv_pad1(x, weight, halo)
        into = {}
        if i == 1 and up_channels and x.shape[1] % 8 == 0 and _concat_in_place(x, fmt, dtype):
            n, c, h, wd = x.shape
            buf = torch.empty((n, c + up_channels, h, wd), dtype=x.dtype, device=x.device,
                              memory_format=torch.channels_last)
            into = {"into": buf[:, :c]}
        x, record = norm(x, prefix, i, site, **into)
        x = x.to(dtype)
        records.append(record)
    return x, records, buf


def _walk(cfg: UNetConfig, w, x: torch.Tensor, dtype: torch.dtype, norm, fmt: torch.memory_format, *, probe=None,
          halo=None, remat: bool = False):
    """The float U-Net on NCHW x: returns (logits, float32 or float64, in
    the graph's layout; {DoubleConv prefix: (its input's (H, W), what norm
    recorded)}). norm(y, prefix, i, site) -> (BatchNorm i and activation of
    y, a record), and the eval norm takes into= (``bn_act``); probe as
    ``UNet.forward`` takes it; remat recomputes each DoubleConv in the
    backward.

    Where ``_concat_in_place`` holds (bfloat16 eval), each up block's input
    is one channels-last buffer [skip | pad(upconv)] that its producers
    write: the skip level's last epilogue (its own tensor, which the next
    max-pool reads, and the buffer's lower channels) and the upconv's bias
    epilogue (the upper ones, at the pad offset). Elsewhere the block pads
    the upconv's output and concatenates it with the skip."""
    blocks = {}
    L = cfg.num_levels

    def double_conv(h, prefix, block, level=None):
        at = None if probe is None else (lambda conv, t: probe(f"{block}/{conv}", t))
        # the channels of the upconv beside this level's skip in its up block
        up = w[f"up.{L - 2 - level}.up.weight"].shape[1] if level is not None and level < L - 1 else 0
        fn = functools.partial(_double_conv, prefix=prefix, w=w, norm=norm, dtype=dtype, fmt=fmt, halo=halo,
                               probe=at, up_channels=up)
        y, records, buf = torch.utils.checkpoint.checkpoint(fn, h, use_reentrant=False) if remat else fn(h)
        blocks[prefix] = (h.shape[2:], records)
        return y, buf

    with full_precision(dtype):
        with span("unet.block", "inc"):
            skip, buf = double_conv(x.to(dtype, memory_format=fmt), "inc", "inc", 0)
        skips, concat = [skip], [buf]
        for i in range(L - 1):
            with span("unet.block", f"down_{i}"):
                h = F.max_pool2d(skips[-1], cfg.maxpool_size)
                if concat[-1] is not None:  # pooled: the buffer holds the skip from here on
                    skips[-1] = concat[-1][:, :skips[-1].shape[1]]
                skip, buf = double_conv(h, f"down.{i}.maxpool_conv.1", f"down_{i}", i + 1)
            skips.append(skip)
            concat.append(buf)
        h = skips[-1]
        for j in range(L - 1):
            block, skip, buf = f"up_{j}", skips[-2 - j], concat[-2 - j]
            with span("unet.block", block):
                if probe is not None:
                    probe(f"{block}/upconv", h)
                weight, bias = _weight(w, f"up.{j}.up.weight", dtype, fmt), w[f"up.{j}.up.bias"].to(dtype)
                with span("unet.conv", "upconv"):
                    y = F.conv_transpose2d(h, weight, stride=cfg.upconv_stride)
                dy, dx = skip.shape[2] - y.shape[2], skip.shape[3] - y.shape[3]
                if buf is not None and dy >= 0 and dx >= 0 and _concat_in_place(y, fmt, dtype):
                    _upconv_into(y, bias, buf[:, skip.shape[1]:], dy // 2, dx // 2)
                    h = buf
                else:
                    if _fused(y):
                        with span("unet.epilogue", "upconv"):
                            y = conv_epilogue(y, bias=bias)
                    else:
                        y = y + bias.view(1, -1, 1, 1)
                    y = F.pad(y, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
                    h = torch.cat([skip, y], dim=1)
                h, _ = double_conv(h, f"up.{j}.conv", block)
        with span("unet.block", "outc"):
            weight, bias = _weight(w, "outc.conv.weight", dtype, fmt), w["outc.conv.bias"].to(dtype)
            with span("unet.conv", "conv"):
                out = F.conv2d(h, weight)
            out = out + bias.view(1, -1, 1, 1)
            return out.to(torch.promote_types(dtype, torch.float32)), blocks


class _Leaves:
    """A module's parameters and buffers by state-dict name, read from their
    modules at lookup: it follows ``.to()`` and loads, and walks no tree."""

    def __init__(self, root: nn.Module):
        self._at = {f"{name}.{leaf}": (m, leaf) for name, m in root.named_modules()
                    for leaf in (*m._parameters, *m._buffers)}

    def __getitem__(self, key: str) -> torch.Tensor:
        m, leaf = self._at[key]
        return getattr(m, leaf)


class UNet(nn.Module):
    """Eval-mode U-Net on NCHW input; returns NCHW-contiguous float32
    logits. Its convs run channels-last in bfloat16 and in the input's
    layout in float32 (``memory_format``)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        dims = cfg.layer_dimensions
        self.cfg = cfg
        self.compute_dtype = torch.float32
        self.inc = DoubleConv(cfg.n_channels, dims[0], cfg.kernel_size, cfg.activation)
        self.down = nn.ModuleList(Down(dims[i], dims[i + 1], cfg) for i in range(len(dims) - 1))
        self.up = nn.ModuleList(
            Up(dims[i], dims[i - 1], cfg) for i in range(len(dims) - 1, 0, -1)
        )
        self.outc = OutConv(dims[0], cfg.n_classes)
        self._leaves = _Leaves(self)
        self.eval()

    def fold_batch_norm(self) -> None:
        """Recompute every DoubleConv's folded eval BN from its running
        statistics and affine; needed after they change in place."""
        for m in self.modules():
            if isinstance(m, DoubleConv):
                m.fold_batch_norm()

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.fold_batch_norm()
        return out

    def to_compute_dtype(self, dtype: torch.dtype) -> "UNet":
        """Run the convs in ``dtype``: their weights and biases are stored in
        it, the weights in the graph's memory format (``memory_format``:
        channels-last in bfloat16, NCHW in float32), so the forward casts
        and lays out only activations; BatchNorm stays float32."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        self.compute_dtype = dtype
        weights = torch.channels_last if memory_format(dtype) == torch.channels_last else torch.contiguous_format
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype, memory_format=weights)
        return self

    def forward(self, x: torch.Tensor, probe=None) -> torch.Tensor:
        """probe(site, h), where given, is called with the input of every
        conv: site is 'inc/conv1', 'down_0/conv2', 'up_1/upconv', ...; the
        int8 calibration records its activation statistics this way."""
        dtype, w = self.compute_dtype, self._leaves
        norm = _eval_norm(lambda p, i: (w[f"{p}.bn{i}_scale"], w[f"{p}.bn{i}_shift"]), self.cfg.activation)
        return _walk(self.cfg, w, x, dtype, norm, memory_format(dtype), probe=probe)[0].contiguous()


# ---------------------------------------------------------------------------
# Functional U-Net over reference-layout dictionaries (training, eval step)
# ---------------------------------------------------------------------------

Params = Dict[str, torch.Tensor]
BatchStats = Dict[str, torch.Tensor]


def unet_state_shapes(cfg: UNetConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of every reference state-dict entry of ``UNet(cfg)``."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in UNet(cfg).state_dict().items()
                if not k.endswith("num_batches_tracked")}


def is_batch_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def split_state_dict(state_dict) -> Tuple[Params, BatchStats]:
    """Reference-layout state dict -> (trainable parameters, running
    statistics) as float32 tensors; num_batches_tracked is dropped."""
    params, stats = {}, {}
    for k, v in state_dict.items():
        if not k.endswith("num_batches_tracked"):
            (stats if is_batch_stat(k) else params)[k] = torch.as_tensor(v, dtype=torch.float32)
    return params, stats


def init_unet(cfg: UNetConfig, generator: Optional[torch.Generator] = None) -> Tuple[Params, BatchStats]:
    """Fresh (params, batch_stats) on the CPU, drawn as the JAX package's
    ``init_unet`` draws them: every conv, upconv and head kernel and bias
    U(-b, b) with b = 1/sqrt(fan_in), fan_in = input channels x kh x kw (an
    upconv's input channels, where torch's ConvTranspose2d default takes its
    output channels); BatchNorm scale 1, bias 0, running mean 0, var 1."""
    shapes = unet_state_shapes(cfg)
    params, stats = {}, {}
    for k, shape in shapes.items():
        if is_batch_stat(k):
            stats[k] = torch.ones(shape) if k.endswith("running_var") else torch.zeros(shape)
            continue
        kernel = shapes[k.rsplit(".", 1)[0] + ".weight"]
        if len(kernel) == 4:
            transposed = k.split(".")[2] == "up"  # up.{j}.up.{weight,bias}: (in, out, kh, kw)
            fan_in = kernel[0 if transposed else 1] * kernel[2] * kernel[3]
            bound = fan_in ** -0.5
            params[k] = torch.empty(shape).uniform_(-bound, bound, generator=generator)
        else:
            params[k] = torch.ones(shape) if k.endswith(".weight") else torch.zeros(shape)
    return params, stats


def reinit_weights_normal(params: Params, generator: Optional[torch.Generator] = None, std: float = 0.01) -> Params:
    """The reference trainer re-initializes every parameter whose name holds
    'weight' (conv and upconv kernels AND BatchNorm scales) to N(0, std),
    leaving biases as they are (ref train_utils/train_unet.py:246-250)."""
    return {k: std * torch.randn(v.shape, generator=generator) if k.endswith(".weight") else v
            for k, v in params.items()}


def _c(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _batch_norm(y, bn, params, sample_weight, reduce=None, n_samples=None):
    """Train BatchNorm bn ('{prefix}.double_conv.{1|4}') of y: returns (out,
    batch mean, biased batch var). The statistics are taken in float32 as
    mean(x^2) - mean(x)^2, mask-weighted with sample_weight ((N, 1, 1, 1) of
    0/1), as ``gelslim_depth_tpu.models.unet._batch_norm`` takes them. With
    reduce, the per-channel sums of x and x^2 are summed over the ranks and
    divided by the ranks' n_samples (valid samples in all) times the
    pixels."""
    scale, bias = params[f"{bn}.weight"], params[f"{bn}.bias"]
    yf = y.to(torch.promote_types(y.dtype, torch.float32))  # bf16 -> f32; f64 stays
    if reduce is not None:
        yw = yf if sample_weight is None else yf * sample_weight
        sums = reduce(torch.cat([yw.sum((0, 2, 3)), (yf * yw).sum((0, 2, 3))]))
        n = n_samples * (y.shape[2] * y.shape[3])
        m, sq = sums[: y.shape[1]] / n, sums[y.shape[1]:] / n
        v = sq - m * m
    elif sample_weight is None:
        m = yf.mean((0, 2, 3))
        v = (yf * yf).mean((0, 2, 3)) - m * m
    else:
        yw = yf * sample_weight
        n = sample_weight.sum() * (y.shape[2] * y.shape[3])
        m = yw.sum((0, 2, 3)) / n
        v = (yf * yw).sum((0, 2, 3)) / n - m * m
    return (yf - _c(m)) * _c(torch.rsqrt(v + BN_EPS)) * _c(scale) + _c(bias), m, v


def unet_apply(
    cfg: UNetConfig,
    params: Params,
    batch_stats: BatchStats,
    x: torch.Tensor,
    *,
    train: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    sample_mask: Optional[torch.Tensor] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    channels_last: bool = False,
    halo: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, BatchStats]:
    """Run the U-Net on NCHW x over reference-layout dictionaries: params
    (conv kernels and biases, BN weight and bias) and batch_stats (BN
    running mean and var). Returns (float32 logits, new batch_stats); in
    eval mode, ``UNet``'s graph on the same weights, batch_stats comes back
    as given. compute_dtype float64 runs the whole graph in float64
    (float64 logits): the exact reference that a float32 step's gradients
    are held to.

    train=True normalizes with batch statistics and returns the running
    statistics updated with momentum 0.1; sample_mask ((N,) bool) excludes
    padded samples from every batch statistic and update. remat=True
    recomputes each DoubleConv in the backward (torch.utils.checkpoint).
    float32 runs its convs with cuDNN TF32 off; a train step holds
    ``full_precision`` across its forward and backward.

    reduce, for data-parallel training, sums a tensor over the ranks,
    differentiably (``parallel.Mesh.all_reduce_grad``): x is then this
    rank's rows of a global batch, and every train-mode batch statistic,
    and the running variance's sample count, is taken over all the ranks'
    rows, so the ranks normalize alike and equal the single-device math on
    the global batch. Without it the statistics are this call's alone.

    channels_last=True takes NHWC x and returns NHWC logits; the graph runs
    on x's NCHW view in ``torch.channels_last`` memory format (no copy).

    halo, for height-sharded serving (``parallel.make_spatial_predictor``),
    pads a tensor's dim (2 here) with one row above and one below from the
    neighbouring bands, zeros at the image's edges: every 3x3 conv then
    reads it and pads only the width, so x is this rank's band of rows and
    the output its band of the whole image's logits. The max-pools and
    transposed convs need no halo on the bands of ``spatial_band_plan``."""
    if channels_last:
        x = x.permute(0, 3, 1, 2)
    dtype = compute_dtype
    if not train:
        def fold(prefix, i):  # DoubleConv.fold_batch_norm's expression
            bn = f"{prefix}.double_conv.{3 * i + 1}"
            inv = torch.rsqrt(batch_stats[f"{bn}.running_var"] + BN_EPS) * params[f"{bn}.weight"]
            return _c(inv), _c(params[f"{bn}.bias"] - batch_stats[f"{bn}.running_mean"] * inv)

        out, _ = _walk(cfg, params, x, dtype, _eval_norm(fold, cfg.activation), memory_format(dtype), halo=halo,
                       remat=remat)
        return (out.permute(0, 2, 3, 1) if channels_last else out), batch_stats

    sample_weight = n_samples = None
    count = x.shape[0]
    if sample_mask is not None:
        sample_weight = sample_mask.to(torch.float32).view(-1, 1, 1, 1)
        count = sample_weight.sum()
    if reduce is not None:
        count = torch.tensor(float(count), device=x.device) if sample_weight is None else count
        count = n_samples = reduce(count.reshape(1).to(torch.promote_types(x.dtype, torch.float32)))[0]
    act = activation_fn(cfg.activation)

    def norm(y, prefix, i, site):
        y, m, v = _batch_norm(y, f"{prefix}.double_conv.{3 * i + 1}", params, sample_weight, reduce, n_samples)
        return act(y), (m, v)

    out, blocks = _walk(cfg, params, x, dtype, norm, memory_format(dtype, train=True), halo=halo, remat=remat)
    new_stats = dict(batch_stats)
    for prefix, (hw, moments) in blocks.items():
        # the running var takes the unbiased estimate; n counts the block
        # input's pixels, as the JAX package counts them
        n = count * (hw[0] * hw[1])
        corr = n / torch.clamp(n - 1.0, min=1.0) if torch.is_tensor(n) else n / max(n - 1, 1)
        for i, (m, v) in zip((1, 4), moments):
            mean, var = f"{prefix}.double_conv.{i}.running_mean", f"{prefix}.double_conv.{i}.running_var"
            new_stats[mean] = (1 - BN_MOMENTUM) * batch_stats[mean] + BN_MOMENTUM * m.detach()
            new_stats[var] = (1 - BN_MOMENTUM) * batch_stats[var] + BN_MOMENTUM * v.detach() * corr
    return (out.permute(0, 2, 3, 1) if channels_last else out), new_stats
