"""U-Net for tactile depth estimation, eval forward, as a PyTorch module.

The counterpart of ``gelslim_depth_tpu.models.unet.unet_apply(train=False)``.
Submodule and parameter names are the reference's state-dict keys
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

Eval BatchNorm folds the running statistics into one affine
``x * inv + (bias - mean * inv)`` with ``inv = rsqrt(var + 1e-5) * scale``.
The fold is computed once, by ``fold_batch_norm``, which construction and
``load_state_dict`` call; the forward only applies it.

Each block of the forward and each conv launch in it runs inside a
``utils.profiling.span`` (``unet.block``, ``unet.conv``); the conv's span
holds the conv call alone, its casts lie in the block's. Each conv's
epilogue (the BatchNorm affine, activation and cast of a DoubleConv conv,
the upconv's bias add) is one ``conv_epilogue`` call in a ``unet.epilogue``
span beside the conv's, in the block's; where autograd records (grad
enabled and the conv's output requires grad) it stays the chain of aten
ops that the kernel equals bit for bit. Off, a span costs a call and a
``with``.

Compute dtype (``to_compute_dtype``): float32 runs every conv in full
float32, TF32 off for the forward whatever ``torch.backends.cudnn.allow_tf32``
says, as the JAX package's ``Precision.HIGHEST`` does. bfloat16 follows
``unet_apply(compute_dtype=bfloat16)`` rounding for rounding:
- a conv's output stays bfloat16;
- the BN affine promotes to float32 (bf16 tensor times f32 vector), goes
  through the activation, and is cast back to bfloat16;
- the upconv output gets its bfloat16 bias added in bfloat16;
- the head conv adds its bias in bfloat16, then casts to float32.

Layout (``UNet.channels_last``), by compute dtype. bfloat16 runs the eval
forward channels-last end to end: ``to_compute_dtype`` stores the conv,
upconv and head weights in ``torch.channels_last`` once, the input is made
channels-last once at the entry of ``inc``, and every intermediate stays so
(conv outputs, ``conv_epilogue``'s, which keeps its input's layout, the
max-pools, the ``Up`` pad and concat), so cuDNN runs its NHWC kernels with
no NCHW<->NHWC transpose around them. float32 keeps NCHW weights and runs
in its input's layout, NCHW from every caller: with TF32 off, cuDNN's
float32 convs transpose in either layout, and on an H100 the float32 train
step ran slower in NHWC (105.0 against 93.4 ms; PERF.md). Either way the
forward returns NCHW-contiguous float32 logits.

Training runs ``unet_apply``, the functional counterpart of
``gelslim_depth_tpu.models.unet.unet_apply``: the same graph over
reference-layout dictionaries of parameters and running statistics, in
train mode (batch statistics, optionally mask-weighted, and a functional
running-stat update) or in eval mode (the BN folded on the fly, so it
follows parameters and statistics that change every step). Its float32
parameters are cast to the compute dtype inside the forward, so bfloat16
gradients land on float32 masters. ``channels_last=True`` takes and
returns NHWC tensors, as the JAX package's does: their NCHW views are
in ``torch.channels_last`` memory format, which cuDNN's bfloat16 convs
read with no layout transpose (its float32 ones still transpose; PERF.md
has the times). ``init_unet`` and
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


def _activation_fn(name: str):
    if name == "relu":
        return F.relu
    if name == "tanh":
        return torch.tanh
    if name == "mish":
        return lambda x: x * torch.tanh(F.softplus(x))
    raise ValueError(f"Unknown activation {name!r}; expected relu|tanh|mish")


class Activation(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.fn = _activation_fn(name)
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

    def forward(self, x: torch.Tensor, dtype: torch.dtype, probe=None) -> torch.Tensor:
        conv1, _, act, conv2, _, _ = self.double_conv
        if probe is not None:
            probe("conv1", x)
        x = x.to(dtype)
        with span("unet.conv", "conv1"):
            y = F.conv2d(x, conv1.weight, padding=1)
        y = bn_act(y, self.bn0_scale, self.bn0_shift, act, "conv1")
        if probe is not None:
            probe("conv2", y)
        with span("unet.conv", "conv2"):
            y = F.conv2d(y, conv2.weight, padding=1)
        return bn_act(y, self.bn1_scale, self.bn1_shift, act, "conv2")


def bn_act(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, act: Activation, site: str) -> torch.Tensor:
    """A DoubleConv conv's folded eval BatchNorm (its (1, C, 1, 1) scale
    and shift) and activation of the conv's output y, rounded to y's dtype:
    one ``conv_epilogue`` in a ``unet.epilogue`` span, or the aten chain
    where autograd records."""
    if records_grad(y):
        return act(y * scale + shift).to(y.dtype)
    with span("unet.epilogue", site):
        return conv_epilogue(y, bn_mul=scale, bn_add=shift, act=act.name)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: UNetConfig):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(cfg.maxpool_size),
            DoubleConv(cin, cout, cfg.kernel_size, cfg.activation),
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype, probe=None) -> torch.Tensor:
        pool, dc = self.maxpool_conv
        return dc(pool(x), dtype, probe)


class Up(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: UNetConfig):
        super().__init__()
        self.stride = cfg.upconv_stride
        self.up = nn.ConvTranspose2d(cin, cin // 2, cfg.kernel_size - 1, stride=cfg.upconv_stride)
        # the reference's Up never forwards kernel_size to its DoubleConv
        self.conv = DoubleConv(cin, cout, 3, cfg.activation)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, dtype: torch.dtype, probe=None) -> torch.Tensor:
        if probe is not None:
            probe("upconv", x)
        x = x.to(dtype)
        with span("unet.conv", "upconv"):
            y = F.conv_transpose2d(x, self.up.weight, stride=self.stride)
        if records_grad(y):
            y = y + self.up.bias.view(1, -1, 1, 1)
        else:
            with span("unet.epilogue", "upconv"):
                y = conv_epilogue(y, bias=self.up.bias)
        dy = skip.shape[2] - y.shape[2]
        dx = skip.shape[3] - y.shape[3]
        y = F.pad(y, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([skip.to(dtype), y], dim=1), dtype, probe)


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        with span("unet.conv", "conv"):
            out = F.conv2d(x, self.conv.weight)
        out = out + self.conv.bias.view(1, -1, 1, 1)
        return out.float()


class UNet(nn.Module):
    """Eval-mode U-Net on NCHW input; returns NCHW-contiguous float32
    logits. Its convs run channels-last in bfloat16 and NCHW in float32
    (``channels_last``; the module's docstring says why)."""

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
        it, the weights channels-last in bfloat16 (``channels_last``), so
        the forward casts and lays out only activations; BatchNorm stays
        float32."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        self.compute_dtype = dtype
        weights = torch.channels_last if self.channels_last else torch.contiguous_format
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype, memory_format=weights)
        return self

    @property
    def channels_last(self) -> bool:
        """Whether the eval forward runs channels-last: in bfloat16 it does;
        float32 keeps NCHW weights and the input's layout (the module's
        docstring says why)."""
        return self.compute_dtype == torch.bfloat16

    def forward(self, x: torch.Tensor, probe=None) -> torch.Tensor:
        """probe(site, h), where given, is called with the input of every
        conv: site is 'inc/conv1', 'down_0/conv2', 'up_1/upconv', ...; the
        int8 calibration records its activation statistics this way."""
        dtype = self.compute_dtype

        def at(block):
            return None if probe is None else lambda conv, h: probe(f"{block}/{conv}", h)

        with full_precision(dtype):
            with span("unet.block", "inc"):
                if self.channels_last:
                    x = x.to(dtype, memory_format=torch.channels_last)
                skips = [self.inc(x, dtype, at("inc"))]
            for i, down in enumerate(self.down):
                with span("unet.block", f"down_{i}"):
                    skips.append(down(skips[-1], dtype, at(f"down_{i}")))
            h = skips[-1]
            for j, up in enumerate(self.up):
                with span("unet.block", f"up_{j}"):
                    h = up(h, skips[-2 - j], dtype, at(f"up_{j}"))
            with span("unet.block", "outc"):
                return self.outc(h, dtype).contiguous()


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


def _batch_norm(y, prefix, i, params, stats, train, sample_weight, reduce=None, n_samples=None):
    """BatchNorm i of a DoubleConv: returns (out, batch mean, biased batch
    var), the statistics None in eval. Train statistics are taken in
    float32 as mean(x^2) - mean(x)^2, mask-weighted with sample_weight
    ((N, 1, 1, 1) of 0/1), as ``gelslim_depth_tpu.models.unet._batch_norm``
    takes them; eval folds the running statistics on the fly. With reduce,
    the per-channel sums of x and x^2 are summed over the ranks and divided
    by the ranks' n_samples (valid samples in all) times the pixels."""
    scale, bias = params[f"{prefix}.{i}.weight"], params[f"{prefix}.{i}.bias"]
    if not train:
        inv = torch.rsqrt(stats[f"{prefix}.{i}.running_var"] + BN_EPS) * scale
        return y * _c(inv) + _c(bias - stats[f"{prefix}.{i}.running_mean"] * inv), None, None
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


def _conv_pad1(x, w, halo=None):
    """The DoubleConv's conv, zero padding 1; with halo (height-sharded
    serving) the rows above and below come from the neighbouring bands,
    and only the width is zero-padded."""
    if halo is None:
        return F.conv2d(x, w, padding=1)
    return F.conv2d(halo(x, 2), w, padding=(0, 1))


def _double_conv(x, prefix, *, params, stats, act, train, dtype, sample_weight, reduce=None, n_samples=None,
                 halo=None):
    """(conv -> BN -> activation) x 2 as a pure function: returns (y, the
    block's new running statistics | None). It mutates nothing, so
    recomputing it under torch.utils.checkpoint updates no statistic twice."""
    y = _conv_pad1(x.to(dtype), params[f"{prefix}.0.weight"].to(dtype), halo)
    y, m1, v1 = _batch_norm(y, prefix, 1, params, stats, train, sample_weight, reduce, n_samples)
    y = act(y).to(dtype)
    y = _conv_pad1(y, params[f"{prefix}.3.weight"].to(dtype), halo)
    y, m2, v2 = _batch_norm(y, prefix, 4, params, stats, train, sample_weight, reduce, n_samples)
    y = act(y).to(dtype)
    if not train:
        return y, None
    # the running var takes the unbiased estimate; n counts the block
    # input's pixels, as the JAX package counts them
    if reduce is not None:
        n = n_samples * (x.shape[2] * x.shape[3])
        corr = n / torch.clamp(n - 1.0, min=1.0)
    elif sample_weight is None:
        n = x.shape[0] * x.shape[2] * x.shape[3]
        corr = n / max(n - 1, 1)
    else:
        n = sample_weight.sum() * (x.shape[2] * x.shape[3])
        corr = n / torch.clamp(n - 1.0, min=1.0)
    updates = {}
    for i, m, v in ((1, m1, v1), (4, m2, v2)):
        mean, var = f"{prefix}.{i}.running_mean", f"{prefix}.{i}.running_var"
        updates[mean] = (1 - BN_MOMENTUM) * stats[mean] + BN_MOMENTUM * m.detach()
        updates[var] = (1 - BN_MOMENTUM) * stats[var] + BN_MOMENTUM * v.detach() * corr
    return y, updates


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
    running mean and var). Returns (float32 NCHW logits, new batch_stats);
    in eval mode batch_stats comes back as given. compute_dtype float64
    runs the whole graph in float64 (float64 logits): the exact reference
    that a float32 step's gradients are held to.

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
    sample_weight = None
    if train and sample_mask is not None:
        sample_weight = sample_mask.to(torch.float32).view(-1, 1, 1, 1)
    n_samples = None
    if train and reduce is not None:
        count = torch.tensor(float(x.shape[0]), device=x.device) if sample_weight is None else sample_weight.sum()
        n_samples = reduce(count.reshape(1).to(torch.promote_types(x.dtype, torch.float32)))[0]
    dtype = compute_dtype
    dc = functools.partial(_double_conv, params=params, stats=batch_stats, act=_activation_fn(cfg.activation),
                           train=train, dtype=dtype, sample_weight=sample_weight,
                           reduce=reduce if train else None, n_samples=n_samples, halo=halo)
    new_stats = dict(batch_stats) if train else batch_stats

    def run_dc(h, prefix):
        y, updates = torch.utils.checkpoint.checkpoint(dc, h, prefix, use_reentrant=False) if remat else dc(h, prefix)
        if train:
            new_stats.update(updates)
        return y

    with full_precision(dtype):
        skips = [run_dc(x, "inc.double_conv")]
        for i in range(cfg.num_levels - 1):
            h = F.max_pool2d(skips[-1], cfg.maxpool_size)
            skips.append(run_dc(h, f"down.{i}.maxpool_conv.1.double_conv"))
        h = skips[-1]
        for j in range(cfg.num_levels - 1):
            skip = skips[-2 - j]
            y = F.conv_transpose2d(h.to(dtype), params[f"up.{j}.up.weight"].to(dtype), stride=cfg.upconv_stride)
            y = y.to(dtype) + _c(params[f"up.{j}.up.bias"].to(dtype))
            dy, dx = skip.shape[2] - y.shape[2], skip.shape[3] - y.shape[3]
            y = F.pad(y, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
            h = run_dc(torch.cat([skip.to(dtype), y], dim=1), f"up.{j}.conv.double_conv")
        out = F.conv2d(h.to(dtype), params["outc.conv.weight"].to(dtype))
        out = out + _c(params["outc.conv.bias"].to(out.dtype))
    out = out.to(torch.promote_types(out.dtype, torch.float32))
    return (out.permute(0, 2, 3, 1) if channels_last else out), new_stats
