"""Post-training int8 quantization of the U-Net for eval-mode serving.

The counterpart of ``gelslim_depth_tpu/models/quantize.py``; the same
scheme, rounding point for rounding point:
- Weights: symmetric per-output-channel int8, ``s_w[o] = max|w[o]| / 127``
  (a zero channel gets scale 1).
- Activations: symmetric per-tensor int8 with static scales, calibrated as
  ``stat(|x|) / 127`` at every quantized conv's input in a float32 forward;
  stat is the max, or a percentile with linear interpolation.
- Quantized: both convs of every DoubleConv except the first (``inc/conv1``
  keeps the 3-channel image in float), and optionally the transposed convs
  whose kernel equals their stride, as a row-split 1x1 conv. The 1x1 head,
  the float upconvs and ``inc/conv1`` run in the compute dtype; the float
  upconvs' and ``inc/conv1``'s epilogues (bias, or BatchNorm and the
  activation, the rounding, and the quantization for the next int8 conv)
  are one ``conv_epilogue`` each.
- Each quantized conv is ``conv2d_int8``: int32 sums, then one epilogue
  ``float(acc) * (s_x * s_w[o])``, the folded eval BatchNorm and the
  activation, rounded to the compute dtype, and stored int8 at its
  consumers' scales (the compute dtype only where a float op reads it).
- Skips are quantized at production with their consumer ``up_j/conv1``'s
  scale; the upconv output is quantized with the same scale, and
  ``up_j/conv1`` reads the int8 concat ``[skip, pad(up)]`` in place.

Layouts. Activations stay NHWC through the int8 graph; the float convs run
on their channels-last NCHW views. The port stores int8 conv weights OHWI
``(cout, kh, kw, cin)``, so both GEMM operands are contiguous along K, and
the row-split upconv as a 1x1 conv ``(s*s*cout, 1, 1, cin)`` whose column
``(di*s + dj)*cout + o`` holds ``w[c, o, di, dj]`` of the reference-layout
``(cin, cout, s, s)`` weight. ``hwio_from_ohwi``/``ohwi_from_hwio`` and
``rowsplit_to_jax``/``rowsplit_from_jax`` convert to and from the JAX
package's HWIO and ``(s, cin, s*cout)`` layouts. ``unet_apply_int8``,
``calibrate_act_scales`` and ``quantize_unet`` take ``channels_last``:
NHWC inputs (and NHWC logits out), as the JAX package's do.

Height-sharded serving (``parallel.make_spatial_predictor_int8``) passes
``QuantizedUNet.forward`` a ``halo``: each 3x3 conv then runs on its input
padded with the neighbouring bands' edge rows, ``pad=1`` on that, and
drops the two rows the extra padding adds.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gelslim_depth_tpu_torch.models.unet import DoubleConv, UNet, UNetConfig, full_precision
from gelslim_depth_tpu_torch.ops.kernels.conv_epilogue import conv_epilogue
from gelslim_depth_tpu_torch.ops.kernels.conv_int8 import Epilogue, conv2d_int8, quant_act
from gelslim_depth_tpu_torch.utils.profiling import span


def _quantized_sites(cfg: UNetConfig) -> List[Tuple[str, str]]:
    """(block, conv) pairs that run on the int8 path."""
    sites = [("inc", "conv2")]
    for i in range(cfg.num_levels - 1):
        sites += [(f"down_{i}", "conv1"), (f"down_{i}", "conv2")]
    for j in range(cfg.num_levels - 1):
        sites += [(f"up_{j}", "conv1"), (f"up_{j}", "conv2")]
    return sites


class SiteLaunch(NamedTuple):
    """One quantized conv's ``conv2d_int8`` launch in a ``QuantizedUNet``
    forward: its input (``x2_shape``: the upconv output that ``up_j/conv1``
    reads beside its skip, at ``offset``), Cout, kernel size, and what its
    epilogue stores: ``n_q`` int8 outputs, and the compute-dtype one where
    ``store_float``."""

    site: str
    x_shape: Tuple[int, int, int, int]  # NHWC, the skip at up_j/conv1
    x2_shape: Optional[Tuple[int, int, int, int]]
    offset: Tuple[int, int]
    cout: int
    k: int
    n_q: int
    store_float: bool


def serving_launches(cfg: UNetConfig, n: int, hw: Tuple[int, int], int8_upconvs: bool = False) -> List[SiteLaunch]:
    """The launches of the quantized sites, in ``_quantized_sites`` order,
    for an ``(n, n_channels, *hw)`` input, as ``QuantizedUNet.forward``
    makes them (with or without int8 upconvs): the shapes are read off a
    forward of the float U-Net on the meta device."""
    L = cfg.num_levels
    net, shapes = _probe_shapes(cfg, n, hw)
    out = []
    for block, conv in _quantized_sites(cfg):
        site = f"{block}/{conv}"
        weight = _double_conv(net, block).double_conv[0 if conv == "conv1" else 3].weight
        cout, k = weight.shape[0], weight.shape[2]
        b, c, h, wd = shapes[site]
        x_shape, x2_shape, offset, n_q = (b, h, wd, c), None, (0, 0), 1
        if block.startswith("up_"):
            j = int(block[3:])
            if conv == "conv1":  # [skip, up]: each half of the channels
                hin, win = shapes[f"{block}/upconv"][2:]
                h2, w2 = [(e - 1) * cfg.upconv_stride + cfg.kernel_size - 1 for e in (hin, win)]
                x_shape, x2_shape = (b, h, wd, c // 2), (b, h2, w2, c // 2)
                offset = ((h - h2) // 2, (wd - w2) // 2)
            elif j == L - 2 or not int8_upconvs:
                n_q = 0
        elif conv == "conv2":
            level = 0 if block == "inc" else int(block[5:]) + 1
            n_q = 2 if level < L - 1 else int(int8_upconvs)
        out.append(SiteLaunch(site, x_shape, x2_shape, offset, cout, k, n_q, n_q == 0))
    return out


def _probe_shapes(cfg: UNetConfig, n: int, hw: Tuple[int, int]):
    """(meta-device UNet, {probe site: NCHW input shape}) of a forward."""
    with torch.device("meta"):
        net = UNet(cfg)
        shapes = {}
        net(torch.empty((n, cfg.n_channels, *hw)), probe=lambda site, h: shapes.setdefault(site, h.shape))
    return net, shapes


def _upconv_sites(cfg: UNetConfig) -> List[str]:
    """Blocks whose transposed conv can run on the int8 row-split path
    (kernel == stride, the reference's k=2/s=2 case)."""
    if cfg.kernel_size - 1 != cfg.upconv_stride:
        return []
    return [f"up_{j}" for j in range(cfg.num_levels - 1)]


def hwio_from_ohwi(q: torch.Tensor) -> torch.Tensor:
    return q.permute(1, 2, 3, 0).contiguous()


def ohwi_from_hwio(q: torch.Tensor) -> torch.Tensor:
    return q.permute(3, 0, 1, 2).contiguous()


def rowsplit_to_jax(q: torch.Tensor, s: int) -> torch.Tensor:
    """(s*s*cout, 1, 1, cin) -> the JAX pack (s, cin, s*cout)."""
    cin = q.shape[-1]
    return q.reshape(s, -1, cin).permute(0, 2, 1).contiguous()


def rowsplit_from_jax(m: torch.Tensor) -> torch.Tensor:
    """The JAX pack (s, cin, s*cout) -> (s*s*cout, 1, 1, cin)."""
    return m.permute(0, 2, 1).reshape(-1, 1, 1, m.shape[1]).contiguous()


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW float32 conv weight -> (int8 OHWI, per-cout float32 scale)."""
    s = w.abs().amax(dim=(1, 2, 3)) / 127.0
    s = torch.where(s == 0, 1.0, s)
    q = torch.clamp(torch.round(w / s.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return q.permute(0, 2, 3, 1).contiguous(), s


def pack_upconv_rowsplit(w: torch.Tensor) -> torch.Tensor:
    """Reference-layout transposed-conv weight (cin, cout, s, s) -> the
    (s*s*cout, 1, 1, cin) 1x1 conv whose depth-to-space output (stride s)
    is the transposed conv, for kernel == stride."""
    cin, cout, s, _ = w.shape
    return w.permute(2, 3, 1, 0).reshape(s * s * cout, 1, 1, cin).contiguous()


def quantize_upconv_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cin, cout, s, s) float32 -> (int8 row-split pack (s*s*cout, 1, 1,
    cin), per-column scale (s*cout,) as the JAX package stores it: the
    per-cout scale repeated s times)."""
    s_o = w.abs().amax(dim=(0, 2, 3)) / 127.0
    s_o = torch.where(s_o == 0, 1.0, s_o)
    k = w.shape[2]
    m = pack_upconv_rowsplit(w)
    q = torch.clamp(torch.round(m / s_o.repeat(k * k).view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return q, s_o.repeat(k)


def _percentile(a: torch.Tensor, percentile: float) -> torch.Tensor:
    """``jnp.percentile(a.reshape(-1), percentile)``: linear interpolation
    between the order statistics around ``q * (n - 1)``, with q and the
    position computed in float32 as there. ``torch.quantile`` refuses inputs
    over 2^24 elements; two ``kthvalue`` selections take any size."""
    v = a.reshape(-1).float()
    n = v.numel()
    pos = np.float32(np.float32(percentile) / np.float32(100.0)) * (np.float32(n) - np.float32(1.0))
    lo, hi = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - lo)
    lw = np.float32(np.float32(1.0) - hw)
    lo_v = torch.kthvalue(v, int(min(max(lo, 0), n - 1)) + 1).values
    hi_v = torch.kthvalue(v, int(min(max(hi, 0), n - 1)) + 1).values
    return lo_v * torch.tensor(lw, device=v.device) + hi_v * torch.tensor(hw, device=v.device)


@torch.no_grad()
def calibrate_act_scales(
    net: UNet,
    calib_x: torch.Tensor,
    *,
    percentile: float = 100.0,
    quantize_upconvs: bool = False,
    channels_last: bool = False,
) -> Dict[str, float]:
    """Static per-tensor activation scales from a float32 eval forward of
    ``net`` (a float32 ``UNet``, TF32 off) over a representative NCHW batch
    (NHWC with channels_last): ``stat(|x|) / 127`` at each quantized site's
    input, or 1 where that is 0. stat is the max (percentile 100) or the
    given percentile. quantize_upconvs also records ``up_j/upconv`` sites."""
    if net.compute_dtype != torch.float32:
        raise ValueError("calibration runs the float32 forward: pass a float32 UNet")
    cfg = net.cfg
    wanted = {f"{b}/{c}" for b, c in _quantized_sites(cfg)}
    if quantize_upconvs:
        wanted |= {f"{b}/upconv" for b in _upconv_sites(cfg)}
    record: Dict[str, torch.Tensor] = {}

    def probe(site, h):
        if site in wanted:
            a = h.abs()
            record[site] = a.amax() if percentile >= 100.0 else _percentile(a, percentile)

    # an NCHW copy: the scales are the NCHW forward's, whatever the layout
    net(_nchw(calib_x, channels_last).float().contiguous(), probe=probe)
    return {k: float(v) / 127.0 if float(v) > 0 else 1.0 for k, v in sorted(record.items())}


def _nchw(x: torch.Tensor, channels_last: bool) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if channels_last else x


def _double_conv(net: UNet, block: str) -> DoubleConv:
    if block == "inc":
        return net.inc
    kind, i = block.split("_")
    return net.down[int(i)].maxpool_conv[1] if kind == "down" else net.up[int(i)].conv


def _buffer_name(kind: str, site: str) -> str:
    return f"{kind}__{site.replace('/', '__')}"


class QuantizedUNet(nn.Module):
    """Everything the int8 eval forward needs, as buffers of one module:
    - ``net``: the float32 ``UNet`` with the original float parameters; its
      ``inc/conv1``, upconvs and head still run, its folded BatchNorms feed
      the int8 epilogues, and it is the float graph of ``float_delta``;
    - the int8 weights (``w8(site)``) and their float32 scales
      (``w_scale(site)``), per site ``'inc/conv2'``, ``'up_1/upconv'``, ...;
    - the activation scales as float32 0-d tensors (``act_scale(site)``):
      ``set_act_scales`` overwrites them in place and rebuilds nothing;
    - ``float_delta``: output RMSE against the float32 graph on the
      calibration batch, in network-output units (normalized depth).
    Build one with ``quantize_unet``."""

    def __init__(self, net: UNet, w8, w_scale, act_scale, float_delta: float = 0.0):
        super().__init__()
        if net.compute_dtype != torch.float32:
            raise ValueError("QuantizedUNet keeps the float32 UNet: pass one")
        self.cfg = net.cfg
        self.net = net
        self.sites = tuple(w8)
        dev = net.outc.conv.weight.device
        for site in self.sites:
            self.register_buffer(_buffer_name("w8", site), w8[site].to(dev))
            self.register_buffer(_buffer_name("w_scale", site), w_scale[site].to(device=dev, dtype=torch.float32))
        for site in act_scale:
            self.register_buffer(_buffer_name("act", site), torch.zeros((), device=dev))
        self.act_sites = tuple(sorted(act_scale))
        # the epilogue scales in_s * w_s[o] (s*s columns for an upconv),
        # kept beside the scales they derive from; set_act_scales refreshes them
        for site in self.sites:
            cols = self.w8(site).shape[0]
            self.register_buffer(_buffer_name("escale", site), torch.zeros(cols, device=dev))
        for block in {s.split("/")[0] for s in self.sites if s.endswith("/upconv")}:
            up = self._up(block)
            k = up.stride
            self.register_buffer(_buffer_name("bias", block), up.up.bias.detach().float().repeat(k * k))
        self.register_buffer("float_delta", torch.tensor(float(float_delta), device=dev))
        self.set_act_scales(act_scale)
        self._float_cache = {}

    def w8(self, site: str) -> torch.Tensor:
        return self.get_buffer(_buffer_name("w8", site))

    def w_scale(self, site: str) -> torch.Tensor:
        return self.get_buffer(_buffer_name("w_scale", site))

    def act_scale(self, site: str) -> torch.Tensor:
        return self.get_buffer(_buffer_name("act", site))

    def _escale(self, site: str) -> torch.Tensor:
        return self.get_buffer(_buffer_name("escale", site))

    def act_scales(self) -> Dict[str, float]:
        return {s: float(self.act_scale(s)) for s in self.act_sites}

    @property
    def has_int8_upconvs(self) -> bool:
        return any(s.endswith("/upconv") for s in self.sites)

    @torch.no_grad()
    def set_act_scales(self, scales: Dict[str, float]) -> None:
        """Overwrite the activation scales, and the epilogue scales built
        from them, in place: ``in_s * w_s`` in float32, as the JAX package
        computes it per call."""
        if set(scales) != set(self.act_sites):
            raise KeyError(f"act scales for {sorted(scales)}, want {sorted(self.act_sites)}")
        for site, v in scales.items():
            self.act_scale(site).fill_(float(np.float32(v)))
        for site in self.sites:
            prod = self.act_scale(site) * self.w_scale(site)
            if site.endswith("/upconv"):
                k = self._up(site.split("/")[0]).stride
                prod = prod.repeat(k)
            self._escale(site).copy_(prod)

    def _up(self, block: str):
        return self.net.up[int(block.split("_")[1])]

    def _float_weights(self, dtype: torch.dtype):
        """The float convs' weights in the compute dtype, channels-last,
        cast once per dtype and device."""
        key = (dtype, self.net.outc.conv.weight.device)
        if key not in self._float_cache:
            cl = torch.channels_last
            ws = {"inc": self.net.inc.double_conv[0].weight.detach().to(dtype).contiguous(memory_format=cl),
                  "outc": self.net.outc.conv.weight.detach().to(dtype).contiguous(memory_format=cl),
                  "outc_b": self.net.outc.conv.bias.detach().to(dtype).view(1, -1, 1, 1)}
            for j, up in enumerate(self.net.up):
                ws[f"up_{j}"] = up.up.weight.detach().to(dtype).contiguous(memory_format=cl)
                ws[f"up_{j}_b"] = up.up.bias.detach().to(dtype).view(1, -1, 1, 1)
            self._float_cache = {key: ws}
        return self._float_cache[key]

    def _int8(self, site: str, qx: torch.Tensor, dtype: torch.dtype, consumers=(), *, qx2=None, offset=(0, 0),
              halo=None):
        """One quantized conv of a DoubleConv, its BN and activation fused.
        With ``consumers``, it stores its output int8 at each consumer
        site's activation scale (the buffers ``set_act_scales`` overwrites
        in place) and returns those; else the output in ``dtype``. With
        halo, qx (and qx2) gain their neighbours' edge rows (int8 zeros at
        the image's edges, the conv's own padding: quantization is
        symmetric), and the two output rows that pad=1 adds are dropped."""
        block, conv = site.split("/")
        dc = _double_conv(self.net, block)
        i = int(conv[-1]) - 1
        if halo is not None:
            qx = halo(qx, 1)
            qx2 = None if qx2 is None else halo(qx2, 1)
        epilogue = Epilogue(
            bn_mul=getattr(dc, f"bn{i}_scale").view(-1), bn_add=getattr(dc, f"bn{i}_shift").view(-1),
            act=self.cfg.activation, out_dtype=dtype,
            q_scales=tuple(self.act_scale(c) for c in consumers), store_float=not consumers,
        )
        with span("unet.conv", conv):
            out = conv2d_int8(qx, self.w8(site), pad=1, scale=self._escale(site), qx2=qx2, offset=offset,
                              epilogue=epilogue)
        if halo is None:
            return out
        crop = lambda t: t[:, 1:-1].contiguous()  # noqa: E731
        return tuple(crop(t) for t in out) if consumers else crop(out)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16, halo=None) -> torch.Tensor:
        """NCHW float input -> NCHW float32 logits, the int8 eval forward
        (of this rank's band of rows, with halo: see the module's docstring).

        Every int8 conv stores what its consumers read: int8 at the next
        conv's scale, and at the skip's consumer ``up_j/conv1``'s scale as
        well where a skip leaves the encoder (``inc/conv2``, ``down_i/conv2``);
        the compute dtype only where a float op reads it (a float upconv,
        the head). The max-pools run on the int8 pre-pool tensors, which is
        exact because quantization is monotone, and ``up_j/conv1`` reads the
        skip and the upconv output in place of their padded concat. So the
        int8 tensors are those of the JAX package's order of operations
        (quantize at production), bit for bit."""
        dtype = compute_dtype
        cfg, L = self.cfg, self.cfg.num_levels
        ws = self._float_weights(dtype)
        up8 = self.has_int8_upconvs

        def nchw(h):
            return h.permute(0, 3, 1, 2)

        with full_precision(dtype):
            def to_upconv(site, q, j):  # the site's output as up_j's upconv reads it
                if up8:
                    return self._int8(site, q, dtype, (f"up_{j}/upconv",), halo=halo)[0]
                return self._int8(site, q, dtype, halo=halo)

            # level l's block (inc, then down_0 ...) stores its skip at its
            # consumer up_{L-2-l}/conv1's scale and its pre-pool output at
            # down_l/conv1's, which down_l pools; the bottom block feeds
            # up_0's upconv
            skips = []
            for level, block in enumerate(["inc"] + [f"down_{i}" for i in range(L - 1)]):
                with span("unet.block", block):
                    if level == 0:
                        inc = self.net.inc
                        act = inc.double_conv[2]
                        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
                        if halo is not None:
                            x = halo(x, 2)
                        with span("unet.conv", "conv1"):
                            y = F.conv2d(x, ws["inc"], padding=1 if halo is None else (0, 1))
                        with span("unet.epilogue", "conv1"):
                            q = conv_epilogue(y, bn_mul=inc.bn0_scale, bn_add=inc.bn0_shift, act=act.name,
                                              q_scale=self.act_scale("inc/conv2"))
                    else:
                        q = max_pool_int8(pre, cfg.maxpool_size)
                        (q,) = self._int8(f"{block}/conv1", q, dtype, (f"{block}/conv2",), halo=halo)
                    if level < L - 1:
                        skip, pre = self._int8(f"{block}/conv2", q, dtype,
                                               (f"up_{L - 2 - level}/conv1", f"down_{level}/conv1"), halo=halo)
                        skips.append(skip)
                    else:
                        h = to_upconv(f"{block}/conv2", q, 0)

            for j in range(L - 1):
                name, skip = f"up_{j}", skips[L - 2 - j]
                with span("unet.block", name):
                    if up8:
                        epilogue = Epilogue(bias=self.get_buffer(_buffer_name("bias", name)), out_dtype=dtype,
                                            shuffle=self._up(name).stride,
                                            q_scales=(self.act_scale(f"{name}/conv1"),), store_float=False)
                        with span("unet.conv", "upconv"):
                            (yq,) = conv2d_int8(h, self.w8(f"{name}/upconv"), pad=0,
                                                scale=self._escale(f"{name}/upconv"), epilogue=epilogue)
                    else:
                        h = nchw(h).to(dtype)
                        with span("unet.conv", "upconv"):
                            y = F.conv_transpose2d(h, ws[name], stride=self._up(name).stride)
                        with span("unet.epilogue", "upconv"):
                            yq = conv_epilogue(y, bias=ws[f"{name}_b"], q_scale=self.act_scale(f"{name}/conv1"))
                    dy, dx = skip.shape[1] - yq.shape[1], skip.shape[2] - yq.shape[2]
                    (q,) = self._int8(f"{name}/conv1", skip, dtype, (f"{name}/conv2",), qx2=yq,
                                      offset=(dy // 2, dx // 2), halo=halo)
                    if j == L - 2:
                        h = self._int8(f"{name}/conv2", q, dtype, halo=halo)
                    else:
                        h = to_upconv(f"{name}/conv2", q, j + 1)

            with span("unet.block", "outc"):
                with span("unet.conv", "conv"):
                    out = F.conv2d(nchw(h), ws["outc"])
                out = out + ws["outc_b"]
                return out.float().contiguous()


def max_pool_int8(q: torch.Tensor, p: int) -> torch.Tensor:
    """Floor-mode p x p max-pool with stride p of an int8 NHWC tensor: equal
    to quantizing the float max-pool, since quantization is monotone."""
    n, h, w, c = q.shape
    ho, wo = h // p, w // p
    return q[:, : ho * p, : wo * p].reshape(n, ho, p, wo, p, c).amax(dim=(2, 4))


def unet_apply_int8(q: QuantizedUNet, x: torch.Tensor, *, channels_last: bool = False,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Eval forward with the quantized weights: NCHW in, NCHW float32
    logits out, as ``UNet.forward``; NHWC in and out with channels_last."""
    y = q(_nchw(x, channels_last), compute_dtype)
    return y.permute(0, 2, 3, 1) if channels_last else y


@torch.no_grad()
def measure_float_delta(q: QuantizedUNet, x: torch.Tensor) -> float:
    """Output RMSE of the int8 forward at the default bfloat16 compute
    dtype against the float32 graph, as the JAX package measures it,
    whatever dtype the predictor serves in."""
    y_q = q(x, torch.bfloat16)
    y_f = q.net(x.float())
    return float(torch.sqrt(torch.mean(torch.square(y_q - y_f))))


def quantize_unet(
    net: UNet,
    calib_x: torch.Tensor,
    *,
    percentile: float = 100.0,
    quantize_upconvs: bool = False,
    channels_last: bool = False,
) -> QuantizedUNet:
    """Calibrate and quantize a float32 ``UNet``; ``float_delta`` reports
    the output RMSE against the float32 graph on the calibration batch
    (NHWC with channels_last). quantize_upconvs also runs the transposed
    convs on the int8 path, where their kernel equals their stride."""
    cfg = net.cfg
    calib_x = _nchw(calib_x, channels_last).contiguous()
    quantize_upconvs = quantize_upconvs and bool(_upconv_sites(cfg))
    act_scale = calibrate_act_scales(
        net, calib_x, percentile=percentile, quantize_upconvs=quantize_upconvs
    )
    w8, w_scale = {}, {}
    with torch.no_grad():
        for block, conv in _quantized_sites(cfg):
            w = _double_conv(net, block).double_conv[0 if conv == "conv1" else 3].weight
            w8[f"{block}/{conv}"], w_scale[f"{block}/{conv}"] = quantize_weight(w)
        if quantize_upconvs:
            for block in _upconv_sites(cfg):
                up = net.up[int(block.split("_")[1])]
                w8[f"{block}/upconv"], w_scale[f"{block}/upconv"] = quantize_upconv_weight(up.up.weight)
    q = QuantizedUNet(net, w8, w_scale, act_scale)
    q.float_delta.fill_(measure_float_delta(q, calib_x))
    return q
