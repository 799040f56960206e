"""What the benchmark makes from ``--seed`` and hands to the program and
to the reference alike: synthetic tactile frames and random weights, drawn
on the device from ``torch.Generator``s in a few large calls.

The frames follow the arithmetic of the synthetic GelSlim sensor model
(``make_synthetic_object`` of the package's ``data/synthetic.py``): an
undeformed base frame, a per-channel level U(80, 170) plus spatial jitter
U(-8, 8); two Gaussian indentations a finger, centres U(0.2, 0.8) of the
frame, widths U(8, 30) px, depths U(0.3, 1) x 1.9 mm, clipped at 1.9 mm;
the response +35, -20, +15 a mm of indentation on R, G, B; noise N(0, 2);
clipped to [0, 255].
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference import unet as ref_unet

# the independent streams of a seed (``generator``)
WEIGHTS, FRAMES = range(2)

MAX_DEPTH_MM = 1.9
RESPONSE = (35.0, -20.0, 15.0)
BLOBS = 2
FRAME_CHUNK = 32  # frames a pass over the blob maps


def generator(device, seed: int, stream: int) -> torch.Generator:
    """The generator of one named stream of a seed: the streams of a seed
    are independent, and the same seed and stream give the same draws."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % 2 ** 63)


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def session(g: torch.Generator, n: int, frame: Tuple[int, int], device) -> Tuple[torch.Tensor, ...]:
    """n dual frames of one sensor: ((n, 6, H, W) frames, the (6, H, W)
    base frame, the (n, 2, H, W) depth in mm, <= 0)."""
    h, w = frame
    base = _uniform(g, (6, 1, 1), 80.0, 170.0, device) + _uniform(g, (6, h, w), -8.0, 8.0, device)
    p = torch.rand((n, 2, BLOBS, 5), generator=g, device=device)
    cy, cx = (p[..., 0] * 0.6 + 0.2) * h, (p[..., 1] * 0.6 + 0.2) * w
    sy, sx = p[..., 2] * 22.0 + 8.0, p[..., 3] * 22.0 + 8.0
    amp = (p[..., 4] * 0.7 + 0.3) * MAX_DEPTH_MM
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, 1, 1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, 1, 1, w)
    frames = torch.empty((n, 6, h, w), device=device)
    depth = torch.empty((n, 2, h, w), device=device)
    resp = torch.tensor(RESPONSE, device=device).view(1, 1, 3, 1, 1)
    for s in range(0, n, FRAME_CHUNK):
        e = min(n, s + FRAME_CHUNK)

        def v(t):
            return t[s:e, :, :, None, None]

        blobs = v(amp) * torch.exp(-(((yy - v(cy)) / v(sy)) ** 2 + ((xx - v(cx)) / v(sx)) ** 2))
        d = torch.clamp(-blobs.sum(dim=2), min=-MAX_DEPTH_MM)
        depth[s:e] = d
        t = base.view(1, 2, 3, h, w) + resp * (-d).unsqueeze(2)
        t = t + torch.randn(t.shape, generator=g, device=device) * 2.0
        frames[s:e] = torch.clamp(t, 0.0, 255.0).reshape(e - s, 6, h, w)
    return frames, base, depth


def _split(flat: torch.Tensor, shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for k, shape in shapes.items():
        n = 1
        for d in shape:
            n *= d
        out[k] = flat[i:i + n].view(shape)
        i += n
    return out


def _fan_in(key: str, shape) -> int:
    if ".up." in key and key.startswith("up."):  # transposed conv (in, out, kh, kw): one tap an input
        return shape[0]
    return shape[1] * shape[2] * shape[3]


def contact_path(cfg: dict, sd: Dict[str, torch.Tensor], gain: float) -> None:
    """Make channel 0 of the network's top level carry the contact to the
    depth, in place: the first conv takes ``gain`` x the R channel of the
    difference image at its centre tap and its BatchNorm subtracts the
    level of no contact (0.5), so that after the activation the channel
    holds gain x (R - 0.5), which contact raises; the first block's second
    conv, and both convs of the last up block (whose input starts with
    that skip), pass channel 0 on at the centre tap with identity
    BatchNorm; the head reads it so that it adds the indentation's own
    depth in mm. The other channels keep their random weights, so the
    depth is the contact's plus what the random network makes of the
    frame."""
    top = f"up.{len(ref_unet.dims_of(cfg)) - 2}.conv.double_conv"
    for prefix, conv, bn, tap in (("inc.double_conv", 0, 1, gain), ("inc.double_conv", 3, 4, 1.0),
                                  (top, 0, 1, 1.0), (top, 3, 4, 1.0)):
        w = sd[f"{prefix}.{conv}.weight"]
        c = w.shape[-1] // 2
        w[0] = 0.0
        w[0, 0, c, c] = tap
        for leaf, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
            sd[f"{prefix}.{bn}.{leaf}"][0] = v
    sd["inc.double_conv.1.running_mean"][0] = 0.5 * gain
    lo, hi = cfg["depth_normalization_parameters"]
    mm_per_unit = (hi - lo) / cfg["norm_scale"]  # the head's output -> depth in mm (negated)
    sd["outc.conv.weight"][0, 0] = 1.0 / (gain * RESPONSE[0] / 510.0 * mm_per_unit)


def serving_weights(cfg: dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A served model's state dict: He-normal conv and upconv kernels (so
    activations keep their scale through the depth), the head at 0.3 /
    sqrt(fan_in) (a normalized-depth spread of about 0.3), biases
    U(-0.1, 0.1); BatchNorm scale and running variance U(0.8, 1.2), shift
    and running mean U(-0.1, 0.1). Where the configuration gives a
    ``contact_path_gain``, channel 0 of the top level then carries the
    contact to the depth (``contact_path``)."""
    shapes = ref_unet.state_shapes(cfg)
    kernels = {k: s for k, s in shapes.items() if len(s) == 4}
    vectors = {k: s for k, s in shapes.items() if len(s) == 1}
    sd = _split(torch.randn(sum(torch.Size(s).numel() for s in kernels.values()), generator=g, device=device),
                kernels)
    for k, s in kernels.items():
        gain = 0.3 if k.startswith("outc.") else 2.0 ** 0.5
        sd[k] = sd[k] * (gain / _fan_in(k, s) ** 0.5)
    vec = _split(torch.rand(sum(s[0] for s in vectors.values()), generator=g, device=device), vectors)
    for k, v in vec.items():
        if k.endswith(("running_var", ".1.weight", ".4.weight")):
            sd[k] = v * 0.4 + 0.8
        else:
            sd[k] = v * 0.2 - 0.1
    if cfg.get("contact_path_gain"):
        contact_path(cfg, sd, float(cfg["contact_path_gain"]))
    return sd
