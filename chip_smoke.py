#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in the
checkout (one nvcc each, all at once), holds each against its plain
PyTorch twin on the card, drives the main paths and checks what comes out:
flagship dual-frame serving through ``Predictor`` (seeded random weights),
then int8 serving through ``Predictor.quantize`` -> ``QuantizedPredictor``.
Then it times the kernels and the U-Nets by their device time in a
torch.profiler trace, and whole calls by the host clock. Prints the card, a
``{"kernels": [...]}`` line, an end-to-end line and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero; with no
CUDA device it exits non-zero before any result. Imports nothing of JAX or
of the JAX package.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import contextlib

import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch import GelslimConfig, Predictor
from gelslim_depth_tpu_torch.inference import fused_predict_dual
from gelslim_depth_tpu_torch.models import UNet
from gelslim_depth_tpu_torch.models import quantize as quantize_module
from gelslim_depth_tpu_torch.ops.kernels import (
    Epilogue,
    build,
    conv2d_int8,
    conv2d_int8_reference,
    conv_int8,
    fused_preprocess_dual,
    fused_preprocess_dual_reference,
)
from gelslim_depth_tpu_torch.utils.profiling import busy_us, device_events, device_ms

FRAME = (320, 427)
NET_IN = (160, 213)
KERNEL_SOURCE = "gelslim_depth_tpu_torch/csrc/fused_preprocess_dual.cu"
KERNEL_REPLACES = "gelslim_depth_tpu/ops/pallas/preprocess_kernel.py:41"
CONV_SOURCE = "gelslim_depth_tpu_torch/csrc/conv2d_int8.cu"
CONV_REPLACES = "gelslim_depth_tpu/models/quantize.py:164"
CONV_FAST_PATH = conv_int8.PATHS[-1]  # the mainloop every flagship launch must take
MULT = [1 / 255.0] * 3  # 0_255_to_0_1
ADD = [0.0] * 3

# data-sheet peaks: device memory bytes/s, float32 (non-tensor-core) FLOP/s
# and dense int8 tensor-core OP/s
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 1513e12),
    ("H100 NVL", 3.9e12, 60e12, 1671e12),
    ("H200", 4.8e12, 67e12, 1979e12),
    ("H100", 3.35e12, 67e12, 1979e12),  # SXM
)


# substrings of device op names -> the layer they belong to, for the
# trace's breakdown; any other op is counted under LIBRARY_OPS
LIBRARY_OPS = "library kernels (cuDNN convs, cuBLAS)"
DEVICE_OP_KEYS = {
    "conv2d_int8": ("conv2d_int8",),
    "fused_preprocess_dual": ("fused_preprocess_dual",),
    "cudnn layout transposes": ("nchwToNhwc", "nhwcToNchw"),
    "aten ops (BN, activation, casts, bias, pad, cat, pool)": ("at::native",),
    "memcpy/memset": ("Memcpy", "Memset"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(bytes/s, float32 FLOP/s, int8 OP/s) of the card."""
    for key, *peaks in CARD_PEAKS:
        if key in name:
            return peaks
    fail(f"no data-sheet peaks for {name!r}")


def flagship_config() -> GelslimConfig:
    """The flagship serving config (unet_bigdata shapes)."""
    return GelslimConfig(
        CNN_dimensions=(64, 128, 256, 512, 1024),
        input_tactile_image_size=NET_IN,
        image_normalization_method="0_255_to_0_1",
        depth_normalization_method="min_max_to_0_-1",
        depth_normalization_parameters=(-1.9180814027786255, 0.0),
        norm_scale=0.9,
        use_difference_image=True,
    )


def flagship_launches(n_img: int, int8_upconvs: bool = False):
    """The flagship's 17 quantized conv launches at n_img finger images,
    with their serving epilogues (models/quantize.py::serving_launches)."""
    cfg = flagship_config()
    return quantize_module.serving_launches(cfg.unet_config(), n_img, cfg.input_tactile_image_size, int8_upconvs)


def seeded_state_dict(cfg, seed: int):
    """Random reference-layout weights from a seed: He-normal convs (so
    activations keep their scale through the depth), identity BatchNorm
    statistics, and a head scaled to a normalized-depth spread of ~0.3."""
    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in UNet(cfg).state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    sd = {}
    for k, shape in shapes.items():
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            std = (0.3 if k.startswith("outc.") else 2.0 ** 0.5) / fan_in ** 0.5
            sd[k] = torch.randn(shape, generator=g) * std
        elif k.endswith("running_var") or (k.endswith(".weight") and len(shape) == 1):
            sd[k] = torch.ones(shape)
        else:
            sd[k] = torch.zeros(shape)
    return sd


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host time of one call that ends in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def window_terms(n_in: int, n_out: int) -> int:
    """Input terms summed over all output pixels of one axis."""
    return sum(-((-(i + 1) * n_in) // n_out) - (i * n_in) // n_out for i in range(n_out))


def preprocess_bound_ms(n, h_in, w_in, h_out, w_out, bw, f32_peak):
    """(ms, 'bytes'|'operations'): the larger of the byte and FLOP bounds."""
    nbytes = 4 * (n * 6 * h_in * w_in + 6 * h_in * w_in + 2 * n * 3 * h_out * w_out)
    # per frame-channel: diff (3 ops) + vertical FMA (2) per input pixel read,
    # horizontal FMAs over each output row's column windows, then the
    # normalize FMA per output pixel
    rows_read = window_terms(h_in, h_out)
    flops = n * 6 * (5 * rows_read * w_in + 2 * h_out * window_terms(w_in, w_out) + 2 * h_out * w_out)
    t_bytes, t_ops = 1e3 * nbytes / bw, 1e3 * flops / f32_peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand(shape, g):
    return torch.rand(shape, generator=g, device="cuda") * 255.0


def device_profile(fn, calls: int = 10):
    """A torch.profiler trace of `calls` calls, each ending in a synchronize
    as a serving loop's does. Returns (device busy ms per call, device idle
    share, device ops per call, {category: share of device op time},
    {category: device ms per call}), or None when the trace holds no device
    events. The idle share is the part of the span from the first device
    op's start to the last one's end in which no device op runs."""
    events = device_events(fn, calls, sync_each=True)
    if not events:
        return None
    busy = busy_us(events)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    per_category = dict.fromkeys((*DEVICE_OP_KEYS, LIBRARY_OPS), 0.0)
    for e in events:
        cat = next((c for c, keys in DEVICE_OP_KEYS.items() if any(k in e.name for k in keys)), LIBRARY_OPS)
        per_category[cat] += e.time_range.elapsed_us()
    total = sum(per_category.values())
    shares = {c: v / total for c, v in per_category.items()}
    ms = {c: v / calls / 1e3 for c, v in per_category.items()}
    return busy / calls / 1e3, 1.0 - busy / span, len(events) / calls, shares, ms


def check_kernel(g):
    """Kernel vs plain twin on the same inputs; returns the largest |diff|
    at the flagship shape."""
    flagship_err = 0.0
    nonuniform = ([0.01, 0.02, 0.03], [-1.0, 0.5, 2.0])
    ragged = (33, 47)  # a plane of 6,204 B: spans start and end off 16 B
    cases = [
        # (n, (H, W), (h, w), use_diff, (mult, add), flagship, views offset by one plane)
        (1, FRAME, NET_IN, True, (MULT, ADD), True, False),
        (2, FRAME, NET_IN, True, (MULT, ADD), True, False),
        (2, FRAME, NET_IN, False, (MULT, ADD), True, False),
        (8, FRAME, NET_IN, True, (MULT, ADD), True, False),
        (8, FRAME, NET_IN, False, (MULT, ADD), True, False),
        (64, FRAME, NET_IN, True, (MULT, ADD), True, False),
        (64, FRAME, NET_IN, False, (MULT, ADD), True, False),
        (2, FRAME, NET_IN, True, nonuniform, True, False),
        (2, FRAME, NET_IN, False, nonuniform, True, False),
        (5, FRAME, NET_IN, True, (MULT, ADD), True, False),  # N that no frame chunk divides
        (13, FRAME, NET_IN, True, nonuniform, True, False),
        (3, (64, 86), (32, 43), True, (MULT, ADD), False, False),
        (3, (64, 86), (32, 43), False, (MULT, ADD), False, False),
        (3, (64, 86), (16, 21), True, nonuniform, False, False),  # windows of 4-5: loops of any extent
        (2, NET_IN, FRAME, True, (MULT, ADD), False, False),  # upsampling: windows of 1-2
        (2, (321, 427), NET_IN, True, (MULT, ADD), False, False),  # row windows overlap tiles
        (3, ragged, (16, 23), True, (MULT, ADD), False, False),
        (3, ragged, (16, 23), False, (MULT, ADD), False, False),
        (3, ragged, (16, 23), True, (MULT, ADD), False, True),  # frames[1:], base[1:]
        (3, ragged, (16, 23), False, nonuniform, False, True),
    ]
    for n, (h_in, w_in), out_size, use_diff, (mult, add), flagship, view in cases:
        k = int(view)
        frames, base = rand((n + k, 6, h_in, w_in), g)[k:], rand((6 + k, h_in, w_in), g)[k:]
        check(not view or bool(frames.data_ptr() % 16 and base.data_ptr() % 16),
              "an offset view starts on 16 B, so it tests no misaligned span")
        got = fused_preprocess_dual(frames, base, mult, add, out_size=out_size, use_diff=use_diff)
        want = fused_preprocess_dual_reference(frames, base, mult, add, out_size=out_size, use_diff=use_diff)
        torch.cuda.synchronize()
        check(got.shape == (2 * n, 3, *out_size), f"kernel output shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        tag = f"n={n} {h_in}x{w_in}->{out_size} use_diff={use_diff} mult={mult[0]:.4g} view={view}"
        print(f"kernel vs plain: {tag}: max|diff| {err:.3e}", flush=True)
        if mult is MULT:
            check(err < 1e-5, f"kernel disagrees with plain ({tag}): {err}")
        else:
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5), f"kernel disagrees with plain ({tag}): {err}")
        if flagship:
            flagship_err = max(flagship_err, err)
    return flagship_err


def conv_bound_ms(launch, out_bytes, bw, int8_peak):
    """(ms for the bytes, ms for the operations) of one stride-1 kxk
    conv2d_int8 launch: its int8 inputs (both sources) and weights read
    once, its outputs written once (n_q int8 ones, and the float one of
    out_bytes an element where it stores one) and the three float32 epilogue
    vectors; 2 operations a multiply-add."""
    n, h, w, cin = launch.x_shape
    x2 = launch.x2_shape
    cin += x2[3] if x2 else 0
    m, kk, cout = n * h * w, launch.k * launch.k * cin, launch.cout
    out = launch.n_q + (out_bytes if launch.store_float else 0)
    nbytes = n * h * w * launch.x_shape[3] + (x2[0] * x2[1] * x2[2] * x2[3] if x2 else 0) + cout * kk + m * cout * out + 3 * 4 * cout
    return 1e3 * nbytes / bw, 1e3 * 2 * m * kk * cout / int8_peak


def conv_inputs(g, launch, act="relu", dtype=torch.bfloat16, shuffle=1):
    """Random int8 inputs (both sources) and weights, scales of a calibrated
    site, and the epilogue of a DoubleConv site (BN + activation) or, with
    shuffle > 1, of the row-split upconv (bias, depth-to-space store), with
    the launch's int8 outputs. Returns (qx, w, scale, epilogue, sources)
    with sources the qx2 and offset keywords."""
    cout = launch.cout

    def vec(lo, hi):
        return torch.rand(cout, generator=g, device="cuda") * (hi - lo) + lo

    def ints(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    qx = ints(launch.x_shape)
    qx2 = ints(launch.x2_shape) if launch.x2_shape else None
    cin = launch.x_shape[3] + (launch.x2_shape[3] if qx2 is not None else 0)
    w = ints((cout, launch.k, launch.k, cin))
    # the next site's scales: the int8 outputs land across their whole range
    q_scales = tuple(torch.full((1,), v, device="cuda") for v in (0.05, 0.11)[:launch.n_q])
    q = dict(q_scales=q_scales, store_float=launch.store_float)
    if shuffle > 1:
        ep = Epilogue(bias=vec(-1, 1), act=act, out_dtype=dtype, shuffle=shuffle, **q)
    else:
        ep = Epilogue(bn_mul=vec(0.5, 1.5), bn_add=vec(-0.5, 0.5), act=act, out_dtype=dtype, **q)
    return qx, w, vec(1e-5, 1e-4), ep, dict(qx2=qx2, offset=launch.offset)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check_conv_int8(g):
    """conv2d_int8 vs its plain twin on the same inputs. The int32 sums
    (stored as float32 with scale 1: exact, |acc| < 2^24 at these sizes)
    and every output of the relu or bare epilogue must agree bit for bit;
    tanh and mish within 1e-6 (float32) or one bfloat16 ulp (libm against
    PyTorch), and their int8 outputs within one step. Every flagship launch
    must take the CONV_FAST_PATH mainloop. Returns the largest |diff| of
    the epilogue outputs over every case."""
    L = quantize_module.SiteLaunch
    # (launch, pad, act, dtype, shuffle, the flagship's): every flagship launch
    # at N=1 with its serving epilogue, two at N=8, then the shapes and
    # epilogues the flagship does not reach
    cases = [(launch, 1, "relu", torch.bfloat16, 1, True) for launch in flagship_launches(1)] + [
        (launch, 1, "relu", torch.float32, 1, True) for launch in flagship_launches(16)[3:5]] + [
        (L("up_0/upconv", (1, 10, 13, 1024), None, (0, 0), 4 * 512, 1, 1, False), 0, "none", torch.bfloat16, 2, True),
        (L("up_3/upconv", (1, 80, 106, 128), None, (0, 0), 4 * 64, 1, 1, False), 0, "none", torch.bfloat16, 2, True),
        (L("", (1, 80, 106, 128), None, (0, 0), 4 * 64, 1, 0, True), 0, "none", torch.bfloat16, 2, False),
        (L("", (2, 17, 23, 64), (2, 16, 21, 64), (1, 1), 96, 3, 2, True), 1, "relu", torch.float32, 1, False),
        (L("", (2, 17, 23, 128), (2, 15, 23, 64), (1, 0), 72, 3, 1, False), 1, "relu", torch.bfloat16, 1, False),
        (L("", (2, 17, 23, 4), None, (0, 0), 8, 3, 0, True), 1, "relu", torch.float32, 1, False),
        (L("", (2, 17, 23, 8), None, (0, 0), 16, 3, 2, True), 1, "relu", torch.float32, 1, False),
        (L("", (2, 17, 23, 24), None, (0, 0), 40, 3, 1, True), 1, "relu", torch.bfloat16, 1, False),
        (L("", (2, 17, 23, 24), (2, 17, 22, 8), (0, 1), 40, 3, 2, False), 1, "relu", torch.bfloat16, 1, False),
        (L("", (2, 17, 23, 16), None, (0, 0), 24, 5, 1, True), 1, "relu", torch.float32, 1, False),  # k=5, pad 1
        (L("", (2, 9, 11, 24), None, (0, 0), 4 * 6, 1, 1, True), 0, "none", torch.float32, 2, False),
        (L("", (2, 17, 23, 32), None, (0, 0), 70, 3, 0, True), 1, "tanh", torch.float32, 1, False),
        (L("", (2, 17, 23, 64), None, (0, 0), 64, 3, 2, True), 1, "mish", torch.float32, 1, False),
        (L("", (2, 17, 23, 32), None, (0, 0), 64, 3, 1, True), 1, "mish", torch.bfloat16, 1, False),
    ]
    worst = 0.0
    for launch, pad, act, dtype, shuffle, flagship in cases:
        qx, w, scale, ep, src = conv_inputs(g, launch, act, dtype, shuffle)
        before = dict(conv2d_int8.launches_by_path)
        got = as_tuple(conv2d_int8(qx, w, pad=pad, scale=scale, epilogue=ep, **src))
        path = next(k for k, v in conv2d_int8.launches_by_path.items() if v != before[k])
        want = as_tuple(conv2d_int8_reference(qx, w, pad=pad, scale=scale, epilogue=ep, **src))
        ones, bare = torch.ones(launch.cout, device="cuda"), Epilogue(shuffle=shuffle)
        acc = conv2d_int8(qx, w, pad=pad, scale=ones, epilogue=bare, **src)
        acc_want = conv2d_int8_reference(qx, w, pad=pad, scale=ones, epilogue=bare, **src)
        torch.cuda.synchronize()
        tag = (f"{launch.site or 'extra'} {launch.x_shape}+{launch.x2_shape}@{launch.offset} -> {launch.cout}, "
               f"k={launch.k} pad={pad} {act} {str(dtype)[6:]} shuffle={shuffle} n_q={launch.n_q} "
               f"float={launch.store_float} path={path}")
        check(len(got) == len(want) and all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(got, want)),
              f"conv2d_int8 {tag}: outputs {[(tuple(a.shape), a.dtype) for a in got]}")
        acc_err = (acc - acc_want).abs().max().item()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
        print(f"conv2d_int8 vs plain: {tag}: int32 sums max|diff| {acc_err:.1f} "
              f"(max|acc| {acc_want.abs().max().item():.0f}), outputs max|diff| {errs}", flush=True)
        check(acc_err == 0 and acc_want.abs().max().item() < 2 ** 24, f"conv2d_int8 sums differ ({tag})")
        if flagship:
            check(path == CONV_FAST_PATH, f"conv2d_int8 {tag}: took the {path} mainloop, not {CONV_FAST_PATH}")
        for a, b, err in zip(got, want, errs):
            if act in ("relu", "none"):
                check(torch.equal(a, b), f"conv2d_int8 disagrees with plain ({tag}): {err}")
            elif a.dtype == torch.int8:
                check(err <= 1, f"conv2d_int8 int8 output disagrees with plain ({tag}): {err}")
            else:
                rtol = 0 if dtype == torch.float32 else 2.0 ** -8
                check(torch.allclose(a.float(), b.float(), rtol=rtol, atol=1e-6),
                      f"conv2d_int8 disagrees with plain ({tag}): {err}")
            if a.dtype != torch.int8:
                worst = max(worst, err)
    return worst


def cpu_reference_chain(sd, cfg, frames, base):
    """The reference's chain for one dual frame on the CPU, in float32,
    composed from the independent test fixture (F.interpolate(area), a
    functional U-Net over the state dict)."""
    # by path: another installed package may own the name `tests`
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixture.py")
    spec = importlib.util.spec_from_file_location("torch_fixture", path)
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)

    n = frames.shape[0]
    fingers = ((frames.reshape(n, 2, 3, *FRAME) - base.reshape(1, 2, 3, *FRAME)) + 255.0) / 2.0
    x = F.interpolate(fingers.reshape(2 * n, 3, *FRAME), size=NET_IN, mode="area") / 255.0
    y = fixture.torch_unet_forward({k: v.numpy() for k, v in sd.items()}, x.numpy(), cfg.CNN_dimensions)
    mn, mx = cfg.depth_normalization_parameters
    y = torch.from_numpy(y) * (mx - mn) / (-cfg.norm_scale) + mn
    return F.interpolate(y, size=FRAME, mode="area").reshape(n, 2, *FRAME)


def drive_main_path(cfg, sd, frames64, base):
    """The flagship Predictor, with torch's default TF32 flags (the port
    turns TF32 off itself where it runs float32): float32 kernel vs composed
    route, bfloat16 vs float32, at N = 1, 8, 64. Returns the kernel's launch
    count over the run."""
    print(f"torch defaults: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"float32 matmul precision {torch.get_float32_matmul_precision()!r}", flush=True)
    pred16 = Predictor(cfg, sd, compute_dtype=torch.bfloat16)
    pred32 = Predictor(cfg, sd)

    @torch.inference_mode()
    def composed_route(frames):
        return fused_predict_dual(cfg, pred32.net, frames, base, FRAME, use_kernel=False)

    fused_preprocess_dual.launches = 0
    for n in (1, 8, 64):
        frames = frames64[:n]
        outs = {}
        for name, run, launched in (
            ("bf16", lambda: pred16.predict_dual_frames(frames, base, FRAME), 1),
            ("f32", lambda: pred32.predict_dual_frames(frames, base, FRAME), 1),
            ("f32_plain", lambda: composed_route(frames), 0),
        ):
            before = fused_preprocess_dual.launches
            outs[name] = run()
            check(fused_preprocess_dual.launches == before + launched,
                  f"{name} N={n}: kernel launches rose by {fused_preprocess_dual.launches - before}")
        torch.cuda.synchronize()
        for name, out in outs.items():
            check(tuple(out.shape) == (n, 2, *FRAME), f"{name} N={n}: shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"{name} N={n}: non-finite depth")
        route_err = (outs["f32"] - outs["f32_plain"]).abs().max().item()
        rmse16 = (outs["bf16"] - outs["f32"]).pow(2).mean().sqrt().item()
        print(f"main path N={n}: f32 kernel vs composed max|diff| {route_err:.3e} mm, "
              f"bf16 vs f32 RMSE {rmse16:.3e} mm, depth range "
              f"[{outs['f32'].min().item():.3f}, {outs['f32'].max().item():.3f}] mm", flush=True)
        check(route_err < 1e-4, f"N={n}: f32 kernel route differs from composed route by {route_err} mm")
        check(rmse16 < 0.05, f"N={n}: bf16 vs f32 RMSE {rmse16} mm")
    launches = fused_preprocess_dual.launches
    check(launches > 0, "the main path launched no fused_preprocess_dual")

    # the whole path against the independent CPU reference, one dual frame
    got = pred32.predict_dual_frames(frames64[:1], base, FRAME).cpu()
    want = cpu_reference_chain(sd, cfg, frames64[:1].cpu(), base.cpu())
    rmse = (got - want).pow(2).mean().sqrt().item()
    print(f"f32 path vs CPU reference chain: RMSE {rmse:.3e} mm, "
          f"max|diff| {(got - want).abs().max().item():.3e} mm", flush=True)
    check(rmse < 0.05 and torch.allclose(got, want, rtol=1e-3, atol=1e-3),
          f"f32 path disagrees with the CPU reference chain: RMSE {rmse} mm")
    return launches, pred16


@contextlib.contextmanager
def plain_int8_convs():
    """Every quantized conv of the int8 U-Net as the kernel's plain twin,
    for holding the int8 route against the same model on plain ops. Fails
    if the kernel launched inside: the comparison then held the kernel
    against itself."""
    kernel = quantize_module.conv2d_int8
    quantize_module.conv2d_int8 = conv2d_int8_reference
    before = conv2d_int8.launches
    try:
        yield
    finally:
        quantize_module.conv2d_int8 = kernel
    check(conv2d_int8.launches == before,
          f"the plain-twin route launched conv2d_int8 {conv2d_int8.launches - before} times")


def drive_int8_path(pred16, frames64, base):
    """Int8 serving: the bf16 flagship Predictor quantized on 4 dual frames,
    served at N = 1, 8, 64, and once at N=8 with int8 upconvs. Each call
    must launch fused_preprocess_dual once and conv2d_int8 once per
    quantized site (17), plus one per int8 upconv (4: each upconv's k x k
    matmuls are one 1x1 launch with a depth-to-space store), every one on
    the CONV_FAST_PATH mainloop. Holds the depth to the bf16 float graph's
    within the parity gate, and the kernel route to the same model through
    the plain twins bit for bit. Returns the launch counts over the run,
    quantization included, and the predictor."""
    sizes = (1, 8, 64)
    with torch.inference_mode():
        ref = {n: pred16.predict_dual_frames(frames64[:n], base, FRAME) for n in sizes}
    fused_preprocess_dual.launches = 0
    conv2d_int8.launches = 0
    conv2d_int8.launches_by_path = dict.fromkeys(conv_int8.PATHS, 0)
    qpred = pred16.quantize(frames64[:4], base)
    sites = len(quantize_module._quantized_sites(qpred.q.cfg))
    check(sites == 17, f"{sites} quantized sites on the flagship")
    print(f"int8 quantize (bf16 flagship, 4 calibration dual frames): delta_mm {qpred.delta_mm:.4e}", flush=True)
    check(qpred.delta_mm < 0.05, f"int8 delta_mm {qpred.delta_mm} mm")
    outs = {}
    for n in sizes:
        before = fused_preprocess_dual.launches, conv2d_int8.launches, conv2d_int8.launches_by_path[CONV_FAST_PATH]
        outs[n] = qpred.predict_dual_frames(frames64[:n], base, FRAME)
        rose = (fused_preprocess_dual.launches - before[0], conv2d_int8.launches - before[1],
                conv2d_int8.launches_by_path[CONV_FAST_PATH] - before[2])
        check(rose == (1, sites, sites), f"int8 N={n}: launches rose by {rose}, want (1, {sites}, {sites} {CONV_FAST_PATH})")
    qpred_up = pred16.quantize(frames64[:4], base, quantize_upconvs=True)
    n_up = len(quantize_module._upconv_sites(qpred_up.q.cfg))
    before = conv2d_int8.launches, conv2d_int8.launches_by_path[CONV_FAST_PATH]
    out_up = qpred_up.predict_dual_frames(frames64[:8], base, FRAME)
    rose = conv2d_int8.launches - before[0], conv2d_int8.launches_by_path[CONV_FAST_PATH] - before[1]
    check(rose == (sites + n_up,) * 2 and sites + n_up == 21,
          f"int8 upconvs N=8: conv2d_int8 launches rose by {rose}, want 21 {CONV_FAST_PATH}")
    torch.cuda.synchronize()
    launches = {"fused_preprocess_dual": fused_preprocess_dual.launches, "conv2d_int8": conv2d_int8.launches,
                "conv2d_int8_by_path": dict(conv2d_int8.launches_by_path)}
    print(f"int8 main path launches: {launches}", flush=True)
    check(launches["conv2d_int8"] > 0, "the int8 path launched no conv2d_int8")
    check(launches["conv2d_int8_by_path"] == {**dict.fromkeys(conv_int8.PATHS, 0),
                                              CONV_FAST_PATH: launches["conv2d_int8"]},
          f"the int8 main path's conv2d_int8 launches by mainloop: {launches['conv2d_int8_by_path']}, "
          f"want all {launches['conv2d_int8']} on {CONV_FAST_PATH}")

    for n, out, base_out, tag in [(n, outs[n], ref[n], "int8") for n in sizes] + [(8, out_up, ref[8], "int8 upconvs")]:
        check(tuple(out.shape) == (n, 2, *FRAME), f"{tag} N={n}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{tag} N={n}: non-finite depth")
        rmse = (out - base_out).pow(2).mean().sqrt().item()
        print(f"{tag} N={n}: vs bf16 float RMSE {rmse:.3e} mm, depth range "
              f"[{out.min().item():.3f}, {out.max().item():.3f}] mm", flush=True)
        check(rmse < 0.05, f"{tag} N={n}: int8 vs bf16 float RMSE {rmse} mm")
    print(f"int8 upconvs: delta_mm {qpred_up.delta_mm:.4e}", flush=True)
    check(qpred_up.delta_mm < 0.05, f"int8 upconvs delta_mm {qpred_up.delta_mm} mm")

    # the same QuantizedUNets with every quantized conv on its plain twin
    with plain_int8_convs():
        plain = {n: qpred.predict_dual_frames(frames64[:n], base, FRAME) for n in (1, 8)}
        plain_up = qpred_up.predict_dual_frames(frames64[:8], base, FRAME)
    for tag, got, want in [("int8 N=1", outs[1], plain[1]), ("int8 N=8", outs[8], plain[8]),
                           ("int8 upconvs N=8", out_up, plain_up)]:
        rmse = (got - want).pow(2).mean().sqrt().item()
        print(f"{tag}: kernel route vs plain twins RMSE {rmse:.3e} mm, "
              f"max|diff| {(got - want).abs().max().item():.3e} mm", flush=True)
        check(torch.equal(got, want), f"{tag}: kernel route vs plain twins RMSE {rmse} mm, not 0")
    return launches, qpred


def im2col(qx, qx2, offset, k):
    """The int8 GEMM operand of a 3x3 'same' conv of [qx, qx2 placed]:
    (N*H*W, 9*C), tap-major as the weights are."""
    if qx2 is not None:
        qx = torch.cat([qx, conv_int8.place(qx2, qx.shape[1:3], offset)], dim=-1)
    n, h, wd, cin = qx.shape
    xp = F.pad(qx, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, dy:dy + h, dx:dx + wd] for dy in range(k) for dx in range(k)], dim=3)
    return cols.reshape(n * h * wd, k * k * cin)


def measure_conv_sites(peaks, g):
    """conv2d_int8 at all 17 flagship sites at N=64 dual frames (128 finger
    images), each with its serving epilogue, held bit for bit against its
    twin there: kernel, plain twin, the bound of what the launch reads and
    writes, and torch._int_mm on the same GEMM with the input already
    im2col'd (the int8 tensor-core yardstick; the port never calls it)."""
    bw, _, int8_peak = peaks
    out = {}
    for launch in flagship_launches(128):
        check(launch.k == 3, f"{launch.site}: the im2col yardstick assumes a 3x3 conv, got {launch.k}")
        qx, w, scale, ep, src = conv_inputs(g, launch)

        def kernel():
            return conv2d_int8(qx, w, pad=1, scale=scale, epilogue=ep, **src)

        def plain():
            return conv2d_int8_reference(qx, w, pad=1, scale=scale, epilogue=ep, **src)

        same = all(torch.equal(a, b) for a, b in zip(as_tuple(kernel()), as_tuple(plain())))
        check(same, f"conv2d_int8 disagrees with plain at {launch.site} N=64")
        kernel_ms = device_ms(kernel)
        plain_ms = device_ms(plain, calls=3)
        a = im2col(qx, src["qx2"], launch.offset, 3)
        b = w.reshape(launch.cout, -1).t()
        library_ms = device_ms(lambda: torch._int_mm(a, b))
        del a, qx, src
        t_bytes, t_ops = conv_bound_ms(launch, 2, bw, int8_peak)
        out[launch.site] = dict(x_shape=list(launch.x_shape), x2_shape=launch.x2_shape and list(launch.x2_shape),
                                cout=launch.cout, n_q=launch.n_q, store_float=launch.store_float, ms=kernel_ms,
                                plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                                bytes_ms=t_bytes, ops_ms=t_ops)
        print(f"conv2d_int8 {launch.site} N=64 {launch.x_shape}+{launch.x2_shape}->{launch.cout} n_q={launch.n_q} "
              f"float={launch.store_float}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"_int_mm {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
              f"(bytes {t_bytes:.4f}, operations {t_ops:.4f})", flush=True)
        torch.cuda.empty_cache()
    return out


def measure(pred16, qpred, frames64, base, peaks):
    """Kernel, plain, library and bound times of the preprocess kernel, each
    the device time of one call; bf16 and int8 end-to-end call times and
    traces, and the int8 path's conv2d_int8 time per call against its bound.
    At N=1 the 3.3 MB of inputs stay in the 50 MB L2 from call to call, so
    the N=1 kernel times are warm."""
    bw, f32_peak, int8_peak = peaks
    timings = {}
    for n in (1, 64):
        frames = frames64[:n]
        kernel = device_ms(lambda: fused_preprocess_dual(frames, base, MULT, ADD, out_size=NET_IN))
        plain = device_ms(lambda: fused_preprocess_dual_reference(frames, base, MULT, ADD, out_size=NET_IN))
        library = device_ms(lambda: F.adaptive_avg_pool2d(frames, NET_IN))
        bound, bound_by = preprocess_bound_ms(n, *FRAME, *NET_IN, bw, f32_peak)
        timings[n] = dict(ms=kernel, plain_ms=plain, library_ms=library, bound_ms=bound, bound_by=bound_by)
        print(f"fused_preprocess_dual N={n}: kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
              f"adaptive_avg_pool2d {library:.4f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)

    e2e = {}
    for n in (1, 64):
        frames = frames64[:n]
        x = fused_preprocess_dual(frames, base, MULT, ADD, out_size=NET_IN)
        for tag, pred, net in (("bf16", pred16, pred16.net),
                               ("int8", qpred, lambda x: qpred.q(x, torch.bfloat16))):
            with torch.inference_mode():
                unet = device_ms(lambda: net(x), calls=10)
            # five rounds of host_ms give the spread of the call time in this run
            rounds = sorted(host_ms(lambda: pred.predict_dual_frames(frames, base, FRAME)) for _ in range(5))
            call = rounds[2]
            rec = e2e[f"{tag}_N{n}"] = {
                "dual_frames_per_s": 1e3 * n / call,
                "call_ms": call,
                "call_ms_rounds": rounds,
                "front_end_kernel_ms": timings[n]["ms"],
                "unet_ms": unet,
            }
            print(f"{tag} predict_dual_frames N={n}: {call:.3f} ms/call (rounds {rounds[0]:.3f}..{rounds[-1]:.3f}), "
                  f"{1e3 * n / call:.1f} dual frames/s (U-Net {unet:.3f} ms)", flush=True)
            prof = device_profile(lambda: pred.predict_dual_frames(frames, base, FRAME))
            if prof is None:
                print(f"{tag} N={n}: the profiler trace holds no device events; idle share not measured", flush=True)
                rec["device_profile"] = None
                continue
            busy, idle, ops_per_call, shares, ms = prof
            rec["device_profile"] = {
                "busy_ms_per_call": busy, "idle_share": idle, "device_ops_per_call": ops_per_call,
                "device_time_shares": shares, "device_ms_per_call": ms}
            print(f"{tag} N={n} trace: device busy {busy:.3f} ms/call, idle share {idle:.3f}, "
                  f"{ops_per_call:.1f} device ops/call; device time: "
                  + "; ".join(f"{c} {v:.3f}" for c, v in shares.items()), flush=True)
            if tag == "int8":
                bounds = [conv_bound_ms(launch, 2, bw, int8_peak) for launch in flagship_launches(2 * n)]
                rec["conv2d_int8_ms_per_call"] = ms["conv2d_int8"]
                rec["conv2d_int8_bound_ms_per_call"] = sum(max(b) for b in bounds)
                rec["conv2d_int8_bound_ms_by"] = {"bytes": sum(b[0] for b in bounds), "operations": sum(b[1] for b in bounds)}
                print(f"int8 N={n}: conv2d_int8 {ms['conv2d_int8']:.3f} ms/call of device time against a summed "
                      f"bound of {rec['conv2d_int8_bound_ms_per_call']:.3f} ms over the 17 sites", flush=True)
    return timings, e2e


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)

    t0 = time.perf_counter()
    names = ("fused_preprocess_dual", "conv2d_int8")
    build.build_all(names)
    for name in names:
        build.load_library(name)
    print(f"built {', '.join(names)} in {time.perf_counter() - t0:.2f} s", flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = check_kernel(g)
    conv_err = check_conv_int8(g)

    cfg = flagship_config()
    sd = seeded_state_dict(cfg.unet_config(), seed=0)
    frames64, base = rand((64, 6, *FRAME), g), rand((6, *FRAME), g)
    launches, pred16 = drive_main_path(cfg, sd, frames64, base)
    int8_launches, qpred = drive_int8_path(pred16, frames64, base)

    timings, e2e = measure(pred16, qpred, frames64, base, peaks)
    sites = measure_conv_sites(peaks, g)
    t = timings[64]
    sums = {k: sum(v[k] for v in sites.values()) for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms")}
    kernels = [{
        "name": "fused_preprocess_dual",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }, {
        # times summed over the 17 flagship sites at N=64; library: torch._int_mm
        "name": "conv2d_int8",
        "route": "cuda",
        "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        "launches": int8_launches["conv2d_int8"],
        "max_abs_err": conv_err,
        "ms": sums["ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": "operations" if sums["ops_ms"] >= sums["bytes_ms"] else "bytes",
        "library_ms": sums["library_ms"],
        "sites": list(sites),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"end_to_end": e2e, "kernel_N1": timings[1], "conv2d_int8_sites_N64": sites,
                      "int8_main_path_launches": int8_launches}))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
