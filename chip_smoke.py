#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in the
checkout, holds each against its plain PyTorch twin on the card, drives
the main path (flagship dual-frame serving through ``Predictor``, seeded
random weights) and checks what comes out, then times the kernels and the
path with CUDA events. Prints the card, a ``{"kernels": [...]}`` line, an
end-to-end line and, last, ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero; with no CUDA device it exits non-zero before any
result. Imports nothing of JAX or of the JAX package.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch import GelslimConfig, Predictor
from gelslim_depth_tpu_torch.inference import fused_predict_dual
from gelslim_depth_tpu_torch.models import UNet
from gelslim_depth_tpu_torch.ops.kernels import (
    build,
    fused_preprocess_dual,
    fused_preprocess_dual_reference,
)

FRAME = (320, 427)
NET_IN = (160, 213)
KERNEL_SOURCE = "gelslim_depth_tpu_torch/csrc/fused_preprocess_dual.cu"
KERNEL_REPLACES = "gelslim_depth_tpu/ops/pallas/preprocess_kernel.py:41"
MULT = [1 / 255.0] * 3  # 0_255_to_0_1
ADD = [0.0] * 3

# data-sheet peaks: device memory bytes/s and float32 (non-tensor-core) FLOP/s
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),  # SXM
)


# substrings of device op names -> the layer they belong to, for the
# trace's breakdown; any other op is counted under LIBRARY_OPS
LIBRARY_OPS = "library kernels (cuDNN convs, cuBLAS)"
DEVICE_OP_KEYS = {
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
    for key, bw, f32 in CARD_PEAKS:
        if key in name:
            return bw, f32
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


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    share, device ops per call, {category: share of device op time}), or
    None when the trace holds no device events. Busy time is the union of
    the device ops' intervals; the idle share is the rest of the span from
    the first device op's start to the last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    span = end - spans[0][0]
    per_category = dict.fromkeys((*DEVICE_OP_KEYS, LIBRARY_OPS), 0.0)
    for e in events:
        cat = next((c for c, keys in DEVICE_OP_KEYS.items() if any(k in e.name for k in keys)), LIBRARY_OPS)
        per_category[cat] += e.time_range.elapsed_us()
    total = sum(per_category.values())
    shares = {c: v / total for c, v in per_category.items()}
    return busy / calls / 1e3, 1.0 - busy / span, len(events) / calls, shares


def check_kernel(g):
    """Kernel vs plain twin on the same inputs; returns the largest |diff|
    at the flagship shape."""
    flagship_err = 0.0
    nonuniform = ([0.01, 0.02, 0.03], [-1.0, 0.5, 2.0])
    cases = [
        # (n, (H, W), (h, w), use_diff, (mult, add), flagship)
        (1, FRAME, NET_IN, True, (MULT, ADD), True),
        (2, FRAME, NET_IN, True, (MULT, ADD), True),
        (2, FRAME, NET_IN, False, (MULT, ADD), True),
        (8, FRAME, NET_IN, True, (MULT, ADD), True),
        (8, FRAME, NET_IN, False, (MULT, ADD), True),
        (64, FRAME, NET_IN, True, (MULT, ADD), True),
        (64, FRAME, NET_IN, False, (MULT, ADD), True),
        (2, FRAME, NET_IN, True, nonuniform, True),
        (2, FRAME, NET_IN, False, nonuniform, True),
        (3, (64, 86), (32, 43), True, (MULT, ADD), False),
        (3, (64, 86), (32, 43), False, (MULT, ADD), False),
        (2, NET_IN, FRAME, True, (MULT, ADD), False),  # upsampling: windows of 1-2
    ]
    for n, (h_in, w_in), out_size, use_diff, (mult, add), flagship in cases:
        frames, base = rand((n, 6, h_in, w_in), g), rand((6, h_in, w_in), g)
        got = fused_preprocess_dual(frames, base, mult, add, out_size=out_size, use_diff=use_diff)
        want = fused_preprocess_dual_reference(frames, base, mult, add, out_size=out_size, use_diff=use_diff)
        torch.cuda.synchronize()
        check(got.shape == (2 * n, 3, *out_size), f"kernel output shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        tag = f"n={n} {h_in}x{w_in}->{out_size} use_diff={use_diff} mult={mult[0]:.4g}"
        print(f"kernel vs plain: {tag}: max|diff| {err:.3e}", flush=True)
        if mult is MULT:
            check(err < 1e-5, f"kernel disagrees with plain ({tag}): {err}")
        else:
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5), f"kernel disagrees with plain ({tag}): {err}")
        if flagship:
            flagship_err = max(flagship_err, err)
    return flagship_err


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


def measure(pred16, frames64, base, bw, f32_peak):
    """Kernel, plain, library and bound times; bf16 end-to-end stage times."""
    timings = {}
    for n in (1, 64):
        frames = frames64[:n]
        kernel = time_ms(lambda: fused_preprocess_dual(frames, base, MULT, ADD, out_size=NET_IN))
        plain = time_ms(lambda: fused_preprocess_dual_reference(frames, base, MULT, ADD, out_size=NET_IN))
        library = time_ms(lambda: F.adaptive_avg_pool2d(frames, NET_IN))
        bound, bound_by = preprocess_bound_ms(n, *FRAME, *NET_IN, bw, f32_peak)
        timings[n] = dict(ms=kernel, plain_ms=plain, library_ms=library, bound_ms=bound, bound_by=bound_by)
        print(f"fused_preprocess_dual N={n}: kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
              f"adaptive_avg_pool2d {library:.4f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)

    e2e = {}
    for n in (1, 64):
        frames = frames64[:n]
        x = fused_preprocess_dual(frames, base, MULT, ADD, out_size=NET_IN)
        with torch.inference_mode():
            unet = time_ms(lambda: pred16.net(x), reps=20, warmup=3)
        # five rounds of host_ms give the spread of the call time in this run
        rounds = sorted(host_ms(lambda: pred16.predict_dual_frames(frames, base, FRAME)) for _ in range(5))
        call = rounds[2]
        e2e[f"N{n}"] = {
            "dual_frames_per_s": 1e3 * n / call,
            "call_ms": call,
            "call_ms_rounds": rounds,
            "kernel_ms": timings[n]["ms"],
            "unet_ms": unet,
        }
        print(f"bf16 predict_dual_frames N={n}: {call:.3f} ms/call (rounds {rounds[0]:.3f}..{rounds[-1]:.3f}), "
              f"{1e3 * n / call:.1f} dual frames/s (U-Net {unet:.3f} ms)", flush=True)
        prof = device_profile(lambda: pred16.predict_dual_frames(frames, base, FRAME))
        if prof is None:
            print(f"bf16 N={n}: the profiler trace holds no device events; idle share not measured", flush=True)
            e2e[f"N{n}"]["device_profile"] = None
            continue
        busy, idle, ops_per_call, shares = prof
        e2e[f"N{n}"]["device_profile"] = {
            "busy_ms_per_call": busy, "idle_share": idle, "device_ops_per_call": ops_per_call,
            "device_time_shares": shares}
        print(f"bf16 N={n} trace: device busy {busy:.3f} ms/call, idle share {idle:.3f}, "
              f"{ops_per_call:.1f} device ops/call; device time: "
              + "; ".join(f"{c} {v:.3f}" for c, v in shares.items()), flush=True)
    return timings, e2e


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    bw, f32_peak = card_peaks(kind)

    t0 = time.perf_counter()
    build.load_library("fused_preprocess_dual")
    print(f"built fused_preprocess_dual in {time.perf_counter() - t0:.2f} s", flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = check_kernel(g)

    cfg = flagship_config()
    sd = seeded_state_dict(cfg.unet_config(), seed=0)
    frames64, base = rand((64, 6, *FRAME), g), rand((6, *FRAME), g)
    launches, pred16 = drive_main_path(cfg, sd, frames64, base)

    timings, e2e = measure(pred16, frames64, base, bw, f32_peak)
    t = timings[64]
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"end_to_end_bf16": e2e, "kernel_N1": timings[1]}))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
