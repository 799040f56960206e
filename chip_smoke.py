#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in the
checkout (one nvcc each, all at once), holds each against its plain
PyTorch twin on the card, drives the main paths and checks what comes out:
flagship dual-frame serving through ``Predictor`` (seeded random weights),
then int8 serving through ``Predictor.quantize`` -> ``QuantizedPredictor``,
then bakes a seeded synthetic training set from 320x427 frames. It times
the kernels, the U-Nets and the train steps by their device time in a
torch.profiler trace, and whole calls by the host clock. Then the serving
surface: ``entry()``, the ``StreamingEngine`` on the bf16 and int8
predictors, and ``export_predictor`` -> ``ExportedPredictor`` of the int8,
bf16 and f32 predictors. Then training: float32 train steps on the card
against the same steps on the CPU, a bfloat16 loss that falls, and
``Trainer.fit`` on the synthetic set, served from its best checkpoint,
resumed, and exported by the CLI's ``export --check``. Then mesh->depth
ground truth: ``make_mesh_contact_object`` renders 256 grasps each of a
ridged plate and a sphere (1e5 surface points, 320x427) on the card, 16 of
them are held against the CPU path and the host C++ renderer, and the
render is timed. Then data parallelism (``parallel``): NCCL with one rank
on cuda:0 in this process (the DP train step in f32 and bf16 against
``TrainStep``, timed against it, and DP bf16 and int8 serving), two gloo
ranks that share cuda:0 in child processes of this script (``--parallel-rank``;
the f32 step, serving and the DP renderer, gathered; a check of
correctness, not of scaling), and the CLI's ``train --data_parallel`` in 2
processes. Height-sharded serving (``make_spatial_predictor[_int8]``)
runs on one flagship dual frame in both parallel groups: NCCL world 1 (one
band) and the two gloo ranks (a band each), every rank's band held against
the kernels' plain versions. NHWC (``channels_last``) training is held
against NCHW and timed, and a bilinear serving call launches no kernel.
Then the data-prep and training commands on the card:
``generate-depth``, ``train`` (1 epoch, flagship dims, bf16) and ``test``.
Last, the convergence recipe of ``scripts/train_convergence_torch.py`` cut
to 1,000 train dual frames and 3 bf16 epochs at the flagship dims: its best
val loss must fall 20-fold from the initial weights', and its best-val
checkpoint is served in bf16 and int8 on the held-out dual frames, the bf16
depth closer to the ground truth than the best constant map.
Prints the card, an end-to-end line, an engine and export line, a training
line, a meshgen and CLI line, a parallel line, a convergence line, a
``{"kernels": [...]}`` line (every path's launches, the ranks' too), the
card again and, last, ``{"ok": true, "device": {...}}``. Any failed check,
and a rank that fails or hangs past its deadline, exits non-zero; with no
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
import dataclasses
import datetime
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch import GelslimConfig, Predictor, StreamingEngine, Trainer, bake_dataset, cli, parallel
from gelslim_depth_tpu_torch.data.pt_io import load_pt
from gelslim_depth_tpu_torch.data.synthetic import (
    make_mesh_contact_object,
    make_synthetic_object,
    write_synthetic_dataset_tree,
)
from gelslim_depth_tpu_torch.entry import entry, flagship_config
from gelslim_depth_tpu_torch.export import ExportedPredictor, export_predictor
from gelslim_depth_tpu_torch.inference import QuantizedPredictor, fused_predict_dual
from gelslim_depth_tpu_torch.meshgen import (
    depth_render,
    fixtures,
    plane_spec,
    render_depth_batch,
    sample_surface_points,
    save_stl_binary,
)
from gelslim_depth_tpu_torch.meshgen.native_render import render_depth_batch_native
from gelslim_depth_tpu_torch.models.unet import unet_state_shapes
from gelslim_depth_tpu_torch.models import quantize as quantize_module
from gelslim_depth_tpu_torch.models import unet as unet_module
from gelslim_depth_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from gelslim_depth_tpu_torch.ops.kernels import (
    Epilogue,
    build,
    conv2d_int8,
    conv2d_int8_reference,
    conv_int8,
    fused_preprocess_dual,
    fused_preprocess_dual_reference,
)
from gelslim_depth_tpu_torch.utils.profiling import TRACE_ATTEMPTS, busy_us, device_events, device_ms

FRAME = (320, 427)
NET_IN = (160, 213)
KERNEL_SOURCE = "gelslim_depth_tpu_torch/csrc/fused_preprocess_dual.cu"
KERNEL_REPLACES = "gelslim_depth_tpu/ops/pallas/preprocess_kernel.py:41"
CONV_SOURCE = "gelslim_depth_tpu_torch/csrc/conv2d_int8.cu"
CONV_REPLACES = "gelslim_depth_tpu/models/quantize.py:164"
CONV_FAST_PATH = conv_int8.PATHS[-1]  # the mainloop every flagship launch must take
MULT = [1 / 255.0] * 3  # 0_255_to_0_1
ADD = [0.0] * 3

# data-sheet peaks: device memory bytes/s, float32 (non-tensor-core) FLOP/s,
# dense int8 tensor-core OP/s and dense bfloat16 tensor-core FLOP/s
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 1513e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 1671e12, 835e12),
    ("H200", 4.8e12, 67e12, 1979e12, 989e12),
    ("H100", 3.35e12, 67e12, 1979e12, 989e12),  # SXM
)
TRAIN_BATCH = 16  # GelslimConfig.batch_size, the reference's
MESH_POINTS = 100_000  # generate-depth's --pc_sampling default
MESH_POSES = 256
MESH_CHECKED = 16  # poses held against the CPU path and the host renderer
MESH_MAX_DEPTH = 1.9  # make_mesh_contact_object's max_depth_mm


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
# the same for a train step; the first key that matches names the layer.
# cuDNN picks FFT and Winograd algorithms for some float32 convs; their
# transforms and complex GEMMs fall under "other library kernels". A
# transposed conv's forward runs as a data-gradient kernel and its data
# gradient as a forward one, so the upconvs' share lands in the other
# direction
TRAIN_OP_KEYS = {
    "optimizer + EMA (foreach)": ("multi_tensor_apply",),
    "cuDNN conv backward, weights": ("wgrad", "Wgrad"),
    "cuDNN conv backward, data": ("dgrad",),
    "cuDNN conv forward": ("fprop", "implicit_convolve"),
    "cudnn layout transposes": ("nchwToNhwc", "nhwcToNchw"),
    "aten ops (BN, activation, casts, NaN-guard select, pool, pad, cat)": ("at::native",),
    "memcpy/memset": ("Memcpy", "Memset"),
}
TRAIN_LIBRARY_OPS = "other library kernels (cuDNN FFT and Winograd convs, cuBLAS)"
TRAIN_CONV_OPS = ("cuDNN conv backward, weights", "cuDNN conv backward, data", "cuDNN conv forward", TRAIN_LIBRARY_OPS)


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
    """(bytes/s, float32 FLOP/s, int8 OP/s, bfloat16 FLOP/s) of the card."""
    for key, *peaks in CARD_PEAKS:
        if key in name:
            return peaks
    fail(f"no data-sheet peaks for {name!r}")


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
    sd = {}
    for k, shape in unet_state_shapes(cfg).items():
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


def kernel_device_ms(fn, bound_ms: float, tag: str) -> float:
    """device_ms of a kernel, taken again (TRACE_ATTEMPTS times in all)
    while it reads under bound_ms, the least time the card could take: such
    a trace lost device ops (one read the front end at a quarter of its
    byte bound). Warns if every attempt did."""
    for _ in range(TRACE_ATTEMPTS):
        ms = device_ms(fn)
        if ms >= bound_ms:
            return ms
    print(f"WARNING {tag}: {TRACE_ATTEMPTS} traces read {ms:.4f} ms, under the {bound_ms:.4f} ms bound", flush=True)
    return ms


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


def device_profile(fn, calls: int = 10, op_keys=DEVICE_OP_KEYS, other=LIBRARY_OPS):
    """A torch.profiler trace of `calls` calls, each ending in a synchronize
    as a serving loop's does. Returns (device busy ms per call, device idle
    share, device ops per call, {category: share of device op time},
    {category: device ms per call}), or None when the trace holds no device
    events. The idle share is the part of the span from the first device
    op's start to the last one's end in which no device op runs. Device ops
    fall into the first category of op_keys whose substrings their name
    holds, else into `other`."""
    events = device_events(fn, calls, sync_each=True)
    if not events:
        return None
    busy = busy_us(events)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    per_category = dict.fromkeys((*op_keys, other), 0.0)
    for e in events:
        cat = next((c for c, keys in op_keys.items() if any(k in e.name for k in keys)), other)
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
    bw, _, int8_peak, _ = peaks
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
        t_bytes, t_ops = conv_bound_ms(launch, 2, bw, int8_peak)
        kernel_ms = kernel_device_ms(kernel, max(t_bytes, t_ops), f"conv2d_int8 {launch.site}")
        plain_ms = device_ms(plain, calls=3)
        a = im2col(qx, src["qx2"], launch.offset, 3)
        b = w.reshape(launch.cout, -1).t()
        library_ms = device_ms(lambda: torch._int_mm(a, b))
        del a, qx, src
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
    bw, f32_peak, int8_peak, _ = peaks
    timings = {}
    for n in (1, 64):
        frames = frames64[:n]
        bound, bound_by = preprocess_bound_ms(n, *FRAME, *NET_IN, bw, f32_peak)
        kernel = kernel_device_ms(lambda: fused_preprocess_dual(frames, base, MULT, ADD, out_size=NET_IN), bound,
                                  f"fused_preprocess_dual N={n}")
        plain = device_ms(lambda: fused_preprocess_dual_reference(frames, base, MULT, ADD, out_size=NET_IN))
        library = device_ms(lambda: F.adaptive_avg_pool2d(frames, NET_IN))
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


def reset_launches() -> None:
    fused_preprocess_dual.launches = 0
    conv2d_int8.launches = 0
    conv2d_int8.launches_by_path = dict.fromkeys(conv_int8.PATHS, 0)


def read_launches() -> dict:
    return {"fused_preprocess_dual": fused_preprocess_dual.launches, "conv2d_int8": conv2d_int8.launches,
            "conv2d_int8_by_path": dict(conv2d_int8.launches_by_path)}


def drive_entry():
    """The port's entry(): the bf16 flagship on the card, one call on its
    two example dual frames. Returns the call's launches."""
    fn, args = entry()
    reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    check(tuple(out.shape) == (2, 2, *FRAME), f"entry: shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()) and out.max().item() <= 0.0,
          f"entry: depth not finite and <= 0: [{out.min().item()}, {out.max().item()}]")
    check(launches["fused_preprocess_dual"] == 1, f"entry: launches {launches}")
    print(f"entry(): fn(frames, base) -> {tuple(out.shape)} mm in [{out.min().item():.3f}, "
          f"{out.max().item():.3f}]; launches {launches}", flush=True)
    return launches


def submit_does_not_wait(pred, host_frames, base):
    """Holds the stream busy (~0.1 s of device sleep), submits two frames and
    checks that both dispatches still report not done when submit returns:
    the upload does not synchronize the stream. Returns the host seconds of
    the two submits."""
    eng = StreamingEngine(pred, FRAME, base_frame=base, max_inflight=8, max_dispatches=2)
    for f in host_frames[:4]:  # warm: pinned blocks exist
        eng.submit(f)
    eng.drain()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    eng.submit(host_frames[0])
    eng.submit(host_frames[1])
    host_s = time.perf_counter() - t0
    in_flight = [d.done.query() for d in eng._outstanding]
    check(len(in_flight) == 2 and not any(in_flight),
          f"submit waited for the dispatch in flight: done {in_flight} after {host_s:.4f} s")
    eng.drain()
    return host_s


def coalesced_run(pred, frames, host_frames, base, want):
    """The stream held busy (~0.1 s of device sleep) while 8 frames arrive,
    one dispatch slot: the engine coalesces them into micro-batches of 1,
    4, 2 and 1. Each output must equal the predictor's call on the same
    micro-batch (within 1e-6 mm: the same shapes run the same algorithms),
    and lie within the 0.05 mm parity gate of predict_dual_frames of its
    frame alone (bf16 convs round elsewhere at other batch sizes). Returns
    (mean dispatch size, largest |diff| against the same micro-batches, and
    against the frames alone, in mm)."""
    eng = StreamingEngine(pred, FRAME, base_frame=base, max_inflight=8, microbatch=4, max_dispatches=1)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    for f in host_frames[:8]:
        eng.submit(f)
    outs = np.concatenate(eng.drain())
    st = eng.stats()
    with torch.inference_mode():
        same = torch.cat([pred.predict_dual_frames(frames[i:i + k], base, FRAME)
                          for i, k in ((0, 1), (1, 4), (5, 2), (7, 1))]).cpu().numpy()
    err_same = float(np.abs(outs - same).max())
    err_alone = float(np.abs(outs - np.concatenate(want[:8])).max())
    check(st["dispatches"] == 4 and st["completed"] == 8, f"coalesced run: stats {st}")
    check(err_same <= 1e-6, f"coalesced run: output differs from the same micro-batches by {err_same} mm")
    check(err_alone < 0.05, f"coalesced run: output differs from predict_dual_frames by {err_alone} mm")
    return st["mean_dispatch_size"], err_same, err_alone


def drive_engine(pred16, qpred, frames64, base, e2e):
    """StreamingEngine on the bf16 and the int8 flagship predictors at
    micro-batches 1, 2 and 4, two dispatch slots: 256 host numpy frames
    (64 distinct, cycled) submitted back to back, then drained. Every
    output within 1e-3 mm of predict_dual_frames of its frame (cuDNN may
    take other algorithms at other batch sizes); launches per dispatch:
    one fused_preprocess_dual, and 17 conv2d_int8 for int8. Returns the
    records and the launches over the runs."""
    host = [f.cpu().numpy() for f in frames64]
    sites = len(quantize_module._quantized_sites(qpred.q.cfg))
    out, total = {}, dict.fromkeys(("fused_preprocess_dual", "conv2d_int8"), 0)
    for tag, pred in (("bf16", pred16), ("int8", qpred)):
        with torch.inference_mode():
            want = [pred.predict_dual_frames(f[None], base, FRAME).cpu().numpy() for f in frames64]
        probe_s = submit_does_not_wait(pred, host, base)
        coalesced = coalesced_run(pred, frames64, host, base, want)
        print(f"engine {tag}: submit returned with both dispatches in flight ({probe_s * 1e3:.2f} ms for two "
              f"submits behind a device sleep); 8 frames behind a busy stream coalesced to a mean dispatch of "
              f"{coalesced[0]:.2f} frames, max|diff| {coalesced[1]:.3e} mm vs the same micro-batches, "
              f"{coalesced[2]:.3e} mm vs predict_dual_frames of each frame", flush=True)
        stager = StreamingEngine(pred, FRAME)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in host:
            stager._stage(f)
        stage_ms = 1e3 * (time.perf_counter() - t0) / len(host)
        torch.cuda.synchronize()
        for mb in (1, 2, 4):
            eng = StreamingEngine(pred, FRAME, base_frame=base, max_inflight=256, drop_policy="block",
                                  microbatch=mb, max_dispatches=2)
            torch.cuda.synchronize()
            reset_launches()
            not_done = 0
            t0 = time.perf_counter()
            for i in range(256):
                prev = eng._outstanding[-1] if eng._outstanding else None
                eng.submit(host[i % 64])
                not_done += prev is not None and not prev.done.query()
            submit_ms = 1e3 * (time.perf_counter() - t0) / 256
            outs = eng.drain()
            launches = read_launches()
            st = eng.stats()
            err = max(float(np.abs(o - want[i % 64]).max()) for i, o in enumerate(outs))
            rec = out[f"{tag}_mb{mb}"] = {
                "frames_per_s": st["throughput_fps"], "mean_latency_ms": st["mean_latency_ms"],
                "mean_dispatch_size": st["mean_dispatch_size"], "dispatches": st["dispatches"],
                "submit_host_ms": submit_ms, "max_abs_diff_mm": err, "launches": launches,
                "submits_returned_with_previous_dispatch_not_done": not_done,
                "n1_call_ms": e2e[f"{tag}_N1"]["call_ms"], "submit_probe_s": probe_s,
                "coalesced_mean_dispatch": coalesced[0], "coalesced_max_abs_diff_mm": coalesced[1],
                "coalesced_vs_n1_max_abs_diff_mm": coalesced[2],
                "stage_host_ms": stage_ms}
            print(f"engine {tag} microbatch {mb}: {st['throughput_fps']:.1f} dual frames/s (N=1 call "
                  f"{rec['n1_call_ms']:.3f} ms, i.e. {1e3 / rec['n1_call_ms']:.1f}/s), mean latency "
                  f"{st['mean_latency_ms']:.2f} ms, mean dispatch {st['mean_dispatch_size']:.2f} frames over "
                  f"{st['dispatches']} dispatches, submit {submit_ms:.3f} ms host ({stage_ms:.3f} of it staging the frame), "
                  f"{not_done}/256 submits returned "
                  f"with the previous dispatch not done; max|diff| vs predict_dual_frames {err:.3e} mm; "
                  f"launches {launches}", flush=True)
            check(st["completed"] == 256 and st["dropped"] == 0, f"engine {tag} mb {mb}: stats {st}")
            check(err <= 1e-3, f"engine {tag} mb {mb}: output differs from predict_dual_frames by {err} mm")
            check(launches["fused_preprocess_dual"] == st["dispatches"],
                  f"engine {tag} mb {mb}: {launches} over {st['dispatches']} dispatches")
            want_conv = sites * st["dispatches"] if tag == "int8" else 0
            check(launches["conv2d_int8"] == want_conv,
                  f"engine {tag} mb {mb}: conv2d_int8 launches {launches['conv2d_int8']}, want {want_conv}")
            for k in total:
                total[k] += launches[k]
    return out, total


@contextlib.contextmanager
def torch_tf32_everywhere():
    """TF32 on for cuDNN's convs and float32 matmuls, set globally."""
    prev = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def drive_export(cfg, sd, pred16, qpred, frames64, base):
    """export_predictor of the bf16, int8 and f32 flagship predictors at
    batch sizes (1, 64), reloaded with ExportedPredictor.load. int8 at
    N=64 bit for bit with QuantizedPredictor, one call launching 17
    conv2d_int8 and one fused_preprocess_dual; bf16 and f32 within 1e-4 mm
    RMSE of the live predictor, f32 called with TF32 on globally (a
    control: the graph called without the artifact's precision flags must
    miss that bar); N=2 runs two b1 graphs. Times the exported and the
    live call at N=1 and N=64. Returns the records and the launches."""
    pred32 = Predictor(cfg, sd)
    out, total = {}, dict.fromkeys(("fused_preprocess_dual", "conv2d_int8"), 0)
    sites = len(quantize_module._quantized_sites(qpred.q.cfg))
    with tempfile.TemporaryDirectory() as tmp:
        for tag, pred in (("int8", qpred), ("bf16", pred16), ("f32", pred32)):
            t0 = time.perf_counter()
            path = export_predictor(pred, FRAME, path=os.path.join(tmp, f"{tag}.gsx"), batch_sizes=(1, 64),
                                    frame_size=FRAME)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            served = ExportedPredictor.load(path)
            load_s = time.perf_counter() - t0
            with torch.inference_mode():
                live = pred.predict_dual_frames(frames64, base, FRAME)
            reset_launches()
            if tag == "f32":
                with torch_tf32_everywhere():
                    got = served(frames64, base)
            else:
                got = served(frames64, base)
            torch.cuda.synchronize()
            launches = read_launches()
            rmse = (got - live).pow(2).mean().sqrt().item()
            rec = out[tag] = {"export_s": export_s, "load_s": load_s, "artifact_mb": os.path.getsize(path) / 2 ** 20,
                              "rmse_vs_live_mm_N64": rmse, "max_abs_diff_mm_N64": (got - live).abs().max().item(),
                              "launches_N64": launches}
            want_launch = (1, sites if tag == "int8" else 0)
            check((launches["fused_preprocess_dual"], launches["conv2d_int8"]) == want_launch,
                  f"export {tag} N=64: launches {launches}, want {want_launch}")
            if tag == "int8":
                check(torch.equal(got, live), f"exported int8 N=64 differs from QuantizedPredictor: RMSE {rmse} mm")
                check(launches["conv2d_int8_by_path"][CONV_FAST_PATH] == sites,
                      f"exported int8 N=64: {launches['conv2d_int8_by_path']}")
            else:
                check(rmse < 1e-4, f"exported {tag} N=64: RMSE {rmse} mm vs the live predictor")
            if tag == "f32":
                with torch_tf32_everywhere(), torch.inference_mode():  # the control
                    bare = served._graphs[64](frames64.contiguous(), base.contiguous())
                rec["control_tf32_rmse_mm"] = (bare - live).pow(2).mean().sqrt().item()
                check(rec["control_tf32_rmse_mm"] >= 1e-4,
                      f"the f32 bar misses TF32: the bare graph under TF32 is within {rec['control_tf32_rmse_mm']} mm")
            # N=2 on a (1, 64) artifact: two b1 graphs, each held to a live N=1 call
            reset_launches()
            two = served(frames64[:2], base)
            torch.cuda.synchronize()
            n2 = read_launches()
            check(served.dispatch_plan(2) == [(1, 1), (1, 1)] and n2["fused_preprocess_dual"] == 2
                  and n2["conv2d_int8"] == (2 * sites if tag == "int8" else 0),
                  f"export {tag} N=2: plan {served.dispatch_plan(2)}, launches {n2}")
            with torch.inference_mode():
                live1 = torch.cat([pred.predict_dual_frames(frames64[i:i + 1], base, FRAME) for i in range(2)])
            rmse2 = (two - live1).pow(2).mean().sqrt().item()
            check(torch.equal(two, live1) if tag == "int8" else rmse2 < 1e-4,
                  f"export {tag} N=2 differs from two live N=1 calls: RMSE {rmse2} mm")
            for k in total:
                total[k] += launches[k] + n2[k]
            for n in (1, 64):
                f = frames64[:n]
                rec[f"exported_call_ms_N{n}"] = host_ms(lambda: served(f, base))
                rec[f"live_call_ms_N{n}"] = host_ms(lambda: pred.predict_dual_frames(f, base, FRAME))
            rec["call_overhead_rows"] = rec["exported_call_ms_N1"] / (rec["exported_call_ms_N64"] / 64)
            print(f"export {tag}: export {export_s:.1f} s, load {load_s:.1f} s, {rec['artifact_mb']:.0f} MiB; N=64 vs "
                  f"live RMSE {rmse:.3e} mm (max|diff| {rec['max_abs_diff_mm_N64']:.3e})"
                  + (f", TF32 control {rec['control_tf32_rmse_mm']:.3e} mm" if tag == "f32" else "")
                  + f"; exported call {rec['exported_call_ms_N1']:.3f} ms at N=1, {rec['exported_call_ms_N64']:.3f} ms "
                  f"at N=64 (live {rec['live_call_ms_N1']:.3f}, {rec['live_call_ms_N64']:.3f}); call overhead "
                  f"{rec['call_overhead_rows']:.2f} rows; launches N=64 {launches}, N=2 {n2}", flush=True)
            del served, got
            torch.cuda.empty_cache()
    return out, total


def unet_conv_flops(cfg, hw):
    """Forward FLOPs of one image's convs (2 a multiply-add), from the
    shapes: padding-1 convs, floor max-pools, the transposed convs, the
    decoder's 3x3 DoubleConvs at the skips' sizes, the 1x1 head.
    Returns (all convs, the first conv alone)."""
    dims, k, m = cfg.layer_dimensions, cfg.kernel_size, cfg.maxpool_size

    def conv(cin, cout, kk, h, w):
        ho, wo = h + 3 - kk, w + 3 - kk
        return 2 * kk * kk * cin * cout * ho * wo, ho, wo

    first, h, w = conv(cfg.n_channels, dims[0], k, *hw)
    f, h, w = conv(dims[0], dims[0], k, h, w)
    total, sizes = first + f, [(h, w)]
    for i in range(1, len(dims)):
        f1, h, w = conv(dims[i - 1], dims[i], k, h // m, w // m)
        f2, h, w = conv(dims[i], dims[i], k, h, w)
        total += f1 + f2
        sizes.append((h, w))
    for j in range(len(dims) - 1):
        cin, cout, ku = dims[-1 - j], dims[-2 - j], k - 1
        total += 2 * ku * ku * cin * (cin // 2) * h * w  # every input pixel meets the whole kernel
        f1, h, w = conv(cin, cout, 3, *sizes[-2 - j])
        f2, h, w = conv(cout, cout, 3, h, w)
        total += f1 + f2
    return total + 2 * dims[0] * cfg.n_classes * h * w, first


def training_sets():
    """A seeded synthetic set baked on the card from 320x427 frames at the
    flagship's normalization: 128 train, 16 val and 16 test finger samples."""
    rng = np.random.RandomState(0)
    bake = dict(use_difference_image=True, image_normalization_method="0_255_to_0_1",
                depth_normalization_method="min_max_to_0_-1", norm_scale=0.9, downsample_factor=0.5)
    train = bake_dataset(preloaded=[make_synthetic_object(rng, 8, FRAME) for _ in range(8)], **bake)
    frozen = dict(depth_normalization_parameters=train.depth_normalization_parameters,
                  image_normalization_parameters=train.image_normalization_parameters)
    val, test = (bake_dataset(preloaded=[make_synthetic_object(rng, 8, FRAME)], **bake, **frozen) for _ in range(2))
    check(tuple(train.tactile_image.shape) == (128, 3, *NET_IN) and train.tactile_image.is_cuda,
          f"baked train set {tuple(train.tactile_image.shape)} on {train.tactile_image.device}")
    return train, val, test


def rel_l2(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def _tf32_on():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def tf32_forced():
    """A deliberate fault for the parity controls: the port's float32 guard
    (``models.unet._no_cudnn_tf32``, which ``full_precision`` enters in
    the forward and a train step across its backward) turned into its
    opposite, so that every cuDNN conv of the step may run in TF32."""
    keep = unet_module._no_cudnn_tf32
    unet_module._no_cudnn_tf32 = _tf32_on
    try:
        yield
    finally:
        unet_module._no_cudnn_tf32 = keep


def check_train_step_parity(ucfg, train):
    """One train step on the card against the same step on the CPU, from the
    same seeded state, on 2 finger samples.

    Flagship (ReLU), float32: loss rtol 1e-4, the new BN running statistics
    rtol 1e-4 / atol 1e-6, the parameters after the step rtol 5e-3 / atol
    2e-3. Its gradients cannot be held to each other per tensor: a ReLU
    input or a max-pool pair within rounding of its kink flips between two
    float32 implementations, and the gradient jumps there. So they are held
    in float64 (card vs CPU, every tensor within a relative L2 error of
    1e-3), and each side's float32 gradients to the card's float64 step,
    the card's median error at most 2x the CPU's.

    tanh, float32 (the same state; tanh has no kink): every gradient tensor
    of the card within a relative L2 error of 1e-3 of the CPU's.

    Controls: the same card steps with TF32 forced on (``tf32_forced``)
    must fail both gradient bars. torch's default flags stay as they are
    otherwise: a float32 step turns cuDNN TF32 off itself, across the
    forward and the backward."""
    opt = make_optimizer()
    state = create_train_state(ucfg, opt, generator=torch.Generator().manual_seed(0))
    x, y = train.tactile_image[:2], train.depth_image[:2]
    mask = torch.ones(2, dtype=torch.bool)
    tanh = dataclasses.replace(ucfg, activation="tanh")

    def run(cfg, dev, dtype, tf32=False):
        step = make_train_step(cfg, opt, compute_dtype=dtype, masked=True)
        st = state.to(dev)
        t0 = time.perf_counter()
        with tf32_forced() if tf32 else contextlib.nullcontext():
            loss, stats, grads = step.loss_and_grads(st, x.to(dev), y.to(dev), mask.to(dev))
        new, _ = step.apply_updates(st, loss, stats, grads)
        return (loss.item(), {k: v.cpu() for k, v in stats.items()}, {k: v.cpu() for k, v in grads.items()},
                {k: v.cpu() for k, v in new.params.items()}, time.perf_counter() - t0)

    f32, f64 = torch.float32, torch.float64
    cpu32, card32, cpu64, card64 = (run(ucfg, dev, dtype) for dtype in (f32, f64) for dev in ("cpu", "cuda"))
    card32_tf32 = run(ucfg, "cuda", f32, tf32=True)
    tanh_cpu32, tanh_card32, tanh_card64 = run(tanh, "cpu", f32), run(tanh, "cuda", f32), run(tanh, "cuda", f64)
    tanh_card32_tf32 = run(tanh, "cuda", f32, tf32=True)
    (lc, sc, _, pc, tc), (lg, sg, _, pg, _) = cpu32, card32
    stat_err = max((sg[k] - sc[k]).abs().max().item() for k in sc)
    param_err = max((pg[k] - pc[k]).abs().max().item() for k in pc)

    def errs(a, b):
        """(relative L2 error, tensor) of a's gradients against b's, worst first."""
        return sorted(((rel_l2(a[2][k], b[2][k]), k) for k in b[2]), reverse=True)

    g64 = errs(card64, cpu64)
    table = {
        "relu card f32 vs card f64": errs(card32, card64), "relu cpu f32 vs card f64": errs(cpu32, card64),
        "relu card f32 vs cpu f32": errs(card32, cpu32),
        "relu card f32 TF32 (control) vs card f64": errs(card32_tf32, card64),
        "tanh card f32 vs cpu f32": errs(tanh_card32, tanh_cpu32),
        "tanh card f32 vs card f64": errs(tanh_card32, tanh_card64),
        "tanh cpu f32 vs card f64": errs(tanh_cpu32, tanh_card64),
        "tanh card f32 TF32 (control) vs cpu f32": errs(tanh_card32_tf32, tanh_cpu32),
    }
    median = {tag: e[len(e) // 2][0] for tag, e in table.items()}
    print(f"train step, card vs CPU (2 finger samples; CPU f32 {tc:.2f} s, CPU f64 {cpu64[4]:.2f} s, CPU tanh f32 "
          f"{tanh_cpu32[4]:.2f} s): relu f32 loss {lg:.7f} vs {lc:.7f}; BN stats max|diff| {stat_err:.3e}; params "
          f"max|diff| {param_err:.3e}; f64 gradients rel L2 worst {g64[0][0]:.3e} ({g64[0][1]})", flush=True)
    for tag, e in table.items():
        print(f"  gradients, {tag}: rel L2 median {median[tag]:.3e}, worst {e[0][0]:.3e} ({e[0][1]})", flush=True)
    ratio = median["relu card f32 vs card f64"] / median["relu cpu f32 vs card f64"]
    ratio_tf32 = median["relu card f32 TF32 (control) vs card f64"] / median["relu cpu f32 vs card f64"]
    print(f"  relu f32 gradients' median error against f64, card over CPU: {ratio:.3f} (bar 2); "
          f"with TF32 forced on: {ratio_tf32:.3f}", flush=True)
    check(abs(lg - lc) <= 1e-4 * abs(lc), f"train step loss: card {lg} vs CPU {lc}")
    for k in sc:
        check(torch.allclose(sg[k], sc[k], rtol=1e-4, atol=1e-6), f"train step BN statistic {k} differs")
    for k in pc:
        check(torch.allclose(pg[k], pc[k], rtol=5e-3, atol=2e-3), f"train step parameter {k} differs")
    check(g64[0][0] < 1e-3, f"float64 train step gradient {g64[0][1]}: card vs CPU relative L2 {g64[0][0]}")
    check(ratio <= 2, f"the card's float32 relu gradients are {ratio}x as far from float64 as the CPU's")
    worst = table["tanh card f32 vs cpu f32"][0]
    check(worst[0] < 1e-3, f"tanh float32 train step gradient {worst[1]}: card vs CPU relative L2 {worst[0]}")
    control = table["tanh card f32 TF32 (control) vs cpu f32"][0][0]
    check(ratio_tf32 > 2 and control >= 1e-3,
          f"the gradient bars miss TF32: relu ratio {ratio_tf32}, tanh worst {control}")
    return {"loss_card": lg, "loss_cpu": lc, "bn_stats_max_abs_diff": stat_err, "params_max_abs_diff": param_err,
            "f64_grad_rel_l2_worst": g64[0][0], "cpu_f32_step_s": tc, "cpu_f64_step_s": cpu64[4],
            "relu_f32_median_ratio": ratio, "relu_f32_median_ratio_tf32_control": ratio_tf32,
            "grad_rel_l2": {tag: {"median": median[tag], "worst": e[0][0], "worst_tensor": e[0][1]}
                            for tag, e in table.items()}}


def check_bf16_learning(ucfg, train):
    """The loss on one fixed batch of 16 falls over 20 bfloat16 steps."""
    opt = make_optimizer()
    step = make_train_step(ucfg, opt, compute_dtype=torch.bfloat16, masked=True)
    state = create_train_state(ucfg, opt, generator=torch.Generator().manual_seed(1), device="cuda")
    x, y = train.tactile_image[:TRAIN_BATCH], train.depth_image[:TRAIN_BATCH]
    mask = torch.ones(TRAIN_BATCH, dtype=torch.bool, device="cuda")
    losses = []
    for _ in range(20):
        state, loss = step(state, x, y, mask)
        losses.append(loss)
    losses = [v.item() for v in losses]
    print(f"bf16 train steps on one batch of {TRAIN_BATCH}: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
          f"(min {min(losses):.5f})", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"bf16 loss did not fall: {losses}")
    return losses


def drive_training(cfg, train, val, test, base):
    """Trainer.fit for 2 epochs on the synthetic set, float32; then the
    best-val checkpoint served on the card through fused_preprocess_dual,
    and a save_resume_state -> load_resume_state round trip held bit for
    bit to the live state; then the CLI's export --check of that
    checkpoint. Returns the record and the kernel launches of the two
    paths."""
    reset_launches()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        tr = Trainer(cfg, train, val, test, output_dir=out, seed=0, log_fn=lambda m: None, enable_plots=False)
        hist = tr.fit(max_epochs=2)
        fit_s = time.perf_counter() - t0
        print(f"Trainer.fit 2 epochs (128/16/16 finger samples, batch {cfg.batch_size}, f32): {fit_s:.2f} s, "
              f"history {hist}", flush=True)
        check(all(np.isfinite(v) for vs in hist.values() for v in vs) and len(hist["train_loss"]) == 2,
              f"Trainer history {hist}")
        wdir = os.path.join(out, "weights")
        check(os.path.exists(os.path.join(wdir, f"{cfg.weights_name}.npz")), "no best-val checkpoint written")
        pred = Predictor.from_checkpoint(wdir)
        frames = rand((1, 6, *FRAME), torch.Generator(device="cuda").manual_seed(5))
        depth = pred.predict_dual_frames(frames, base, FRAME)
        torch.cuda.synchronize()
        check(tuple(depth.shape) == (1, 2, *FRAME) and bool(torch.isfinite(depth).all()),
              f"serving the trained checkpoint: {tuple(depth.shape)}")
        live = {k: v.clone() for k, v in tr.state.tensors().items()}
        tr.save_resume_state()
        tr.load_resume_state()
        loaded = tr.state.tensors()
        same = set(loaded) == set(live) and all(
            torch.equal(loaded[k], v) and loaded[k].device == v.device for k, v in live.items())
        check(same and tr.epoch == 2, "resume round trip differs from the live state")
        launches = {"training_serve": read_launches()}
        print(f"training path launches: {launches['training_serve']}; resume round trip bit for bit", flush=True)
        check(launches["training_serve"]["fused_preprocess_dual"] == 1,
              f"serving the trained checkpoint launched {launches['training_serve']}")

        # the export command on the fit checkpoint, in-process, on the card
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["export", cfg.weights_name, "--weights_dir", wdir, "--batch_sizes", "1", "2", "--check",
                       "--output", os.path.join(out, "trained.gsx")])
        cli_s = time.perf_counter() - t0
        launches["cli_export"] = read_launches()
        print(f"cli export --check on the fit checkpoint: rc {rc} in {cli_s:.1f} s; launches "
              f"{launches['cli_export']}", flush=True)
        check(rc == 0 and launches["cli_export"]["fused_preprocess_dual"] > 0,
              f"cli export: rc {rc}, launches {launches['cli_export']}")
    return {"fit_s": fit_s, "history": hist, "served_depth_range_mm": [depth.min().item(), depth.max().item()],
            "cli_export_s": cli_s}, launches


def measure_training(ucfg, train, peaks):
    """Train-step times at batch 16, float32 and bfloat16: device time of
    a step, of its optimizer + EMA half alone, and host time of a step
    ending in a synchronize; a trace's idle share, device ops and time by
    layer; peak memory; the step's conv FLOPs over the card's peak."""
    _, f32_peak, _, bf16_peak = peaks
    fwd, first = unet_conv_flops(ucfg, NET_IN)
    step_flops = TRAIN_BATCH * (3 * fwd - first)  # forward, weight and data gradients; no data gradient for x
    x, y = train.tactile_image[:TRAIN_BATCH], train.depth_image[:TRAIN_BATCH]
    mask = torch.ones(TRAIN_BATCH, dtype=torch.bool, device="cuda")
    out = {"conv_gflop_forward_per_image": fwd / 1e9, "conv_tflop_per_step": step_flops / 1e12}
    print(f"conv FLOPs: {fwd / 1e9:.3f} GFLOP a forward of one {NET_IN} finger image, "
          f"{step_flops / 1e12:.4f} TFLOP a train step of {TRAIN_BATCH}", flush=True)
    for tag, dtype, peak in (("f32", torch.float32, f32_peak), ("bf16", torch.bfloat16, bf16_peak)):
        opt = make_optimizer()
        step = make_train_step(ucfg, opt, compute_dtype=dtype, masked=True)
        state = create_train_state(ucfg, opt, generator=torch.Generator().manual_seed(2), device="cuda")
        state, _ = step(state, x, y, mask)  # Adam's moments no longer zero
        run = lambda: step(state, x, y, mask)  # noqa: E731
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak_mem = torch.cuda.max_memory_allocated()
        step_ms = device_ms(run, calls=5)
        grads = step.loss_and_grads(state, x, y, mask)
        update_ms = device_ms(lambda: step.apply_updates(state, *grads), calls=10)
        del grads
        call = host_ms(run, reps=5, warmup=1)
        rec = out[tag] = {
            "step_device_ms": step_ms, "step_host_ms": call,
            "finger_images_per_s_device": 1e3 * TRAIN_BATCH / step_ms,
            "finger_images_per_s_host": 1e3 * TRAIN_BATCH / call,
            "optimizer_ema_device_ms": update_ms,
            "max_memory_allocated_gib": peak_mem / 2 ** 30, "step_memory_gib": (peak_mem - base_mem) / 2 ** 30,
            # the step's conv FLOPs over the whole step's device time
            "conv_bound_ms": 1e3 * step_flops / peak, "conv_flops_share_of_peak": step_flops / (step_ms * 1e-3) / peak,
        }
        print(f"train step {tag} batch {TRAIN_BATCH}: device {step_ms:.3f} ms ({rec['finger_images_per_s_device']:.1f} "
              f"finger images/s), host {call:.3f} ms ({rec['finger_images_per_s_host']:.1f}/s); optimizer + EMA "
              f"{update_ms:.3f} ms; max_memory_allocated {rec['max_memory_allocated_gib']:.2f} GiB "
              f"({rec['step_memory_gib']:.2f} for the step); convs at the {peak / 1e12:.0f} TFLOP/s peak "
              f"{rec['conv_bound_ms']:.3f} ms, {100 * rec['conv_flops_share_of_peak']:.1f}% of it over the step's time",
              flush=True)
        events = device_events(run, 1, sync_each=True)
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        rec["heaviest_kernels_ms"] = {n[:120]: us / 1e3 for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
        print(f"train step {tag}, heaviest device kernels of one step: "
              + "; ".join(f"{n} {ms:.3f} ms" for n, ms in rec["heaviest_kernels_ms"].items()), flush=True)
        prof = device_profile(run, calls=3, op_keys=TRAIN_OP_KEYS, other=TRAIN_LIBRARY_OPS)
        if prof is None:
            print(f"train step {tag}: the trace holds no device events; idle share not measured", flush=True)
            rec["device_profile"] = None
        else:
            busy, idle, ops, shares, ms = prof
            conv_ms = sum(v for c, v in ms.items() if c in TRAIN_CONV_OPS)
            rec["device_profile"] = {"busy_ms_per_step": busy, "idle_share": idle, "device_ops_per_step": ops,
                                     "device_time_shares": shares, "device_ms_per_step": ms,
                                     "conv_device_ms_per_step": conv_ms,
                                     "conv_flops_share_of_peak_in_conv_time": step_flops / (conv_ms * 1e-3) / peak}
            print(f"train step {tag} trace: busy {busy:.3f} ms/step, idle share {idle:.3f}, {ops:.1f} device "
                  "ops/step; device ms: " + "; ".join(f"{c} {v:.3f}" for c, v in ms.items())
                  + f"; convs {conv_ms:.3f} ms, their FLOPs over it "
                  f"{100 * rec['device_profile']['conv_flops_share_of_peak_in_conv_time']:.1f}% of the peak", flush=True)
        del state, step
        torch.cuda.empty_cache()
    return out


def drive_bilinear(cfg, sd, frames64, base):
    """A bilinear serving call (interp_method 'bilinear', jax.image.resize's
    linear weights): the f32 Predictor at N=1 takes the composed front end,
    since the kernel hard-wires the area resize. Run with the launch counts
    set to 0 just before and read just after: no launch. Held against the
    same call on the CPU within rtol/atol 1e-4 mm (float32 convs and
    contractions in another order, TF32 off on the card). Returns (record,
    launches)."""
    bcfg = dataclasses.replace(cfg, interp_method="bilinear")
    pred = Predictor(bcfg, sd)
    frame = frames64[:1]
    reset_launches()
    got = pred.predict_dual_frames(frame, base, FRAME)
    torch.cuda.synchronize()
    launches = read_launches()
    want = Predictor(bcfg, sd, device="cpu").predict_dual_frames(frame.cpu(), base.cpu(), FRAME)
    err = (got.cpu() - want).abs().max().item()
    rec = {"f32_n1_vs_cpu_max_abs_diff_mm": err, "f32_n1_call_ms": host_ms(lambda: pred.predict_dual_frames(
        frame, base, FRAME), reps=10, warmup=2)}
    print(f"bilinear serving, f32 N=1: card vs CPU max|diff| {err:.3e} mm, {rec['f32_n1_call_ms']:.3f} ms a call; "
          f"launches {launches}", flush=True)
    check(launches["fused_preprocess_dual"] == 0 and launches["conv2d_int8"] == 0,
          f"bilinear serving launched a kernel: {launches}")
    check(tuple(got.shape) == (1, 2, *FRAME) and bool(torch.isfinite(got).all()), "bilinear serving: bad depth")
    check(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4), f"bilinear serving, card vs CPU: {err} mm")
    return rec, launches


def check_nhwc(ucfg, train):
    """NHWC (channels_last) training at the flagship dims, batch 16: one
    float32 train step on NHWC tensors against the NCHW step from the same
    state, at the card-vs-card bars of the DP check (loss rtol 1e-4 / atol
    1e-6; new parameters and running statistics rtol 1e-3 / atol 1e-5; each
    gradient tensor's norm within 1%); then each layout's step in float32
    and bfloat16 timed: device and host ms, and a trace's cuDNN layout
    transposes, aten and conv device ms."""
    x, y = train.tactile_image[:TRAIN_BATCH], train.depth_image[:TRAIN_BATCH]
    data = {False: (x, y), True: (x.permute(0, 2, 3, 1).contiguous(), y.permute(0, 2, 3, 1).contiguous())}
    mask = torch.ones(TRAIN_BATCH, dtype=torch.bool, device="cuda")
    out = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        opt = make_optimizer()
        steps = {cl: make_train_step(ucfg, opt, compute_dtype=dtype, masked=True, channels_last=cl)
                 for cl in (False, True)}
        state = create_train_state(ucfg, opt, generator=torch.Generator().manual_seed(2), device="cuda")
        state, _ = steps[False](state, x, y, mask)  # Adam's moments no longer zero
        rec = out[tag] = {}
        if dtype == torch.float32:
            parts = {cl: steps[cl].loss_and_grads(state, *data[cl], mask) for cl in (False, True)}
            new = {cl: steps[cl].apply_updates(state, *parts[cl])[0] for cl in (False, True)}
            ratios = [parts[True][2][k].double().norm().item() / max(g.double().norm().item(), 1e-30)
                      for k, g in parts[False][2].items()]
            off = {p: [k for k, v in getattr(new[False], p).items()
                       if not torch.allclose(getattr(new[True], p)[k], v, **DP_TOL)] for p in ("params", "batch_stats")}
            rec.update(loss_nchw=parts[False][0].item(), loss_nhwc=parts[True][0].item(),
                       grad_norm_ratio_range=[min(ratios), max(ratios)], tensors_off={p: len(v) for p, v in off.items()},
                       params_max_abs_diff=max((new[True].params[k] - v).abs().max().item()
                                               for k, v in new[False].params.items()))
            print(f"NHWC f32 train step vs NCHW: {rec}", flush=True)
            check(np.isclose(rec["loss_nhwc"], rec["loss_nchw"], **LOSS_TOL), f"NHWC f32 step loss: {rec}")
            check(not off["params"] and not off["batch_stats"], f"NHWC f32 step off the DP bar vs NCHW: {off}")
            check(0.99 <= min(ratios) and max(ratios) <= 1.01, f"NHWC f32 step gradient norm ratios: {rec}")
            del parts, new
        for cl in (False, True):
            run = lambda: steps[cl](state, *data[cl], mask)  # noqa: E731
            layout = "nhwc" if cl else "nchw"
            rec[f"{layout}_device_ms"] = device_ms(run, calls=5)
            rec[f"{layout}_host_ms"] = host_ms(run, reps=5, warmup=1)
            prof = device_profile(run, calls=3, op_keys=TRAIN_OP_KEYS, other=TRAIN_LIBRARY_OPS)
            rec[f"{layout}_device_profile"] = None if prof is None else {
                "busy_ms_per_step": prof[0], "idle_share": prof[1], "device_ops_per_step": prof[2],
                "device_ms_per_step": prof[4]}
            del run
        print(f"NHWC vs NCHW train step {tag}, batch {TRAIN_BATCH}: device {rec['nhwc_device_ms']:.3f} vs "
              f"{rec['nchw_device_ms']:.3f} ms, host {rec['nhwc_host_ms']:.3f} vs {rec['nchw_host_ms']:.3f} ms; "
              "transposes " + " vs ".join(
                  "not measured" if rec[f"{lo}_device_profile"] is None else
                  f"{rec[f'{lo}_device_profile']['device_ms_per_step']['cudnn layout transposes']:.3f} ms"
                  for lo in ("nhwc", "nchw")), flush=True)
        del state, steps
        torch.cuda.empty_cache()
    return out


def sphere_triangles(radius: float = 8.0, n_lat: int = 96, n_lon: int = 192) -> np.ndarray:
    """A UV sphere in mm as (T, 3, 3) float32 triangles (those at the poles
    have no area, so surface sampling never picks them)."""
    th = np.linspace(0.0, np.pi, n_lat + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)[None, :]
    v = radius * np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th) * np.ones_like(ph)], -1)
    a, b, c, d = v[:-1, :-1], v[1:, :-1], v[1:, 1:], v[:-1, 1:]
    return np.concatenate([np.stack([a, b, c], -2), np.stack([a, c, d], -2)]).reshape(-1, 3, 3).astype(np.float32)


def depth_bar(got, want):
    """(RMSE in mm, share of pixels off by more than 1e-4 mm) of two depth
    stacks; the bar the JAX package holds its two renderers to is RMSE <
    0.005 mm and a share below 1e-4."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(np.sqrt((diff ** 2).mean())), float((diff > 1e-4).mean())


def check_depth(d, tag):
    check(bool(np.isfinite(d).all()) and float(d.max()) <= 1e-6,
          f"{tag}: depth not finite and <= 1e-6: [{d.min()}, {d.max()}]")


def drive_meshgen(workdir):
    """Mesh->depth ground truth at full width on the card. For a ridged
    fixture plate and a sphere (mm, pc_scale 1): make_mesh_contact_object
    draws and renders 256 grasps (translations within 2 mm, any angle,
    widths for 0.3-1.5 mm of contact) from 1e5 surface points at 320x427,
    plane +y+z, 6 hole-fill steps; render_depth_batch renders its poses
    again, bit for bit; 16 of them, for both lr_flip values, are held
    against the CPU path and the host C++ renderer. Then the 256-pose
    render is timed: samples/s on the host clock with the copy back, and
    by device busy time; device ms of the scatter-min and the rest in that
    trace, and of the hole fill alone on the 256 poses' grids; the host
    time of the copy back alone; the pose chunk and peak memory. Returns
    the record."""
    spec = plane_spec("+y+z")
    kw = dict(spec=spec, image_size=FRAME, mm_per_pixel=12.0 / FRAME[0], fill_iters=6)
    meshes = {"ridged plate": fixtures.heightfield_plate_triangles(fixtures.ridged_height_fn()),
              "sphere": sphere_triangles()}
    out = {"points": MESH_POINTS, "poses": MESH_POSES, "image": FRAME,
           "pose_chunk": depth_render.POINTS_PER_CHUNK // MESH_POINTS}
    for seed, (name, tri) in enumerate(meshes.items()):
        path = os.path.join(workdir, f"mesh{seed}.stl")
        save_stl_binary(path, tri)
        t0 = time.perf_counter()
        obj = make_mesh_contact_object(np.random.RandomState(seed), path, MESH_POSES, pc_scale=1.0,
                                       image_size=FRAME, n_points=MESH_POINTS, max_depth_mm=MESH_MAX_DEPTH,
                                       device="cuda")
        obj_s = time.perf_counter() - t0
        # the object's cloud: its first draw seeds the surface sampling
        pts = sample_surface_points(tri, MESH_POINTS, seed=int(np.random.RandomState(seed).randint(2 ** 31)))
        poses, widths = obj["in_hand_pose"], obj["grasp_widths"]
        if seed == 0:  # the plate's grasps, for the parallel phase's DP renderer
            np.savez(os.path.join(workdir, "plate_render.npz"), pts=pts, poses=poses, widths=widths)

        def render(n=MESH_POSES, device="cuda", **k):
            return render_depth_batch(pts, poses[:n], widths[:n], device=device, **kw, **k)

        depth = render().cpu().numpy()
        check(depth.shape == (MESH_POSES, 2, *FRAME), f"meshgen {name}: shape {depth.shape}")
        check_depth(depth, f"meshgen {name}")
        check(float(depth.min()) < -0.3, f"meshgen {name}: no grasp presses into the mesh ({depth.min()})")
        check(np.array_equal(np.maximum(depth, np.float32(-MESH_MAX_DEPTH)), obj["depth_image"]),
              f"meshgen {name}: make_mesh_contact_object's depth is not render_depth_batch's on its poses")

        rec = out[name] = {"make_mesh_contact_object_s": obj_s,
                           "depth_range_mm": [float(depth.min()), float(depth.max())]}
        for lr_flip in (False, True):
            card = render(MESH_CHECKED, lr_flip=lr_flip).cpu().numpy()
            cpu = render(MESH_CHECKED, "cpu", lr_flip=lr_flip).numpy()
            native = render_depth_batch_native(pts, poses[:MESH_CHECKED], widths[:MESH_CHECKED],
                                               lr_flip=lr_flip, **kw)
            for ref_name, ref in (("card", card), ("cpu", cpu), ("native", native)):
                check_depth(ref, f"meshgen {name} {ref_name} lr_flip={lr_flip}")
            for ref_name, ref in (("cpu", cpu), ("native", native)):
                rmse, share = depth_bar(card, ref)
                rec[f"card_vs_{ref_name}_lr_flip_{lr_flip}"] = {"rmse_mm": rmse, "share_off": share}
                print(f"meshgen {name}, {MESH_CHECKED} poses, lr_flip={lr_flip}: card vs {ref_name} RMSE "
                      f"{rmse:.3e} mm, share of pixels off by > 1e-4 mm {share:.3e}", flush=True)
                check(rmse < 0.005 and share < 1e-4,
                      f"meshgen {name}: card vs {ref_name} (lr_flip={lr_flip}) RMSE {rmse}, share {share}")

        rec["host_ms"] = host_ms(lambda: render().cpu(), reps=5, warmup=1)
        rec["samples_per_s_host"] = 1e3 * MESH_POSES / rec["host_ms"]
        on_card = render()
        rec["copy_back_host_ms"] = host_ms(lambda: on_card.cpu(), reps=5, warmup=1)
        del on_card
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        render()
        torch.cuda.synchronize()
        rec["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["render_memory_gib"] = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
        grid, _ = depth_render._splat(cuda(pts), *(cuda(poses[:, i]) for i in range(3)), cuda(widths), spec,
                                      FRAME, kw["mm_per_pixel"], False)
        rec["hole_fill_device_ms_alone"] = device_ms(lambda: depth_render._fill_holes(grid, 6), calls=5)
        del grid
        prof = device_profile(render, calls=3, op_keys={"scatter-min": ("scatter",)}, other="rest")
        if prof is None:
            print(f"meshgen {name}: the trace holds no device events; device time not measured", flush=True)
            rec["device_profile"] = None
        else:
            busy, idle, ops, _, ms = prof
            rec["device_profile"] = {
                "busy_ms": busy, "idle_share": idle, "device_ops": ops,
                "samples_per_s_device": 1e3 * MESH_POSES / busy,
                "scatter_ms": ms["scatter-min"],
                "hole_fill_ms": rec["hole_fill_device_ms_alone"],
                "rest_ms": busy - ms["scatter-min"] - rec["hole_fill_device_ms_alone"],
            }
        dp = rec["device_profile"] or {}
        print(f"meshgen {name}: {MESH_POSES} poses x {MESH_POINTS} points at {FRAME[0]}x{FRAME[1]}, pose chunk "
              f"{out['pose_chunk']}: host {rec['host_ms']:.3f} ms with the copy back "
              f"({rec['samples_per_s_host']:.1f} samples/s); device busy {dp.get('busy_ms', float('nan')):.3f} ms "
              f"({dp.get('samples_per_s_device', float('nan')):.1f} samples/s), idle share "
              f"{dp.get('idle_share', float('nan')):.3f}, {dp.get('device_ops', float('nan')):.1f} device ops; the copy "
              f"back alone {rec['copy_back_host_ms']:.3f} ms; device "
              f"ms: scatter-min {dp.get('scatter_ms', float('nan')):.3f}, hole fill (alone) "
              f"{rec['hole_fill_device_ms_alone']:.3f}, rest {dp.get('rest_ms', float('nan')):.3f}; "
              f"max_memory_allocated {rec['max_memory_allocated_gib']:.2f} GiB "
              f"({rec['render_memory_gib']:.2f} for the render); make_mesh_contact_object {obj_s:.2f} s",
              flush=True)
    return out


def drive_cli_data_prep(workdir):
    """The data-prep and training commands on the card, through the CLI,
    on a small tree: write_synthetic_dataset_tree's 320x427 objects (8 dual
    frames a split and object) with fixture plates (meters) as their
    meshes; generate-depth with no gpu argument (cuda) on each split; train
    for 1 epoch at the flagship dims, bf16, on 48 finger samples; test on
    the weights it wrote. Each must return 0. Returns the record."""
    root = os.path.join(workdir, "data")
    names = ("plate_ridged", "plate_bumps")
    write_synthetic_dataset_tree(root, object_names=names, n_per_object=8, image_size=FRAME, seed=0)
    mesh_dir = os.path.join(workdir, "mesh")
    os.makedirs(mesh_dir)
    for name, height in zip(names, (fixtures.ridged_height_fn(), fixtures.bumps_height_fn())):
        save_stl_binary(os.path.join(mesh_dir, f"{name}.stl"), fixtures.heightfield_plate_triangles(height) / 1000.0)
    with open(os.path.join(root, "grasp_widths.txt"), "w") as f:
        f.write(f"{names[0]}: 12.0\n{names[1]}: 12.5\n")
    rec = {}
    t0 = time.perf_counter()
    for sub in ("train_data", "validation_data", "test_data"):
        rc = cli.main(["generate-depth", "--mesh_dir", mesh_dir, "--dataset_dir", os.path.join(root, sub),
                       "--grasp_widths_file", os.path.join(root, "grasp_widths.txt"),
                       "--image_size", *map(str, FRAME)])
        check(rc == 0, f"cli generate-depth {sub}: rc {rc}")
    rec["generate_depth_s"] = time.perf_counter() - t0
    depth = load_pt(os.path.join(root, "train_data", f"{names[0]}_train.pt"))["depth_image"]
    check(tuple(depth.shape) == (8, 2, *FRAME), f"cli generate-depth: depth {tuple(depth.shape)}")
    check_depth(depth.numpy(), "cli generate-depth")
    check(float(depth.min()) < -0.3, f"cli generate-depth: no contact ({depth.min()})")

    out_dir = os.path.join(workdir, "train_output")
    t0 = time.perf_counter()
    rc = cli.main(["train", "cli_flagship", "--data_path", root, "--output_dir", out_dir, "--use_difference_image",
                   "--bf16", "--max_epochs", "1"])
    rec["train_s"] = time.perf_counter() - t0
    check(rc == 0, f"cli train: rc {rc}")
    wdir = os.path.join(out_dir, "weights")
    check(os.path.exists(os.path.join(wdir, "cli_flagship.npz")), "cli train wrote no checkpoint")
    t0 = time.perf_counter()
    rc = cli.main(["test", "cli_flagship", "test_data", "--data_path", root, "--weights_dir", wdir,
                   "--output_dir", os.path.join(workdir, "test_output")])
    rec["test_s"] = time.perf_counter() - t0
    check(rc == 0, f"cli test: rc {rc}")
    print(f"cli on the card: generate-depth (3 splits) {rec['generate_depth_s']:.1f} s, train 1 epoch "
          f"{rec['train_s']:.1f} s, test {rec['test_s']:.1f} s; each rc 0", flush=True)
    return rec


CONVERGENCE_DUALS = (1000, 100, 100)  # train, val, test dual frames: 2,000 / 200 / 200 finger samples
CONVERGENCE_EPOCHS = 3  # 375 steps at batch 16
CONVERGENCE_FALL = 20  # val_loss_init over the best val loss, at least
INT8_GATE_MM = 0.05  # delta_mm and int8 vs bf16 RMSE (tests/test_quantize.py:113)


def load_convergence_script():
    """scripts/train_convergence_torch.py, by path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "train_convergence_torch.py")
    spec = importlib.util.spec_from_file_location("train_convergence_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drive_convergence(workdir):
    """The convergence recipe cut down (scripts/train_convergence_torch.py):
    its corpus (seeds 100, 200, 300) at 160x213, its config (flagship dims,
    batch 16, Adam 1e-3 wd 1e-6, EMA 0.995), bf16, 3 epochs. The best val
    loss must fall CONVERGENCE_FALL-fold from val_loss_init. Then the trained
    model is served: the best-val checkpoint through Predictor.from_checkpoint
    (bf16) on every held-out test dual frame, each object's frames with its
    own base frame, one fused_preprocess_dual launch a call; its depth RMSE
    against the ground truth must beat the best constant map's (the ground
    truth's mean). Its QuantizedPredictor, calibrated on 4 train dual frames,
    serves the same frames with 17 conv2d_int8 launches a call, within the
    int8 gate of the bf16 output. Returns the record and the launches."""
    conv = load_convergence_script()
    t0 = phase_t0 = time.perf_counter()
    train_objs, val_objs, test_objs = (conv.make_corpus(n, seed)
                                       for n, seed in zip(CONVERGENCE_DUALS, conv.SPLIT_SEEDS))
    train, val, test = conv.bake_splits(train_objs, val_objs, test_objs)
    rec = {"corpus_bake_s": time.perf_counter() - t0, "finger_samples": [len(train), len(val), len(test)]}
    cfg = conv.make_config("convergence")
    tr = Trainer(cfg, train, val, test, output_dir=workdir, compute_dtype=torch.bfloat16, seed=0,
                 log_fn=lambda m: None, enable_plots=False)
    rec["val_loss_init"] = tr._eval_epoch(val, seed=1)
    t0 = time.perf_counter()
    hist = tr.fit(max_epochs=CONVERGENCE_EPOCHS)
    rec["fit_s"], rec["history"] = time.perf_counter() - t0, hist
    rec["val_fall"] = rec["val_loss_init"] / min(hist["validation_loss"])
    print(f"convergence: corpus and bake {rec['corpus_bake_s']:.1f} s ({rec['finger_samples']} finger samples at "
          f"{conv.IMAGE_SIZE}); val_loss_init {rec['val_loss_init']:.6f}; fit {CONVERGENCE_EPOCHS} epochs bf16 "
          f"{rec['fit_s']:.1f} s, history {hist}; best val loss fell {rec['val_fall']:.1f}x "
          f"(at least {CONVERGENCE_FALL}x)", flush=True)
    check(all(np.isfinite(v) for vs in hist.values() for v in vs), f"convergence history {hist}")
    check(rec["val_fall"] >= CONVERGENCE_FALL, f"convergence: val loss fell {rec['val_fall']:.2f}x")

    reset_launches()
    pred = Predictor.from_checkpoint(tr.weights_dir, compute_dtype=torch.bfloat16)
    size = conv.IMAGE_SIZE
    frames = [torch.from_numpy(o["tactile_image"]).cuda() for o in test_objs]
    bases = [torch.from_numpy(o["base_tactile_image"][0]).cuda() for o in test_objs]
    truth = torch.cat([torch.from_numpy(o["depth_image"]) for o in test_objs]).cuda()
    served = []
    for f, b in zip(frames, bases):
        before = fused_preprocess_dual.launches
        served.append(pred.predict_dual_frames(f, b, size))
        check(fused_preprocess_dual.launches == before + 1, "convergence: a bf16 serving call's launches")
    served = torch.cat(served).float()
    check(served.shape == truth.shape and bool(torch.isfinite(served).all()),
          f"convergence: served {tuple(served.shape)} against truth {tuple(truth.shape)}")
    rec["served_rmse_mm"] = (served - truth).pow(2).mean().sqrt().item()
    rec["constant_rmse_mm"] = (truth - truth.mean()).pow(2).mean().sqrt().item()
    rec["served_over_constant"] = rec["served_rmse_mm"] / rec["constant_rmse_mm"]
    print(f"convergence: best-val checkpoint served bf16 on {truth.shape[0]} test dual frames: depth RMSE "
          f"{rec['served_rmse_mm']:.4f} mm against the best constant map's {rec['constant_rmse_mm']:.4f} mm "
          f"(ratio {rec['served_over_constant']:.3f})", flush=True)
    check(rec["served_over_constant"] < 1, "convergence: the trained model serves no better than a constant map")

    calib = train_objs[0]
    qpred = pred.quantize(calib["tactile_image"][:4], calib["base_tactile_image"][0])
    rec["int8_delta_mm"] = qpred.delta_mm
    q_out = []
    for f, b in zip(frames, bases):
        before = fused_preprocess_dual.launches, conv2d_int8.launches
        q_out.append(qpred.predict_dual_frames(f, b, size))
        rose = fused_preprocess_dual.launches - before[0], conv2d_int8.launches - before[1]
        check(rose == (1, 17), f"convergence: an int8 serving call's launches rose by {rose}")
    q_out = torch.cat(q_out).float()
    rec["int8_vs_bf16_rmse_mm"] = (q_out - served).pow(2).mean().sqrt().item()
    rec["int8_rmse_mm"] = (q_out - truth).pow(2).mean().sqrt().item()
    launches = read_launches()
    rec["phase_s"] = time.perf_counter() - phase_t0
    print(f"convergence: int8 of the checkpoint (4 calibration dual frames): delta_mm {rec['int8_delta_mm']:.4e}, "
          f"vs bf16 RMSE {rec['int8_vs_bf16_rmse_mm']:.4e} mm, vs truth {rec['int8_rmse_mm']:.4f} mm; "
          f"launches {launches}; the phase {rec['phase_s']:.1f} s", flush=True)
    check(rec["int8_delta_mm"] < INT8_GATE_MM and rec["int8_vs_bf16_rmse_mm"] < INT8_GATE_MM,
          f"convergence int8: delta_mm {rec['int8_delta_mm']}, vs bf16 RMSE {rec['int8_vs_bf16_rmse_mm']} mm")
    return rec, {"convergence": launches}


# ---------------------------------------------------------------------------
# parallel: data parallelism over torch.distributed ranks
# ---------------------------------------------------------------------------

PARALLEL_WORLD = 2  # gloo ranks that share cuda:0
PARALLEL_N = 64  # dual frames of DP serving, over all ranks
PARALLEL_SEED = 8  # the serving frames' generator, the same on every rank
PARALLEL_TIMEOUT_S = 300  # a rank run, start to end: joining, every collective and the checks
DP_TOL = dict(rtol=1e-3, atol=1e-5)  # parameters and running statistics (tests/test_train_steps.py:228-240)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def launch(argvs, timeout, workdir, tag):
    """Start one process per argv, their output in workdir/<tag>_<i>.log,
    and wait for all. The first to fail, or the deadline, kills the rest:
    a dead rank leaves its peers blocked in a collective. Fails unless
    every one returns 0; returns the logs."""
    paths = [os.path.join(workdir, f"{tag}_{i}.log") for i in range(len(argvs))]
    files = [open(p, "w") for p in paths]
    procs = [subprocess.Popen(a, stdout=f, stderr=subprocess.STDOUT) for a, f in zip(argvs, files)]
    deadline = time.monotonic() + timeout
    try:
        while (any(p.poll() is None for p in procs) and not any(p.returncode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    logs = []
    for path in paths:
        with open(path) as f:
            logs.append(f.read())
    rcs = [p.returncode for p in procs]
    if any(rcs):
        fail(f"{tag}: processes returned {rcs} (killed at the {timeout} s deadline or after a peer failed):\n"
             + "\n".join(f"--- {tag} {i}\n{log[-3000:]}" for i, log in enumerate(logs)))
    return logs


def parallel_serving_frames(device):
    g = torch.Generator(device=device).manual_seed(PARALLEL_SEED)
    frames = torch.rand((PARALLEL_N, 6, *FRAME), generator=g, device=device) * 255.0
    return frames, torch.rand((6, *FRAME), generator=g, device=device) * 255.0


def dp_step_check(mesh, ucfg, x, y, dtype, tag):
    """One DP train step on this rank's rows of the global batch (x, y)
    against TrainStep on the whole batch, from the same state: seeded, then
    one TrainStep on the batch (Adam's moments no longer zero), replicated
    from rank 0. Every rank gathers the ranks' new parameters, which must be
    equal bit for bit. Rank 0 holds, for float32: the loss (rtol 1e-4 /
    atol 1e-6), the new parameters and running statistics (rtol 1e-3 / atol
    1e-5), and each gradient tensor's norm to the single step's within 1% (a
    world size off is 100% or 50%); for bfloat16: a finite loss within rtol
    1e-2. Returns (record, a call of the DP step)."""
    opt = make_optimizer()
    mask = torch.ones(len(x), dtype=torch.bool, device=mesh.device)
    single = make_train_step(ucfg, opt, compute_dtype=dtype, masked=True)
    state = create_train_state(ucfg, opt, generator=torch.Generator().manual_seed(2), device=mesh.device)
    state = parallel.replicate(mesh, single(state, x, y, mask)[0])
    dp = parallel.make_dp_train_step(ucfg, opt, mesh, compute_dtype=dtype, masked=True)
    rows = mesh.rows(len(x))
    args = (x[rows], y[rows], mask[rows])
    new, loss = dp(state, *args)
    # every rank joins the DP gradient's collectives; rank 0 compares
    dp_grads = dp.loss_and_grads(state, *args)[2] if dtype == torch.float32 else None
    flat = torch.cat([v.reshape(-1) for v in (*new.params.values(), *new.batch_stats.values())])
    gathered = parallel.gather_rows(mesh, flat[None])
    rec = {"loss": loss.item(), "ranks_bit_equal": all(torch.equal(gathered[0], r) for r in gathered[1:])}
    del gathered, flat
    check(rec["ranks_bit_equal"], f"{tag}: the ranks' new states differ")
    if mesh.rank == 0:
        want, want_loss = single(state, x, y, mask)
        rec["single_loss"] = want_loss.item()
        if dtype == torch.float32:
            grads = single.loss_and_grads(state, x, y, mask)[2]
            errs = [rel_l2(dp_grads[k], g) for k, g in grads.items()]
            ratios = [dp_grads[k].double().norm().item() / max(g.double().norm().item(), 1e-30)
                      for k, g in grads.items()]
            del grads
            off = {}
            for part in ("params", "batch_stats"):
                got, ref = getattr(new, part), getattr(want, part)
                off[part] = [k for k in ref if not torch.allclose(got[k], ref[k], **DP_TOL)]
                rec[f"{part}_max_abs_diff"] = max((got[k] - ref[k]).abs().max().item() for k in ref)
            rec.update(grad_rel_l2_median=float(np.median(errs)), grad_rel_l2_max=max(errs),
                       grad_norm_ratio_range=[min(ratios), max(ratios)],
                       tensors_off={k: len(v) for k, v in off.items()},
                       elements_off=sum(int((~torch.isclose(getattr(new, p)[k], getattr(want, p)[k], **DP_TOL)).sum())
                                        for p in off for k in off[p]))
            print(f"{tag}: {rec}", flush=True)
            check(np.isclose(rec["loss"], rec["single_loss"], **LOSS_TOL),
                  f"{tag}: DP loss {rec['loss']} vs TrainStep {rec['single_loss']}")
            check(not off["params"] and not off["batch_stats"], f"{tag}: off the DP bar vs TrainStep: {off}")
            check(0.99 <= min(ratios) and max(ratios) <= 1.01, f"{tag}: gradient norm ratios {rec['grad_norm_ratio_range']}")
        else:
            print(f"{tag}: {rec}", flush=True)
            check(np.isfinite(rec["loss"]) and np.isclose(rec["loss"], rec["single_loss"], rtol=1e-2),
                  f"{tag}: DP loss {rec['loss']} vs TrainStep {rec['single_loss']}")
    del dp_grads
    return rec, lambda: dp(state, *args)


def dp_serving_check(mesh, cfg, sd, q, tag):
    """DP f32, bf16 and int8 serving of PARALLEL_N dual frames, this rank's
    rows, gathered in rank order. The DP calls run with the launch counts
    set to 0 just before and read just after: each rank launches
    fused_preprocess_dual once a call, conv2d_int8 17 times on its fast
    mainloop. Each rank then holds its rows against the kernels' plain
    versions at the rank's own shapes: the f32 call against the composed
    front end (fused_predict_dual with use_kernel=False) within 1e-4 mm, as
    the main path does, and the int8 call against the same model with every
    quantized conv on its plain twin, bit for bit. Rank 0 holds the
    gathered int8 depth to QuantizedPredictor on the whole batch bit for
    bit, and the gathered bf16 depth to Predictor(bf16) within the 0.05 mm
    RMSE gate. Returns (record, launches)."""
    frames, base = parallel_serving_frames(mesh.device)
    ucfg = cfg.unet_config()
    params, stats = parallel.replicate(mesh, unet_module.split_state_dict(sd))
    q = parallel.replicate(mesh, q)
    dp32 = parallel.make_dp_fused_predictor(cfg, ucfg, mesh, FRAME)
    dp16 = parallel.make_dp_fused_predictor(cfg, ucfg, mesh, FRAME, compute_dtype=torch.bfloat16)
    dq = parallel.make_dp_fused_predictor_int8(cfg, mesh, FRAME, compute_dtype=torch.bfloat16)
    local = frames[mesh.rows(PARALLEL_N)]
    reset_launches()
    out32, out16, out8 = dp32(params, stats, local, base), dp16(params, stats, local, base), dq(q, local, base)
    torch.cuda.synchronize()
    launches = read_launches()
    sites = len(quantize_module._quantized_sites(q.cfg))
    check(launches["fused_preprocess_dual"] == 3 and launches["conv2d_int8"] == sites
          and launches["conv2d_int8_by_path"][CONV_FAST_PATH] == sites, f"{tag} serving launches {launches}")
    # this rank's rows through the plain versions, at the shapes the DP path gave the kernels
    before = fused_preprocess_dual.launches
    with torch.inference_mode():
        plain32 = fused_predict_dual(cfg, lambda x: unet_module.unet_apply(ucfg, params, stats, x)[0],
                                     local, base, FRAME, use_kernel=False)
    check(fused_preprocess_dual.launches == before, f"{tag}: the composed front end launched the kernel")
    with plain_int8_convs():
        plain8 = dq(q, local, base)
    errs = torch.stack([(out32 - plain32).abs().max(), (out8 - plain8).abs().max()]).reshape(1, 2)
    errs = parallel.gather_rows(mesh, errs).tolist()
    rec = {"rows_per_rank": len(local), "f32_kernel_vs_composed_front_end_max_abs_diff_mm": [e[0] for e in errs],
           "int8_kernel_vs_plain_twins_max_abs_diff_mm": [e[1] for e in errs],
           "bf16_call_ms": host_ms(lambda: dp16(params, stats, local, base), reps=10, warmup=2),
           "int8_call_ms": host_ms(lambda: dq(q, local, base), reps=10, warmup=2)}
    del plain32, plain8
    check(max(e[0] for e in errs) < 1e-4, f"{tag} f32 serving, kernel vs composed front end: {rec}")
    check(max(e[1] for e in errs) == 0, f"{tag} int8 serving, kernel vs plain twins not bit for bit: {rec}")
    got16, got8 = parallel.gather_rows(mesh, out16), parallel.gather_rows(mesh, out8)
    if mesh.rank == 0:
        want16 = Predictor(cfg, sd, compute_dtype=torch.bfloat16, device=mesh.device).predict_dual_frames(
            frames, base, FRAME)
        want8 = QuantizedPredictor(cfg, q, compute_dtype=torch.bfloat16, device=mesh.device).predict_dual_frames(
            frames, base, FRAME)
        rec.update(bf16_rmse_mm=(got16 - want16).pow(2).mean().sqrt().item(),
                   bf16_max_abs_diff_mm=(got16 - want16).abs().max().item(),
                   int8_max_abs_diff_mm=(got8 - want8).abs().max().item(), int8_bit_for_bit=torch.equal(got8, want8))
        print(f"{tag} serving: {rec}; launches {launches}", flush=True)
        check(tuple(got16.shape) == tuple(got8.shape) == (PARALLEL_N, 2, *FRAME), f"{tag} serving shapes")
        check(bool(torch.isfinite(got16).all() and torch.isfinite(got8).all()), f"{tag} serving: non-finite depth")
        check(rec["bf16_rmse_mm"] < 0.05, f"{tag} bf16 serving vs Predictor on the whole batch: {rec}")
        check(rec["int8_bit_for_bit"], f"{tag} int8 serving vs QuantizedPredictor on the whole batch: {rec}")
    return rec, launches


def dp_render_check(mesh, render_npz, tag):
    """make_dp_renderer over the meshgen plate's poses, this rank's rows,
    gathered, against render_depth_batch of them all on rank 0 at the
    meshgen bar (RMSE < 0.005 mm, < 1e-4 of pixels off by > 1e-4 mm)."""
    with np.load(render_npz) as z:
        pts, poses, widths = z["pts"], z["poses"], z["widths"]
    kw = dict(spec=plane_spec("+y+z"), image_size=FRAME, mm_per_pixel=12.0 / FRAME[0], fill_iters=6)
    render = parallel.make_dp_renderer(mesh, **kw)
    rows = mesh.rows(len(poses))
    run = lambda: render(pts, poses[rows], widths[rows])  # noqa: E731
    got = parallel.gather_rows(mesh, run())
    rec = {"poses_per_rank": rows.stop - rows.start, "render_ms": host_ms(run, reps=5, warmup=1)}
    if mesh.rank == 0:
        want = render_depth_batch(pts, poses, widths, device=mesh.device, **kw)
        rec["rmse_mm"], rec["share_off"] = depth_bar(got.cpu().numpy(), want.cpu().numpy())
        rec["bit_for_bit"] = torch.equal(got, want)
        print(f"{tag} renderer: {rec}", flush=True)
        check(rec["rmse_mm"] < 0.005 and rec["share_off"] < 1e-4, f"{tag} DP renderer vs render_depth_batch {rec}")
    return rec


SPATIAL_SEED = 9  # the spatial phase's dual frame, the same on every rank


def spatial_check(mesh, cfg, sd, q, tag):
    """Height-sharded serving of one flagship dual frame
    (parallel.make_spatial_predictor[_int8]), this rank's band of rows, in
    f32, bf16 and int8, run with the launch counts set to 0 just before and
    read just after: each rank launches fused_preprocess_dual once a call,
    on its band of frame rows, and conv2d_int8 17 times on its haloed int8
    bands. Each rank then holds its band against the kernels' plain
    versions at the band's shapes: the f32 call against the same predictor
    with the composed front end (use_kernel=False) within 1e-4 mm, the int8
    call against the same model with every quantized conv on its plain
    twin, bit for bit. Gathered, rank 0 holds f32 to Predictor within rtol
    1e-4 / atol 1e-5 mm (and, at one rank, to make_dp_fused_predictor on the
    same frame within 1e-5 mm), int8 to QuantizedPredictor within 1e-4 mm,
    and bf16 to Predictor(bf16) within the 0.05 mm RMSE gate. Returns
    (record, launches)."""
    g = torch.Generator(device=mesh.device).manual_seed(SPATIAL_SEED)
    frame = torch.rand((1, 6, *FRAME), generator=g, device=mesh.device) * 255.0
    base = torch.rand((6, *FRAME), generator=g, device=mesh.device) * 255.0
    ucfg = cfg.unet_config()
    params, stats = parallel.replicate(mesh, unet_module.split_state_dict(sd))
    sp32 = parallel.make_spatial_predictor(cfg, ucfg, mesh, FRAME)
    sp16 = parallel.make_spatial_predictor(cfg, ucfg, mesh, FRAME, compute_dtype=torch.bfloat16)
    sq = parallel.make_spatial_predictor_int8(cfg, mesh, FRAME, compute_dtype=torch.bfloat16)
    band, base_band = parallel.shard_height(mesh, sp32.plan, frame, base)
    reset_launches()
    out32, out16, out8 = sp32(params, stats, band, base_band), sp16(params, stats, band, base_band), sq(q, band, base_band)
    torch.cuda.synchronize()
    launches = read_launches()
    exchanges = {"f32": sp32.halo.exchanges, "int8": sq.halo.exchanges}
    sites = len(quantize_module._quantized_sites(q.cfg))
    check(launches["fused_preprocess_dual"] == 3 and launches["conv2d_int8"] == sites, f"{tag} spatial launches {launches}")
    composed = parallel.make_spatial_predictor(cfg, ucfg, mesh, FRAME, use_kernel=False)
    before = fused_preprocess_dual.launches
    plain32 = composed(params, stats, band, base_band)
    check(fused_preprocess_dual.launches == before, f"{tag}: the composed spatial front end launched the kernel")
    with plain_int8_convs():
        plain8 = sq(q, band, base_band)
    errs = torch.stack([(out32 - plain32).abs().max(), (out8 - plain8).abs().max()]).reshape(1, 2)
    errs = parallel.gather_rows(mesh, errs).tolist()
    rec = {"net_rows": sp32.plan.net_rows, "exchanges_a_call": exchanges,
           "f32_kernel_vs_composed_front_end_max_abs_diff_mm": [e[0] for e in errs],
           "int8_kernel_vs_plain_twins_max_abs_diff_mm": [e[1] for e in errs]}
    for name, fn in (("f32", lambda: sp32(params, stats, band, base_band)),
                     ("bf16", lambda: sp16(params, stats, band, base_band)), ("int8", lambda: sq(q, band, base_band))):
        rec[f"{name}_call_ms"] = host_ms(fn, reps=10, warmup=2)
    del plain32, plain8
    check(max(e[0] for e in errs) < 1e-4, f"{tag} spatial f32, kernel vs composed front end: {rec}")
    check(max(e[1] for e in errs) == 0, f"{tag} spatial int8, kernel vs plain twins not bit for bit: {rec}")
    got32, got16, got8 = (parallel.gather_height(mesh, o) for o in (out32, out16, out8))
    if mesh.rank == 0:
        want32 = Predictor(cfg, sd, device=mesh.device).predict_dual_frames(frame, base, FRAME)
        want16 = Predictor(cfg, sd, compute_dtype=torch.bfloat16, device=mesh.device).predict_dual_frames(
            frame, base, FRAME)
        want8 = QuantizedPredictor(cfg, q, compute_dtype=torch.bfloat16, device=mesh.device).predict_dual_frames(
            frame, base, FRAME)
        rec.update(f32_max_abs_diff_mm=(got32 - want32).abs().max().item(),
                   bf16_rmse_mm=(got16 - want16).pow(2).mean().sqrt().item(),
                   bf16_max_abs_diff_mm=(got16 - want16).abs().max().item(),
                   int8_max_abs_diff_mm=(got8 - want8).abs().max().item())
        if mesh.size == 1:
            dp = parallel.make_dp_fused_predictor(cfg, ucfg, mesh, FRAME)(params, stats, frame, base)
            rec["f32_vs_dp_max_abs_diff_mm"] = (got32 - dp).abs().max().item()
            check(rec["f32_vs_dp_max_abs_diff_mm"] < 1e-5, f"{tag} spatial f32 vs make_dp_fused_predictor: {rec}")
        print(f"{tag} spatial: {rec}; launches {launches}", flush=True)
        check(all(tuple(o.shape) == (1, 2, *FRAME) for o in (got32, got16, got8)), f"{tag} spatial shapes")
        check(all(bool(torch.isfinite(o).all()) for o in (got32, got16, got8)), f"{tag} spatial: non-finite depth")
        check(torch.allclose(got32, want32, rtol=1e-4, atol=1e-5), f"{tag} spatial f32 vs Predictor: {rec}")
        check(rec["int8_max_abs_diff_mm"] < 1e-4, f"{tag} spatial int8 vs QuantizedPredictor: {rec}")
        check(rec["bf16_rmse_mm"] < 0.05, f"{tag} spatial bf16 vs Predictor(bf16): {rec}")
    return rec, launches


def parallel_rank_main(rank: int, workdir: str) -> None:
    """One of PARALLEL_WORLD gloo ranks on cuda:0, named with the backend
    (the same-card check of the mesh passes only so): the float32 DP step at
    the global batch of parallel_inputs.npz, bf16 and int8 DP serving, the
    DP renderer. Writes workdir/rank<rank>.json."""
    for name in ("fused_preprocess_dual", "conv2d_int8"):
        build.load_library(name)  # built by the parent
    parallel.initialize(f"file://{os.path.join(workdir, 'gloo_store')}", PARALLEL_WORLD, rank, backend="gloo",
                        timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    mesh = parallel.make_mesh(PARALLEL_WORLD, device="cuda:0", backend="gloo")
    cfg = flagship_config()
    with np.load(os.path.join(workdir, "parallel_inputs.npz")) as z:
        x, y = (torch.from_numpy(z[k]).to(mesh.device) for k in ("x", "y"))
    tag = f"gloo world {PARALLEL_WORLD}"
    step, run = dp_step_check(mesh, cfg.unet_config(), x, y, torch.float32, f"{tag} f32 DP step")
    step["host_ms"] = host_ms(run, reps=5, warmup=1)
    del run
    torch.cuda.empty_cache()
    q = QuantizedPredictor.from_checkpoint(os.path.join(workdir, "q"), device=mesh.device).q
    serving, launches = dp_serving_check(mesh, cfg, seeded_state_dict(cfg.unet_config(), seed=0), q, tag)
    render = dp_render_check(mesh, os.path.join(workdir, "plate_render.npz"), tag)
    spatial, spatial_launches = spatial_check(mesh, cfg, seeded_state_dict(cfg.unet_config(), seed=0), q, tag)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"step_f32": step, "serving": serving, "render": render, "spatial": spatial, "launches": launches,
                   "spatial_launches": spatial_launches}, f)
    torch.distributed.destroy_process_group()


def drive_parallel(cfg, sd, qpred, train, workdir):
    """The parallel phase. (1) NCCL, world 1, on cuda:0, in this process:
    the DP step at the flagship dims and global batch TRAIN_BATCH in f32 and
    bf16 against TrainStep, timed against it (device and host; the NCCL
    kernels' share of the DP step's device time), and DP bf16 and int8
    serving. (2) gloo, world 2, both ranks on cuda:0 (parallel_rank_main):
    the f32 step, serving, the DP renderer; they check correctness and show
    what gloo's host staging costs, no scaling. (3) The CLI's train
    --data_parallel for one bf16 epoch, 2 processes on the card over gloo
    through --coordinator_address: rc 0 each, a checkpoint from rank 0
    alone. Returns (record, launches by path)."""
    ucfg = cfg.unet_config()
    x, y = train.tactile_image[:TRAIN_BATCH], train.depth_image[:TRAIN_BATCH]
    out, launches = {}, {}

    parallel.initialize(f"file://{os.path.join(workdir, 'nccl_store')}", 1, 0,
                        timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    try:
        mesh = parallel.make_mesh(1)
        tag = f"NCCL world 1 ({torch.distributed.get_backend()})"
        rec = out["nccl_world1"] = {"backend": torch.distributed.get_backend(), "device": str(mesh.device)}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            step, run = dp_step_check(mesh, ucfg, x, y, dtype, f"{tag} {name} DP step")
            opt = make_optimizer()
            single = make_train_step(ucfg, opt, compute_dtype=dtype, masked=True)
            state = create_train_state(ucfg, opt, generator=torch.Generator().manual_seed(2), device=mesh.device)
            mask = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=mesh.device)
            single_run = lambda: single(state, x, y, mask)  # noqa: E731
            step.update(dp_device_ms=device_ms(run, calls=5), single_device_ms=device_ms(single_run, calls=5),
                        dp_host_ms=host_ms(run, reps=5, warmup=1), single_host_ms=host_ms(single_run, reps=5, warmup=1))
            prof = device_profile(run, calls=3, op_keys={"nccl": ("nccl",)}, other="rest")
            if prof is None:
                step["nccl_device_ms"] = step["nccl_share"] = None
            else:
                step["nccl_device_ms"], step["nccl_share"] = prof[4]["nccl"], prof[3]["nccl"]
            print(f"{tag} {name} DP step: device {step['dp_device_ms']:.3f} ms vs TrainStep "
                  f"{step['single_device_ms']:.3f} ms; host {step['dp_host_ms']:.3f} vs {step['single_host_ms']:.3f} "
                  f"ms; NCCL kernels {step['nccl_device_ms']} ms a step, share {step['nccl_share']}", flush=True)
            rec[f"step_{name}"] = step
            del run, single_run, state
            torch.cuda.empty_cache()
        rec["serving"], launches["parallel_nccl_world1"] = dp_serving_check(mesh, cfg, sd, qpred.q, tag)
        rec["spatial"], launches["spatial_nccl_world1"] = spatial_check(mesh, cfg, sd, parallel.replicate(mesh, qpred.q),
                                                                        tag)
    finally:
        torch.distributed.destroy_process_group()

    # (2) two gloo ranks on the one card
    np.savez(os.path.join(workdir, "parallel_inputs.npz"), x=x.cpu().numpy(), y=y.cpu().numpy())
    qpred.save(os.path.join(workdir, "q"))
    t0 = time.perf_counter()
    logs = launch([[sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r), workdir]
                   for r in range(PARALLEL_WORLD)], PARALLEL_TIMEOUT_S, workdir, "gloo_rank")
    ranks = []
    for r in range(PARALLEL_WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(logs[0][-2500:], flush=True)
    out["gloo_world2_same_card"] = {"wall_s": time.perf_counter() - t0, "rank0": ranks[0],
                                    "other_ranks": [{k: r[k] for k in ("step_f32", "serving", "render", "spatial")}
                                                    for r in ranks[1:]]}
    launches["parallel_gloo_world2"] = {k: sum(r["launches"][k] for r in ranks)
                                        for k in ("fused_preprocess_dual", "conv2d_int8")}
    launches["spatial_gloo_world2"] = {k: sum(r["spatial_launches"][k] for r in ranks)
                                       for k in ("fused_preprocess_dual", "conv2d_int8")}
    check(all(r["launches"]["fused_preprocess_dual"] == 3 and r["launches"]["conv2d_int8"] > 0 for r in ranks),
          f"gloo ranks' launches {[r['launches'] for r in ranks]}")

    # (3) the CLI, 2 processes on the card over gloo, each its own output directory
    root = os.path.join(workdir, "cli_dp_data")
    write_synthetic_dataset_tree(root, object_names=("plate_ridged", "plate_bumps"), n_per_object=8,
                                 image_size=FRAME, seed=1)
    outs = [os.path.join(workdir, f"cli_dp_out{r}") for r in range(PARALLEL_WORLD)]
    t0 = time.perf_counter()
    logs = launch([[sys.executable, "-m", "gelslim_depth_tpu_torch", "train", "cli_dp", "0", "--data_parallel",
                    "--coordinator_address", f"file://{os.path.join(workdir, 'cli_store')}",
                    "--num_processes", str(PARALLEL_WORLD), "--process_id", str(r), "--dist_backend", "gloo",
                    "--data_path", root, "--output_dir", outs[r], "--use_difference_image", "--bf16",
                    "--max_epochs", "1"] for r in range(PARALLEL_WORLD)], PARALLEL_TIMEOUT_S, workdir, "cli_dp")
    cli_s = time.perf_counter() - t0
    lines = [[ln for ln in log.splitlines() if ln.startswith("Train loss")] for log in logs]
    check(all(len(ls) == 1 and ls == lines[0] for ls in lines), f"cli train --data_parallel: epoch lines {lines}")
    check(os.path.exists(os.path.join(outs[0], "weights", "cli_dp.npz")), "cli train --data_parallel: rank 0 wrote no checkpoint")
    check(not any(os.path.exists(o) for o in outs[1:]), "cli train --data_parallel: a rank other than 0 wrote files")
    out["cli_train_data_parallel"] = {"processes": PARALLEL_WORLD, "wall_s": cli_s, "epoch_line": lines[0][0]}
    print(f"cli train --data_parallel (2 processes on cuda:0, gloo, 1 bf16 epoch): rc 0 each in {cli_s:.1f} s; "
          f"{lines[0][0]}; checkpoint from rank 0 alone", flush=True)
    return out, launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    if sys.argv[1:2] == ["--parallel-rank"]:  # one rank of the parallel phase, started by drive_parallel
        parallel_rank_main(int(sys.argv[2]), sys.argv[3])
        return
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

    train_cfg = GelslimConfig(CNN_dimensions=cfg.CNN_dimensions, batch_size=TRAIN_BATCH, weights_name="trained",
                              image_normalization_method="0_255_to_0_1", norm_scale=0.9, use_difference_image=True)
    ucfg = train_cfg.unet_config()
    train, val, test = training_sets()

    # every profiler trace before the training checks: each kernel a process
    # loads adds to what the profiler must follow, and after the parity
    # steps (float64, tanh, TF32 controls) a trace once held no device events
    timings, e2e = measure(pred16, qpred, frames64, base, peaks)
    sites = measure_conv_sites(peaks, g)
    entry_launches = drive_entry()
    engine, engine_launches = drive_engine(pred16, qpred, frames64, base, e2e)
    exported, export_launches = drive_export(cfg, sd, pred16, qpred, frames64, base)
    bilinear, bilinear_launches = drive_bilinear(cfg, sd, frames64, base)
    with tempfile.TemporaryDirectory() as workdir:
        reset_launches()
        meshgen = drive_meshgen(workdir)
        meshgen_launches = read_launches()
        timing = measure_training(ucfg, train, peaks)
        nhwc = check_nhwc(ucfg, train)
        parallel_run, parallel_launches = drive_parallel(cfg, sd, qpred, train, workdir)

    training = {"parity": check_train_step_parity(ucfg, train), "bf16_losses": check_bf16_learning(ucfg, train)}
    training["fit"], train_launches = drive_training(train_cfg, train, val, test, base)
    training["timing"] = timing
    training["nhwc"] = nhwc
    with tempfile.TemporaryDirectory() as workdir:
        reset_launches()
        cli_run = drive_cli_data_prep(workdir)
        cli_launches = read_launches()
    with tempfile.TemporaryDirectory() as workdir:
        convergence, convergence_launches = drive_convergence(workdir)
    # every path's launches, each counted from 0 just before the path ran
    path_launches = {"main": {"fused_preprocess_dual": launches}, "int8": int8_launches, "entry": entry_launches,
                     "engine": engine_launches, "export": export_launches, "meshgen": meshgen_launches,
                     "bilinear": bilinear_launches, **parallel_launches, **train_launches,
                     "cli_data_prep": cli_launches, **convergence_launches}
    t = timings[64]
    sums = {k: sum(v[k] for v in sites.values()) for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms")}
    kernels = [{
        "name": "fused_preprocess_dual",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(v.get("fused_preprocess_dual", 0) for v in path_launches.values()),
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
        "launches": sum(v.get("conv2d_int8", 0) for v in path_launches.values()),
        "max_abs_err": conv_err,
        "ms": sums["ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": "operations" if sums["ops_ms"] >= sums["bytes_ms"] else "bytes",
        "library_ms": sums["library_ms"],
        "sites": list(sites),
    }]
    print(json.dumps({"end_to_end": e2e, "kernel_N1": timings[1], "conv2d_int8_sites_N64": sites,
                      "launches_by_path": path_launches}))
    print(json.dumps({"engine": engine, "export": exported, "bilinear": bilinear}))
    print(json.dumps({"training": training}))
    print(json.dumps({"meshgen": meshgen, "cli_data_prep": cli_run}))
    print(json.dumps({"parallel": parallel_run}))
    print(json.dumps({"convergence": convergence}))
    print(json.dumps({"kernels": kernels}))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
