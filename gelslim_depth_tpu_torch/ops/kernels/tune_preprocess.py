"""Sweep the fused preprocess kernel's launch shape on one CUDA card.

    python3 -m gelslim_depth_tpu_torch.ops.kernels.tune_preprocess

Builds ``csrc/fused_preprocess_dual.cu`` once for each (threads a block,
stages of the frame ring, waves of blocks) with ``-D`` overrides, all builds
at once, into the package's ``_build/``. Each variant is checked against the
plain twin at the flagship N=64 (max |diff| < 1e-5) and timed for each
output-rows-per-tile by its device time in a ``torch.profiler`` trace, at
N=64 and N=1, beside ``F.adaptive_avg_pool2d`` and a device-to-device copy
of the N=64 frames, which reads and writes 2x their bytes, timed the same way. Prints
one line a variant, then a JSON line of every time, then the card's name
and power limit. Exits non-zero when a variant fails to build or disagrees.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import itertools
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch.ops.kernels import build
from gelslim_depth_tpu_torch.ops.kernels import preprocess_kernel as pk
from gelslim_depth_tpu_torch.utils.profiling import device_ms

FRAME, NET_IN = (320, 427), (160, 213)
MULT, ADD = (1 / 255.0,) * 3, (0.0,) * 3
THREADS, STAGES, WAVES, ROWS_PER_TILE = (128, 256), (2, 3, 4), (4, 8, 16), (1, 2, 4)


def build_variant(threads: int, stages: int, waves: int) -> str:
    src = os.path.join(build.CSRC_DIR, "fused_preprocess_dual.cu")
    lib = os.path.join(build.BUILD_DIR, f"libfpd_tune_t{threads}_s{stages}_w{waves}.so")
    defines = [f"-DFPD_THREADS={threads}", f"-DFPD_STAGES={stages}", f"-DFPD_WAVES={waves}"]
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {defines}:\n{proc.stderr}")
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tune_preprocess: needs a CUDA device")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    shapes = list(itertools.product(THREADS, STAGES, WAVES))
    with concurrent.futures.ThreadPoolExecutor(len(shapes)) as pool:
        libs = dict(zip(shapes, pool.map(lambda s: build_variant(*s), shapes)))

    g = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.rand((64, 6, *FRAME), generator=g, device="cuda") * 255
    base = torch.rand((6, *FRAME), generator=g, device="cuda") * 255
    want = pk.fused_preprocess_dual_reference(frames, base, MULT, ADD, out_size=NET_IN)
    out64 = torch.empty_like(want)
    out1 = torch.empty((2, 3, *NET_IN), device="cuda")
    library = {n: device_ms(lambda: F.adaptive_avg_pool2d(frames[:n], NET_IN)) for n in (1, 64)}
    copy = torch.empty_like(frames)
    copy_ms = device_ms(lambda: copy.copy_(frames))
    print(f"adaptive_avg_pool2d: N=64 {library[64]:.4f} ms, N=1 {library[1]:.4f} ms; copy of the "
          f"N=64 frames {copy_ms:.4f} ms ({2 * frames.nbytes / copy_ms / 1e9:.3f} TB/s)", flush=True)

    results = []
    for (threads, stages, waves), lib in libs.items():
        fn = pk.bind(ctypes.CDLL(lib))
        for rows in ROWS_PER_TILE:
            def run(n, out):
                err = pk.launch(fn, frames[:n], base, out, MULT, ADD, True, rows)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            run(64, out64)
            torch.cuda.synchronize()
            err = (out64 - want).abs().max().item()
            if not err < 1e-5:
                sys.exit(f"tune_preprocess: variant {threads, stages, waves, rows} disagrees: {err}")
            ms64, ms1 = device_ms(lambda: run(64, out64)), device_ms(lambda: run(1, out1))
            results.append(dict(threads=threads, stages=stages, waves=waves, rows_per_tile=rows,
                                ms_n64=ms64, ms_n1=ms1, max_abs_err=err))
            print(f"threads {threads} stages {stages} waves {waves} rows/tile {rows}: "
                  f"N=64 {ms64:.4f} ms, N=1 {ms1:.4f} ms, max|diff| {err:.2e}", flush=True)
    best = min(results, key=lambda r: r["ms_n64"])
    print(json.dumps({"library_ms": library, "copy_ms": copy_ms, "variants": results, "best_n64": best}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True)
    print(card.stdout.strip())


if __name__ == "__main__":
    main()
