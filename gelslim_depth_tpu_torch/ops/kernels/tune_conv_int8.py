"""Sweep the int8 convolution kernel's launch shape on one CUDA card.

    python3 -m gelslim_depth_tpu_torch.ops.kernels.tune_conv_int8

Builds ``csrc/conv2d_int8.cu`` once for each (stages of the K ring, the
least Cout that takes the 128-channel-wide tile) with ``-D`` overrides, all
builds at once, into the package's ``_build/``. Each variant is held against
the plain twin, bit for bit, on the distinct quantized-conv shapes of the
default (flagship) config at N=1 and on two Cin (24, 32) that take the
byte-by-byte load path, then timed by its device time in a
``torch.profiler`` trace on every quantized site at N=64 dual frames (128
finger images) and at N=1. Each site is timed alone, back to back, so its
weights stay in L2: where a variant's gain depends on what is cached, the
serving trace of ``chip_smoke.py`` decides. Prints one line a variant, then a JSON line of
every time, then the card's name and power limit; each site's time on a
line of its own as it is measured. Exits non-zero when a variant fails to
build or disagrees.
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

from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.models.quantize import quantized_site_shapes
from gelslim_depth_tpu_torch.ops.kernels import build
from gelslim_depth_tpu_torch.ops.kernels import conv_int8 as ck
from gelslim_depth_tpu_torch.utils.profiling import device_ms

STAGES, WIDE_COUT = (2, 3), (128, 256, 1 << 30)  # 1 << 30: never wide


def flagship_sites(n_img: int):
    """(site, NHWC input shape, Cout, k) of the default config's quantized
    convs at n_img finger images."""
    cfg = GelslimConfig()
    return quantized_site_shapes(cfg.unet_config(), n_img, cfg.input_tactile_image_size)


def build_variant(stages: int, wide_cout: int) -> str:
    src = os.path.join(build.CSRC_DIR, "conv2d_int8.cu")
    lib = os.path.join(build.BUILD_DIR, f"libconv_tune_s{stages}_w{wide_cout}.so")
    defines = [f"-DCONV_STAGES={stages}", f"-DCONV_WIDE_COUT={wide_cout}"]
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {defines}:\n{proc.stderr}")
    return lib


def site_inputs(g, x_shape, cout, k=3):
    def vec(lo, hi):
        return torch.rand(cout, generator=g, device="cuda") * (hi - lo) + lo

    qx = torch.randint(-127, 128, x_shape, generator=g, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, k, k, x_shape[-1]), generator=g, device="cuda", dtype=torch.int8)
    ep = ck.Epilogue(bn_mul=vec(0.5, 1.5), bn_add=vec(-0.5, 0.5), act="relu", out_dtype=torch.bfloat16)
    out = torch.empty((*x_shape[:3], cout), dtype=torch.bfloat16, device="cuda")
    return qx, w, vec(1e-5, 1e-4), ep, out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tune_conv_int8: needs a CUDA device")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    shapes = list(itertools.product(STAGES, WIDE_COUT))
    with concurrent.futures.ThreadPoolExecutor(len(shapes)) as pool:
        libs = dict(zip(shapes, pool.map(lambda s: build_variant(*s), shapes)))

    g = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for _, x_shape, cout, k in flagship_sites(1):
        if (x_shape, cout, k) not in checks:
            checks.append((x_shape, cout, k))
    checks += [((2, 17, 23, 24), 40, 3), ((2, 17, 23, 32), 70, 3)]  # the byte-by-byte load path
    checks = [(x, c, *site_inputs(g, x, c, k)) for x, c, k in checks]
    wants = [ck.conv2d_int8_reference(qx, w, pad=1, scale=s, epilogue=ep) for _, _, qx, w, s, ep, _ in checks]
    timed = {n: [(site, *site_inputs(g, x, c, k)) for site, x, c, k in flagship_sites(2 * n)] for n in (64, 1)}

    results = []
    for (stages, wide_cout), lib in libs.items():
        fn = ck.bind(ctypes.CDLL(lib))

        def run(qx, w, scale, ep, out):
            err = ck.launch(fn, qx, w, out, pad=1, scale=scale, epilogue=ep)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        for (x_shape, cout, qx, w, scale, ep, out), want in zip(checks, wants):
            run(qx, w, scale, ep, out)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"tune_conv_int8: variant {stages, wide_cout} disagrees at {x_shape} -> {cout}")
        row = dict(stages=stages, wide_cout=wide_cout)
        for n, sites in timed.items():
            per_site = {}
            for site, *args in sites:
                per_site[site] = device_ms(lambda: run(*args))
                print(f"  N={n} {site}: {per_site[site]:.4f} ms", flush=True)
            row[f"ms_n{n}"] = sum(per_site.values())
            row[f"sites_n{n}"] = per_site
        results.append(row)
        print(f"stages {stages} wide tile from Cout {wide_cout}: {len(per_site)} sites "
              f"N=64 {row['ms_n64']:.3f} ms, N=1 {row['ms_n1']:.3f} ms", flush=True)
    best = min(results, key=lambda r: r["ms_n64"])
    print(json.dumps({"variants": results, "best_n64": best}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True)
    print(card.stdout.strip())


if __name__ == "__main__":
    main()
