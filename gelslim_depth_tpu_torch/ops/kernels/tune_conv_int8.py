"""Sweep the int8 convolution kernel's launch shape on one CUDA card.

    python3 -m gelslim_depth_tpu_torch.ops.kernels.tune_conv_int8

Builds ``csrc/conv2d_int8.cu`` once for each depth of the wgmma path's TMA
ring (``-DCONV_TMA_STAGES``) and each count of producer warps of the
one-block tiles (``-DCONV_PRODUCERS``), all builds at once, into the
package's ``_build/``. Each variant is held against the plain twin, bit for
bit, on the 17 quantized convs of the default (flagship) config at N=1 with their
serving epilogues (``models/quantize.py::serving_launches``) and on one
shape of the bytes path, then timed by its device time in a
``torch.profiler`` trace on every site at N=64 dual frames (128 finger
images) and at N=1. Each site is timed alone, back to back, so its weights
stay in L2: where a variant's gain depends on what is cached, the serving
trace of ``chip_smoke.py`` decides. Prints one line a variant, then a JSON
line of every time, then the card's name and power limit; each site's time
on a line of its own as it is measured. Exits non-zero when a variant fails
to build or disagrees.
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
from gelslim_depth_tpu_torch.models.quantize import SiteLaunch, serving_launches
from gelslim_depth_tpu_torch.ops.kernels import build
from gelslim_depth_tpu_torch.ops.kernels import conv_int8 as ck
from gelslim_depth_tpu_torch.utils.profiling import device_ms

TMA_STAGES, PRODUCERS = (4, 6), (2, 4)


def flagship_launches(n_img: int):
    cfg = GelslimConfig()
    return serving_launches(cfg.unet_config(), n_img, cfg.input_tactile_image_size)


def build_variant(stages: int, producers: int) -> str:
    src = os.path.join(build.CSRC_DIR, "conv2d_int8.cu")
    lib = os.path.join(build.BUILD_DIR, f"libconv_tune_tma{stages}_p{producers}.so")
    defines = [f"-DCONV_TMA_STAGES={stages}", f"-DCONV_PRODUCERS={producers}"]
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {defines}:\n{proc.stderr}")
    return lib


def site_inputs(g, launch: SiteLaunch):
    """(qx, w, scale, epilogue, outputs, sources) of a launch with a
    DoubleConv site's epilogue: BN, relu, bf16, its int8 outputs."""
    def ints(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    def vec(lo, hi):
        return torch.rand(launch.cout, generator=g, device="cuda") * (hi - lo) + lo

    qx = ints(launch.x_shape)
    qx2 = ints(launch.x2_shape) if launch.x2_shape else None
    cin = launch.x_shape[3] + (launch.x2_shape[3] if qx2 is not None else 0)
    w = ints((launch.cout, launch.k, launch.k, cin))
    ep = ck.Epilogue(bn_mul=vec(0.5, 1.5), bn_add=vec(-0.5, 0.5), act="relu", out_dtype=torch.bfloat16,
                     q_scales=tuple(torch.full((1,), v, device="cuda") for v in (0.05, 0.11)[:launch.n_q]),
                     store_float=launch.store_float)
    shape = (*launch.x_shape[:3], launch.cout)
    outs = ([torch.empty(shape, dtype=torch.int8, device="cuda") for _ in range(launch.n_q)],
            torch.empty(shape, dtype=torch.bfloat16, device="cuda") if launch.store_float else None)
    return qx, w, vec(1e-5, 1e-4), ep, outs, dict(qx2=qx2, offset=launch.offset)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tune_conv_int8: needs a CUDA device")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    variants = list(itertools.product(TMA_STAGES, PRODUCERS))
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda v: build_variant(*v), variants)))

    g = torch.Generator(device="cuda").manual_seed(0)
    bytes_path = SiteLaunch("bytes", (2, 17, 23, 24), (2, 17, 22, 8), (0, 1), 40, 3, 2, True)
    checks = [site_inputs(g, launch) for launch in [*flagship_launches(1), bytes_path]]
    wants = [ck.conv2d_int8_reference(qx, w, pad=1, scale=s, epilogue=ep, **src) for qx, w, s, ep, _, src in checks]
    timed = {n: [(launch.site, *site_inputs(g, launch)) for launch in flagship_launches(2 * n)] for n in (64, 1)}

    results = []
    for (stages, producers), lib in libs.items():
        fn = ck.bind(ctypes.CDLL(lib))

        def run(qx, w, scale, ep, outs, src):
            err, _ = ck.launch(fn, qx, w, outs[1], outs[0], pad=1, scale=scale, epilogue=ep, **src)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        for (qx, w, scale, ep, outs, src), want in zip(checks, wants):
            run(qx, w, scale, ep, outs, src)
            torch.cuda.synchronize()
            got = (*outs[0], *([outs[1]] if outs[1] is not None else []))
            if not all(torch.equal(a, b) for a, b in zip(got, want if isinstance(want, tuple) else (want,))):
                sys.exit(f"tune_conv_int8: {stages} stages, {producers} producers disagree at "
                         f"{tuple(qx.shape)} -> {w.shape[0]}")
        row = dict(tma_stages=stages, producers=producers)
        for n, sites in timed.items():
            per_site = {}
            for site, *args in sites:
                per_site[site] = device_ms(lambda: run(*args))
                print(f"  N={n} {site}: {per_site[site]:.4f} ms", flush=True)
            row[f"ms_n{n}"] = sum(per_site.values())
            row[f"sites_n{n}"] = per_site
        results.append(row)
        print(f"{stages} TMA stages, {producers} producers: {len(per_site)} sites N=64 {row['ms_n64']:.3f} ms, "
              f"N=1 {row['ms_n1']:.3f} ms", flush=True)
    best = min(results, key=lambda r: r["ms_n64"])
    print(json.dumps({"variants": results, "best_n64": best}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True)
    print(card.stdout.strip())


if __name__ == "__main__":
    main()
