#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it is started on:

    python3 benchmark/run.py --workload int8_batch64 --seed 7 --seconds 20 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; then ``counts`` and, last, ``compared``: each
number the correctness check compared, with its limit. The same numbers
are the last lines of standard error.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``gelslim_depth_tpu`` (by whole top-level module name) has
been loaded once the window has closed. The program under test is
``gelslim_depth_tpu_torch``; its kernels build on first use into its
``_build/`` directory inside this checkout.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BANNED = ("jax", "jaxlib", "flax", "gelslim_depth_tpu")


def banned_modules():
    """Loaded modules whose whole top-level name is banned."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi: no reading"


def finite(obj):
    """obj with every float that is not finite (a missing or misshapen
    output reads infinite) as the largest float, so that the line stays
    strict JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return sys.float_info.max
    return obj


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), this machine has {have}; no result",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    # the host's side of a call is one thread's: a pool of spinning
    # intra-op threads only competes with it for the machine's cores
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    print(f"set-up phases (s): {result.pop('setup_phases')}", file=sys.stderr)
    found = banned_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    result = finite(result)
    print(json.dumps(result, allow_nan=False))
    sys.stdout.flush()
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
