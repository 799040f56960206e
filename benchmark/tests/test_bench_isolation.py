"""What the harness loads and where it refuses to run: no JAX and no JAX
package by whole top-level module name, and no result without a card."""

import os
import subprocess
import sys
import types

import pytest

from benchmark import harness, run

ROOT = harness.ROOT


def test_banned_names_are_whole_top_level_names():
    fake = ("gelslim_depth_tpu", "gelslim_depth_tpu.ops", "jax.numpy", "jaxlib", "flax", "jaxtyping",
            "gelslim_depth_tpu_torch_extra")
    saved = {name: sys.modules.get(name) for name in fake}
    try:
        for name in fake:
            sys.modules.setdefault(name, types.ModuleType(name))
        found = run.banned_modules()
        assert {"gelslim_depth_tpu", "jax", "jaxlib", "flax"} <= set(found)
        assert "jaxtyping" not in found and "gelslim_depth_tpu_torch_extra" not in found
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


DRIVE = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark import run, harness
from benchmark.tests import small
root = small.copy({dest!r})
for w in ("int8_batch64", "bf16_batch64"):
    harness.run_cell(harness.find_cell(w, root), 1, 0.05, True, "cpu", time.perf_counter(), root=root)
print(run.banned_modules())
"""


def test_a_run_loads_no_jax(tmp_path):
    """Start the harness and drive cells through the port, in a process of
    its own: nothing whose top-level name is banned is loaded."""
    out = subprocess.run([sys.executable, "-c", DRIVE.format(root=ROOT, dest=str(tmp_path))], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a CUDA card the command prints nothing and exits non-zero:
    no fallback to the CPU."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "int8_batch64", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
def test_bare_checkout_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the program is missing: no result, a non-zero exit."""
    import shutil

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: without one every run stops before the program loads")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "int8_batch64", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_result_line_is_strict_json():
    """A missing output reads infinite; the printed line stays strict JSON
    and the number still exceeds any limit."""
    import json
    import math

    line = json.dumps(run.finite({"compared": {"worst_frame_rmse_mm": {"value": math.inf, "limit": 0.1}},
                                  "counts": [math.nan, 1.0]}), allow_nan=False)
    back = json.loads(line)
    assert back["compared"]["worst_frame_rmse_mm"]["value"] > 1e300
    assert back["counts"][1] == 1.0
