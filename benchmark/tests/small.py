"""A copy of the benchmark at a small size, for the CPU tests: the
repository's ``BENCHMARK.json`` and ``benchmark/`` files, with some
numbers of the configuration, traffic and limit files changed, in a
directory of the test's own. ``harness.find_cell(workload, root)`` reads
the copy as a run reads the repository."""

import json
import os
import shutil

from benchmark import harness

# dims 8/16/32, a 16x21 network input from 32x43 frames; 4 dual frames a
# call and 2 calls kept
CONFIG = {"CNN_dimensions": [8, 16, 32], "input_tactile_image_size": [16, 21], "frame_size": [32, 43]}
TRAFFIC = {
    "batch64": {"dual_frames_per_call": 4, "pool": 2, "kept_calls": 2, "warmup_calls": 1, "traced_calls": 2},
}


def copy(dest, config=None, traffic=None, limits=None) -> str:
    """The benchmark under dest, each configuration file updated with
    config, each traffic file named in traffic with its entry, and each
    workload's limits named in limits replaced; returns dest as a str."""
    dest = str(dest)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), dest)
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))

    def update(path, changes, replace=False):
        data = {} if replace else harness.load_json(path)
        with open(path, "w") as f:
            json.dump({**data, **changes}, f)

    configs = os.path.join(bench, "configs")
    for name in os.listdir(configs):
        update(os.path.join(configs, name), CONFIG if config is None else config)
    for name, changes in (TRAFFIC if traffic is None else traffic).items():
        update(os.path.join(bench, "traffic", f"{name}.json"), changes)
    for workload, changes in (limits or {}).items():
        update(os.path.join(bench, "limits", f"{workload}.json"), changes, replace=True)
    return dest
