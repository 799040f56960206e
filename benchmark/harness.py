"""One run of one cell, driven by data.

``BENCHMARK.json`` names each cell's configuration, traffic mix and
metrics; the harness finds by those names:
- the configuration: the file that ``BENCHMARK.json`` gives it;
- the traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``loop``
  names the loop that drives it, ``benchmark/loops/<loop>.py``, and whose
  numbers size it;
- the limits of the comparison that decides ``correct``:
  ``benchmark/limits/<workload>.json``, one limit a number compared;
- each per-layer metric's reader: ``benchmark/metrics/<metric>.py``, or,
  where there is none, the reader its name's first part names
  (``mfu.batch`` and ``mfu.live`` are both read by ``metrics/mfu.py``);
  its ``read(trace, ctx)`` returns the number, or None where the traced
  slice holds nothing to read.

A loop's ``run(cell, seed, seconds, traced, device, system=None)`` makes
its inputs and the program from the seed, warms up, measures for
``seconds`` and returns a ``Run``: the work attempted, the end-to-end
metrics it measured, its set-up phases, the traced slice, and the judge
that compares what the window produced with the plain reference once the
window has closed. ``system``, where given, takes the program's place
(the control of ``calibrate.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import random
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import trace as trace_mod, yardstick

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    """What one workload of ``BENCHMARK.json`` names, read from its files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell's files, by the names in ``root``'s BENCHMARK.json."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = os.path.join(root, "benchmark")
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(bench, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(bench, "limits", f"{workload}.json"))
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(workload, w["chips"], config, traffic, e2e, per_layer, limits)


def load_module(kind: str, name: str, root: str = ROOT):
    """``benchmark/<kind>/<name>.py`` under root, loaded from its path."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, root: str = ROOT) -> Callable:
    """The reader of a per-layer metric: its own file, else its name's
    first part's."""
    if not os.path.exists(os.path.join(root, "benchmark", "metrics", f"{name}.py")):
        name = name.split(".")[0]
    return load_module("metrics", name, root).read


class Reservoir:
    """A uniform sample of ``size`` of the window's calls, drawn from the
    seed as the calls come (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Run:
    """What a loop hands back: the work attempted, the end-to-end metrics
    it measured on the host's clock, the seconds of its set-up phases, the
    window's start (``time.perf_counter``), the traced slice, and the
    comparison of what it kept."""

    attempted: int
    metrics: Dict[str, float]
    setup_phases: Dict[str, float]
    window_start: float
    trace: Optional[trace_mod.Trace]
    judge: Callable[[], Dict[str, float]]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phases(marks) -> Dict[str, float]:
    """Seconds of each set-up phase from (name, time) marks."""
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def device_line(device: torch.device) -> Dict[str, object]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def per_layer_metrics(cell: Cell, tr: trace_mod.Trace, device_kind: str, root: str) -> Dict[str, dict]:
    ctx = {"config": cell.config, "traffic": cell.traffic,
           "peaks": yardstick.card_peaks(device_kind) if tr.has_device_ops() else None}
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"], root)(tr, ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float, system=None,
             root: str = ROOT) -> dict:
    """One run: set-up (from t0, the process's start), the window, the
    traced slice's metrics, the comparison. Returns the result's object,
    with the set-up's phases under ``setup_phases`` and the numbers
    compared, each with its limit, last under ``compared``."""
    device = torch.device(device)
    loop = cell.traffic["loop"]
    run = load_module("loops", loop, root).run(cell, seed, seconds, traced, device, system=system)
    measured = {**run.metrics, "setup_s": run.window_start - t0}
    dev = device_line(device)
    metrics: Dict[str, dict] = {}
    breakdown = None
    if not traced:
        for m in cell.end_to_end:
            if m["name"] not in measured:
                raise KeyError(f"the {loop!r} loop measures no {m['name']!r}")
            metrics[m["name"]] = {"value": float(measured[m["name"]]), "unit": m["unit"]}
    elif run.trace is not None:
        metrics = per_layer_metrics(cell, run.trace, dev["kind"], root)
        dev["busy_s"] = run.trace.busy_s() or 0.0
        dev["window_s"] = run.trace.window_s
        if run.trace.has_device_ops():
            breakdown = {"device_ops": run.trace.top_device_ops(), "idle_gaps": run.trace.idle_gaps()}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = run.judge()
    compared = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items() if k in cell.limits}
    correct = len(compared) == len(cell.limits) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    phases_s = run.setup_phases
    result = {"correct": correct, "attempted": run.attempted, "failed": 0, "metrics": metrics, "device": dev,
              "setup_phases": {"process": measured["setup_s"] - sum(phases_s.values()), **phases_s}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["counts"] = {k: v for k, v in numbers.items() if k not in cell.limits}
    result["compared"] = compared
    return result
