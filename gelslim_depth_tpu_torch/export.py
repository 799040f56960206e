"""Serving export: the fused inference graph as ``torch.export`` programs.

The port's counterpart of ``gelslim_depth_tpu/export.py``. The whole fused
dual-frame graph (difference image -> resize -> normalize -> U-Net in
float32, bfloat16 or int8 -> denormalize -> resize-back) is exported with
the weights inside the program, so a serving process needs no model code:
load, call, done. Both hand-written kernels are ``torch.library`` custom
ops (``gelslim::fused_preprocess_dual``, ``gelslim::conv2d_int8``), so an
exported graph holds them as op nodes and launches them when it runs, as
eager serving does.

Artifact layout: one ``.gsx`` zip holding ``meta.json`` (the JAX package's
keys: shapes, graph kind, the device the graphs were exported on; plus
``"runtime": "torch"``) and one ``graph_b<N>.pt2`` (``torch.export.save``)
per batch size, so serving picks the right static shape.

    from gelslim_depth_tpu_torch.export import export_predictor, ExportedPredictor
    path = export_predictor(qpred, (320, 427), batch_sizes=(1, 64), path="model.gsx")
    served = ExportedPredictor.load("model.gsx")
    depth_mm = served(frames, base_frame)   # (N, 2, 320, 427)

A graph runs on the device it was exported on. ``torch.export`` records
ops, not the global precision flags that the live forward sets around its
float32 convs and the area resize's matmuls, so ``ExportedPredictor`` sets
them around every call.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import zipfile
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.inference import Predictor, QuantizedPredictor, fused_predict_dual, require_served
from gelslim_depth_tpu_torch.models.unet import full_precision
from gelslim_depth_tpu_torch.ops.resize import _highest_matmul_precision

RUNTIME = "torch"


class _DualFrameGraph(nn.Module):
    """(frames, base) -> (N, 2, *output_size) mm depth. The predictor's
    network is a submodule, so its weights travel inside the program."""

    def __init__(self, config: GelslimConfig, net: nn.Module, output_size, compute_dtype=None):
        super().__init__()
        self.config = config
        self.net = net
        self.output_size = tuple(output_size)
        self.compute_dtype = compute_dtype  # the int8 forward's, else None

    def forward(self, frames: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
        net = self.net if self.compute_dtype is None else functools.partial(self.net, compute_dtype=self.compute_dtype)
        return fused_predict_dual(self.config, net, frames, base, self.output_size)


def _dual_frame_fn(predictor, output_size):
    """(module computing (frames, base) -> depth, graph kind) for either
    Predictor or QuantizedPredictor."""
    if isinstance(predictor, QuantizedPredictor):
        return _DualFrameGraph(predictor.config, predictor.q, output_size, predictor.compute_dtype), "int8_ptq"
    if isinstance(predictor, Predictor):
        kind = "bf16" if predictor.compute_dtype == torch.bfloat16 else "float32"
        return _DualFrameGraph(predictor.config, predictor.net, output_size), kind
    raise TypeError(f"cannot export {type(predictor).__name__}")


@contextlib.contextmanager
def _serving_precision():
    """The precision flags the live forward sets for itself: cuDNN TF32 off
    (float32 convs) and float32 matmuls at "highest" (the area resize)."""
    with full_precision(torch.float32), _highest_matmul_precision():
        yield


def export_predictor(
    predictor,
    output_size: Tuple[int, int],
    *,
    path: str,
    batch_sizes: Sequence[int] = (1, 64),
    frame_size: Tuple[int, int] = (320, 427),
    platforms: Optional[Sequence[str]] = None,
) -> str:
    """Export the fused dual-frame graph (weights inside) for each batch
    size into one .gsx artifact, on the predictor's device. ``platforms``,
    where given, must name that device's type. Returns path."""
    require_served(predictor.config, "export_predictor")
    device = torch.device(predictor.device)
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(
            f"the graphs are exported on the predictor's device ({device.type}); "
            f"platforms {list(platforms)} asks for another"
        )
    module, kind = _dual_frame_fn(predictor, output_size)
    h, w = frame_size
    base = torch.zeros((6, h, w), device=device)
    # one live call first: the forward's per-device caches (resize weights,
    # kernel plans, cast weights) then hold real tensors, which the trace
    # reads as constants instead of filling them with traced ones
    predictor.predict_dual_frames(torch.zeros((1, 6, h, w), device=device), base, tuple(output_size))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for n in batch_sizes:
            frames = torch.zeros((int(n), 6, h, w), device=device)
            with torch.no_grad(), _serving_precision():
                program = torch.export.export(module, (frames, base), strict=False)
            program.example_inputs = None  # else the frames, 210 MB at N=64, travel in the artifact
            buf = io.BytesIO()
            torch.export.save(program, buf)
            # a .pt2 is an archive of raw weights already: stored, not deflated
            zf.writestr(f"graph_b{int(n)}.pt2", buf.getvalue(), compress_type=zipfile.ZIP_STORED)
        zf.writestr(
            "meta.json",
            json.dumps(
                {
                    "format": 1,
                    "kind": kind,
                    "batch_sizes": [int(n) for n in batch_sizes],
                    "frame_size": list(frame_size),
                    "output_size": list(output_size),
                    "platforms": [device.type],
                    "use_difference_image": bool(predictor.config.use_difference_image),
                    "runtime": RUNTIME,
                }
            ),
        )
    return path


class ExportedPredictor:
    """Serve a .gsx artifact: no model code, load and call. A batch of N
    routes through the cheapest composition of the exported graph sizes
    (``dispatch_plan``): an exact fit runs one graph; otherwise the batch is
    chunked into exported sizes, padding only where that beats further
    chunking under the cost model rows + overhead per call. Batch 2 on a
    (1, 64) artifact runs two b1 graphs."""

    def __init__(self, graphs, meta, *, call_overhead_rows: float = 2.0):
        self._graphs = graphs  # {batch_size: callable (frames, base) -> depth}
        self.meta = meta
        self.batch_sizes = sorted(graphs)
        self.device = torch.device(meta["platforms"][0])
        # latency model for planning: one call of the b-graph costs
        # (b + call_overhead_rows) row-equivalents. The default is the JAX
        # package's; chip_smoke.py prints the card's own (N=1 call time over
        # the per-row time at N=64)
        self.call_overhead_rows = float(call_overhead_rows)
        self._plan_cache = {}

    @classmethod
    def load(cls, path: str, **kw) -> "ExportedPredictor":
        import gelslim_depth_tpu_torch.ops.kernels  # noqa: F401  registers the gelslim:: ops

        graphs = {}
        with zipfile.ZipFile(path) as zf:
            meta = json.loads(zf.read("meta.json").decode())
            if meta.get("runtime") != RUNTIME:
                raise ValueError(
                    f"{path} is not a torch artifact (runtime {meta.get('runtime')!r}): the JAX package's "
                    "export writes StableHLO graph_b<N>.bin files, which gelslim_depth_tpu.export loads"
                )
            for n in meta["batch_sizes"]:
                program = torch.export.load(io.BytesIO(zf.read(f"graph_b{n}.pt2")))
                graphs[int(n)] = program.module()
        return cls(graphs, meta, **kw)

    def dispatch_plan(self, n: int):
        """[(graph_batch, real_rows), ...] covering n rows, minimizing total
        modeled cost (sum of graph_batch + overhead per call), then call
        count. Exact dynamic program over the remainder; e.g. with exported
        sizes (1, 64): n=2 -> [(1,1),(1,1)], n=63 -> [(64,63)] (one padded
        b64), n=70 -> [(64,64),(1,1)x6]."""
        if n in self._plan_cache:
            return self._plan_cache[n]
        if n <= 0:
            raise ValueError(f"batch must be positive, got {n}")
        sizes = self.batch_sizes
        over = self.call_overhead_rows
        # f[r] = (cost, calls, chosen_graph) for serving r remaining rows
        f = [None] * (n + 1)
        f[0] = (0.0, 0, None)
        for r in range(1, n + 1):
            best = None
            for b in sizes:
                if b >= r:
                    cand = (b + over, 1, b)
                else:
                    rows, calls, _ = f[r - b]
                    cand = (rows + b + over, calls + 1, b)
                if best is None or (cand[0], cand[1]) < (best[0], best[1]):
                    best = cand
            f[r] = best
        plan = []
        r = n
        while r > 0:
            b = f[r][2]
            take = min(b, r)
            plan.append((b, take))
            r -= take
        # largest graphs first (row-assignment order only: the multiset of
        # calls is what the program chose)
        plan.sort(key=lambda bt: -bt[0])
        self._plan_cache[n] = plan
        return plan

    def __call__(self, frames, base_frame) -> torch.Tensor:
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device).contiguous()
        base = torch.as_tensor(base_frame, dtype=torch.float32, device=self.device).contiguous()
        n = frames.shape[0]
        with torch.inference_mode(), _serving_precision():
            if n in self._graphs:  # exact fit: one call, no planning
                return self._graphs[n](frames, base)
            outs = []
            row = 0
            for graph_b, take in self.dispatch_plan(n):
                chunk = frames[row:row + take]
                if take < graph_b:
                    pad = chunk[:1].expand(graph_b - take, *chunk.shape[1:])
                    chunk = torch.cat([chunk, pad], dim=0)
                outs.append(self._graphs[graph_b](chunk, base)[:take])
                row += take
            return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
