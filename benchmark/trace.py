"""The reduction of a ``torch.profiler`` trace of a slice of the window to
what the per-layer readers (``benchmark/metrics/*.py``) and the result's
``breakdown`` read: the device operations, the device's busy time (the
union of their intervals), the layer of each device operation by its
name, and the idle gaps between them named by what the host was doing."""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

# substrings of device op names -> their layer; the first layer whose
# substrings a name holds wins, any other op (cuDNN and cuBLAS kernels,
# copies) is a library's
LAYERS = (
    ("conv2d_int8", ("conv2d_int8",)),
    ("fused_preprocess_dual", ("fused_preprocess_dual",)),
    ("aten", ("at::native",)),
)
LIBRARY = "library"
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160


class Op(NamedTuple):
    name: str
    start_us: float
    end_us: float
    thread: int = 0


def layer_of(name: str) -> str:
    for layer, keys in LAYERS:
        if any(k in name for k in keys):
            return layer
    return LIBRARY


@contextlib.contextmanager
def profiled(enabled: bool):
    """A torch.profiler over the block when enabled; yields the profiler
    or None. CUDA activity only: the device's ops and the host's CUDA
    runtime calls, through CUPTI. Recording every aten op on the host as
    well costs tens of microseconds an op, which slowed a train step of
    ~1,900 device ops five-fold and made the device's idle share the
    profiler's. On a machine without a card it records the host's ops, so
    that the slice still yields a (deviceless) trace."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        yield prof


class Trace:
    """One traced slice: ``units`` calls or steps in ``window_s`` seconds
    of host time."""

    def __init__(self, prof, units: int, window_s: float):
        from torch.autograd import DeviceType

        self.units, self.window_s = units, window_s
        self.device: List[Op] = []
        self.host: List[Op] = []
        for e in prof.events():
            op = Op(e.name, e.time_range.start, e.time_range.end, e.thread)
            if e.device_type == DeviceType.CUDA:
                self.device.append(op)
            elif e.device_type == DeviceType.CPU:
                self.host.append(op)
        self.device.sort(key=lambda o: o.start_us)
        self.host.sort(key=lambda o: o.start_us)

    # ---- what the readers read -------------------------------------
    def busy_s(self) -> Optional[float]:
        """The union of the device ops' intervals, None with no device op."""
        if not self.device:
            return None
        busy, end = 0.0, self.device[0].start_us
        for op in self.device:
            busy += max(0.0, op.end_us - max(op.start_us, end))
            end = max(end, op.end_us)
        return busy / 1e6

    def idle_pct(self) -> Optional[float]:
        busy = self.busy_s()
        return None if busy is None else 100.0 * (1.0 - busy / self.window_s)

    def layer_ms_per_unit(self, layer: str) -> Optional[float]:
        """Device ms a call or step in the layer's ops, None where the
        slice ran none of them."""
        ops = [op for op in self.device if layer_of(op.name) == layer]
        if not ops:
            return None
        return sum(op.end_us - op.start_us for op in ops) / 1e3 / self.units

    def has_device_ops(self) -> bool:
        return bool(self.device)

    # ---- the breakdown ---------------------------------------------
    def top_device_ops(self) -> List[List]:
        by_name: Dict[str, float] = {}
        for op in self.device:
            key = op.name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (op.end_us - op.start_us) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]

    def _gaps(self) -> List[Tuple[float, float]]:
        gaps, end = [], None
        for op in self.device:
            if end is not None and op.start_us > end:
                gaps.append((end, op.start_us))
            end = op.end_us if end is None else max(end, op.end_us)
        return gaps

    def idle_gaps(self) -> List[List]:
        """The device's idle time between its ops, summed by the innermost
        host event running at each gap's middle (a CUDA runtime call, such
        as a launch, a copy or a synchronize), over the host's threads, and
        ``host`` where none runs (Python and aten between runtime calls):
        one sweep a thread, a stack of the events still open."""
        gaps = sorted(self._gaps(), key=lambda g: g[0] + g[1])
        names = ["host"] * len(gaps)
        latest = [float("-inf")] * len(gaps)
        threads: Dict[int, List[Op]] = {}
        for op in self.host:
            threads.setdefault(op.thread, []).append(op)
        for ops in threads.values():
            stack: List[Op] = []
            i = 0
            for g, (s, e) in enumerate(gaps):
                mid = 0.5 * (s + e)
                while i < len(ops) and ops[i].start_us <= mid:
                    while stack and stack[-1].end_us < ops[i].start_us:
                        stack.pop()
                    stack.append(ops[i])
                    i += 1
                while stack and stack[-1].end_us < mid:
                    stack.pop()
                if stack and stack[-1].start_us > latest[g]:
                    names[g], latest[g] = stack[-1].name, stack[-1].start_us
        by_name: Dict[str, float] = {}
        for name, (s, e) in zip(names, gaps):
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]
