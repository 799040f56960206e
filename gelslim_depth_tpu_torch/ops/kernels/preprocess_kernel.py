"""Fused dual-finger preprocess: difference image -> area resize ->
per-channel normalize, over (N, 6, H, W) float32 frames.

``fused_preprocess_dual`` launches the hand-written CUDA kernel
``csrc/fused_preprocess_dual.cu`` for tensors on a CUDA device (the source's
header says what it replaces, what bounds it and how it is laid out), and
computes ``fused_preprocess_dual_reference``, the same function composed of
plain PyTorch ops, for tensors on the CPU. There is no fallback from the
kernel to the plain version: on CUDA it launches or raises.

The kernel's plan is built here, on the host, once per shape:
``window_table`` gives each output row's or column's window and weight, and
``tile_plan`` cuts the output rows into the tiles that one block owns.

The output batch layout matches the reference's finger split
(``cat([left, right], dim=0)``, ref general_dataset.py:70-77): left-finger
samples occupy rows [0, N), right-finger rows [N, 2N).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch.ops.image import get_difference_image
from gelslim_depth_tpu_torch.ops.resize import area_resize

STAGES = 3  # the kernel's ring of frame buffers (kStages in the source)
ROWS_PER_TILE = 2  # output rows a block owns, where its buffers fit
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90


class WindowTable(NamedTuple):
    """Area-resize windows of one axis: output i averages input
    [start[i], end[i]) with each term weighted by weight[i]."""

    start: np.ndarray  # int32 (n_out,)
    end: np.ndarray  # int32 (n_out,)
    weight: np.ndarray  # float32 (n_out,): float32(1 / (end - start))


class TilePlan(NamedTuple):
    """Output rows cut into tiles: row t of ``tiles`` is (o0, o1, r0, r1),
    output rows [o0, o1) whose windows lie in input rows [r0, r1)."""

    tiles: np.ndarray  # int32 (n_tiles, 4)
    tile_rows: int  # output rows in a tile, at most
    max_tile_rows: int  # input rows a tile loads, at most


@functools.lru_cache(maxsize=128)
def window_table(n_in: int, n_out: int) -> WindowTable:
    """The windows of ``ops.resize._area_weight_matrix``, row by row."""
    i = np.arange(n_out, dtype=np.int64)
    start = (i * n_in) // n_out
    end = -((-(i + 1) * n_in) // n_out)  # ceil((i+1)*n_in/n_out)
    return WindowTable(
        start.astype(np.int32), end.astype(np.int32), (1.0 / (end - start)).astype(np.float32)
    )


def smem_bytes(tile_rows: int, max_tile_rows: int, w_in: int, w_out: int) -> int:
    """Shared memory of one block, laid out as the kernel's launcher lays it
    out: base span and STAGES frame spans (each with room for 0-3 floats of
    misalignment, rounded to 16 B), then 16 B a window of each output column
    and of each of the tile's output rows."""
    stage = (max_tile_rows * w_in + 6) // 4 * 4
    return 4 * (STAGES + 1) * stage + 16 * (w_out + tile_rows)


@functools.lru_cache(maxsize=128)
def tile_plan(h_in: int, w_in: int, h_out: int, w_out: int, rows_per_tile: int = ROWS_PER_TILE) -> TilePlan:
    """Tiles of rows_per_tile output rows, or fewer where a block's buffers
    would not fit in shared memory; raises ValueError where none fits."""
    rows = window_table(h_in, h_out)
    for tile_rows in range(min(rows_per_tile, h_out), 0, -1):
        o0 = np.arange(0, h_out, tile_rows)
        o1 = np.minimum(o0 + tile_rows, h_out)
        tiles = np.stack([o0, o1, rows.start[o0], rows.end[o1 - 1]], axis=1).astype(np.int32)
        max_tile_rows = int((tiles[:, 3] - tiles[:, 2]).max())
        if smem_bytes(tile_rows, max_tile_rows, w_in, w_out) <= SMEM_LIMIT:
            return TilePlan(tiles, tile_rows, max_tile_rows)
    raise ValueError(
        f"fused_preprocess_dual: a {h_in}x{w_in} -> {h_out}x{w_out} resize needs more "
        f"shared memory than a block has"
    )


@functools.lru_cache(maxsize=128)
def _widest_window(n_in: int, n_out: int) -> int:
    t = window_table(n_in, n_out)
    return int((t.end - t.start).max())


@functools.lru_cache(maxsize=128)
def _window_table_tensor(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    # int32 (3, n_out): starts, ends, and the weights' float32 bits; kept per
    # device so a serving call copies nothing from the host
    t = window_table(n_in, n_out)
    return torch.from_numpy(np.stack([t.start, t.end, t.weight.view(np.int32)])).to(device)


@functools.lru_cache(maxsize=128)
def _tile_tensor(h_in, w_in, h_out, w_out, rows_per_tile, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tile_plan(h_in, w_in, h_out, w_out, rows_per_tile).tiles).to(device)


def bind(lib: ctypes.CDLL):
    """The C entry of a built csrc/fused_preprocess_dual.cu, typed."""
    fn = lib.fused_preprocess_dual
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, i, i, i, i, i, i, f, f, f, f, f, f, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    return bind(load_library("fused_preprocess_dual"))


def launch(fn, frames, base, out, mult, add, use_diff: bool, rows_per_tile: int = ROWS_PER_TILE) -> int:
    """Launches ``fn`` (a bound C entry) on checked, contiguous CUDA tensors
    with its window tables and tile plan; returns its CUDA error code."""
    n, _, h_in, w_in = frames.shape
    h_out, w_out = out.shape[-2:]
    plan = tile_plan(h_in, w_in, h_out, w_out, rows_per_tile)
    dev = frames.device
    with torch.cuda.device(dev):
        return fn(
            frames.data_ptr(), base.data_ptr() if use_diff else None, out.data_ptr(),
            n, h_in, w_in, h_out, w_out, int(bool(use_diff)), *mult, *add,
            _window_table_tensor(h_in, h_out, dev).data_ptr(),
            _window_table_tensor(w_in, w_out, dev).data_ptr(),
            _tile_tensor(h_in, w_in, h_out, w_out, rows_per_tile, dev).data_ptr(),
            len(plan.tiles), plan.tile_rows, plan.max_tile_rows,
            _widest_window(h_in, h_out), _widest_window(w_in, w_out),
            torch.cuda.current_stream(dev).cuda_stream,
        )


def _coeffs(v: Sequence[float], name: str) -> Tuple[float, float, float]:
    v = np.asarray(v, np.float32).reshape(-1)
    if v.shape != (3,):
        raise ValueError(f"{name} must hold 3 per-channel values, got shape {v.shape}")
    return tuple(float(x) for x in v)


def fused_preprocess_dual(
    frames: torch.Tensor,           # (N, 6, H, W) float32
    base: Optional[torch.Tensor],   # (6, H, W) float32; may be None when use_diff=False
    mult: Sequence[float],          # (3,) per-channel normalize multiplier
    add: Sequence[float],           # (3,) per-channel normalize offset
    *,
    out_size: Tuple[int, int],
    use_diff: bool = True,
) -> torch.Tensor:
    """(N, 6, H, W) + base -> (2N, 3, h, w) normalized finger images.

    On CUDA the output is allocated with ``torch.empty`` and the kernel is
    launched on the current stream without synchronizing; each launch adds
    one to ``fused_preprocess_dual.launches`` (an empty batch launches
    nothing). CPU tensors go through
    ``fused_preprocess_dual_reference`` and launch nothing."""
    if frames.ndim != 4 or frames.shape[1] != 6:
        raise ValueError(f"frames must be (N, 6, H, W), got {tuple(frames.shape)}")
    n, _, h_in, w_in = frames.shape
    h_out, w_out = int(out_size[0]), int(out_size[1])
    if h_out < 1 or w_out < 1:
        raise ValueError(f"out_size must be positive, got {out_size}")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    if use_diff:
        if base is None or tuple(base.shape) != (6, h_in, w_in):
            raise ValueError(
                f"base must be (6, {h_in}, {w_in}) with use_diff, got "
                f"{None if base is None else tuple(base.shape)}"
            )
        if base.dtype != torch.float32 or base.device != frames.device:
            raise TypeError("base must be float32 on the frames' device")
    mult, add = _coeffs(mult, "mult"), _coeffs(add, "add")

    if frames.device.type == "cpu":
        return fused_preprocess_dual_reference(
            frames, base, mult, add, out_size=(h_out, w_out), use_diff=use_diff
        )
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")
    if not frames.is_contiguous() or (use_diff and not base.is_contiguous()):
        raise ValueError("frames and base must be contiguous")

    out = torch.empty((2 * n, 3, h_out, w_out), dtype=torch.float32, device=frames.device)
    if n == 0:
        return out
    err = launch(_kernel_fn(), frames, base, out, mult, add, use_diff)
    if err != 0:
        raise RuntimeError(f"fused_preprocess_dual kernel launch failed: CUDA error {err}")
    fused_preprocess_dual.launches += 1
    return out


fused_preprocess_dual.launches = 0


def fused_preprocess_dual_reference(frames, base, mult, add, *, out_size, use_diff=True):
    """Plain PyTorch composition of the same function (the kernel's twin)."""
    n, _, h_in, w_in = frames.shape
    # (N, 2, 3, H, W) -> (2, N, 3, H, W): left fingers first, then right
    fingers = frames.reshape(n, 2, 3, h_in, w_in).transpose(0, 1)
    if use_diff:
        fingers = get_difference_image(fingers, base.reshape(2, 1, 3, h_in, w_in))
    resized = area_resize(fingers.reshape(2 * n, 3, h_in, w_in), out_size)
    m = torch.as_tensor(np.asarray(mult, np.float32), device=frames.device).reshape(1, 3, 1, 1)
    a = torch.as_tensor(np.asarray(add, np.float32), device=frames.device).reshape(1, 3, 1, 1)
    return resized * m + a
