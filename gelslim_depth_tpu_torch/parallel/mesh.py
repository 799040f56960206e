"""Data parallelism over ``torch.distributed`` ranks: the port of
``gelslim_depth_tpu/parallel/mesh.py``.

A JAX mesh of n devices in one program becomes n ranks, each a process
that owns one device (``make_mesh``). Parameters, optimizer and EMA state
are replicated (``replicate`` broadcasts rank 0's); each rank holds its own
contiguous rows of a global batch (``shard_batch``). Where GSPMD inserts
collectives from sharding annotations, the port writes its few explicitly:
the train step all-reduces the batch-norm sums (``unet_apply``'s
``reduce``), the loss and the gradients (``train/steps.py``). So DP batch
norm is global, and a DP step equals the single-device step on the whole
global batch, up to float32 summation order.

Serving and rendering need no collective: each rank runs the port's own
path on its rows, the ``fused_preprocess_dual`` kernel and, for int8,
``conv2d_int8`` included (JAX ``shard_map``s its kernel per device for the
same reason); ``gather_rows`` collects the rows in rank order for callers
that want the whole batch.

Height-sharded serving (``make_spatial_predictor[_int8]``) splits one
frame's rows over the ranks instead, for the latency of a single frame.
JAX lets GSPMD derive the halo exchanges from a height sharding of
global arrays; torch has no global array, so ``spatial_band_plan`` is the
contract (which rows each rank is fed and returns) and ``HeightHalo`` the
exchange, one before every 3x3 conv.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from gelslim_depth_tpu_torch.models.unet import UNetConfig, unet_apply
from gelslim_depth_tpu_torch.ops.resize import resize_rows, support, weight_matrix
from gelslim_depth_tpu_torch.parallel import multihost
from gelslim_depth_tpu_torch.utils.device import resolve_device


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: the gradient of each rank's
    input is the sum of every rank's incoming gradient. So each rank must
    backpropagate only its own share of the objective (its rows' loss over
    the global count), never the all-reduced total."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data-parallel axis of ranks: this process's rank, the number of
    ranks, the device this rank computes on, and the process group; group
    None is a mesh of this process alone, which runs no collective."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the ranks, in place; returns x."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def all_reduce_grad(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the ranks, differentiably (see ``_AllReduceSum``)."""
        return x if self.group is None else _AllReduceSum.apply(x, self.group)

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of n: ``multihost.process_local_rows``
        when the ranks divide n (every batch of the train and eval steps);
        else, for serving, the first ``n % size`` ranks take one more."""
        per, extra = divmod(n, self.size)
        if not extra:
            return multihost.process_local_rows(n, process_index=self.rank, process_count=self.size)
        start = self.rank * per + min(self.rank, extra)
        return slice(start, start + per + (self.rank < extra))


def make_mesh(n_devices: Optional[int] = None, *, device=None, backend: Optional[str] = None) -> Mesh:
    """The mesh of every rank of the process group (or of this process
    alone when torch.distributed is not initialized).

    device defaults to ``cuda:LOCAL_RANK`` (torchrun's), else cuda:(rank
    modulo the visible cards), and raises without a card: nothing falls
    back to the CPU unless device says so. Raises when n_devices is not
    the number of ranks: a smaller mesh would quietly run an 'n-rank' job
    on fewer. Raises when two ranks would share one card, unless the
    caller names both the device and the backend (gloo then runs both
    ranks' collectives through the host; NCCL refuses them itself)."""
    if not multihost.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh: requested {n_devices} ranks but torch.distributed is not initialized; launch "
                "one process per rank (torchrun) and call parallel.multihost.initialize first"
            )
        return Mesh(0, 1, resolve_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise RuntimeError(f"make_mesh: requested {n_devices} ranks but the process group has {world}")
    if backend is not None and backend != dist.get_backend():
        raise ValueError(f"make_mesh: backend {backend!r} named, but the group runs {dist.get_backend()!r}")
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else rank % max(torch.cuda.device_count(), 1)
        dev = resolve_device(f"cuda:{index}")
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        card = str(torch.cuda.get_device_properties(dev).uuid)
        key = int(hashlib.sha256(card.encode()).hexdigest()[:15], 16)
        ids = multihost.all_gather_rows(torch.tensor([key], device=dev)).tolist()
        if len(set(ids)) < world and not (device is not None and backend is not None):
            raise RuntimeError(
                f"make_mesh: ranks {[r for r in range(world) if ids.count(ids[r]) > 1]} share one card; "
                "give each rank its own, or name both device= and backend= to run them there on purpose"
            )
    return Mesh(rank, world, dev, dist.group.WORLD)


def _map_tree(fn, tree):
    """fn over every tensor (or numpy array) of a tree of dicts, lists,
    tuples and dataclasses; other leaves pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(tree))
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tree(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Every tensor of tree on mesh.device, rank 0's values on every rank
    (a broadcast). A module moves to the device and has its parameters and
    buffers broadcast in place; replicate one before it serves, since
    modules may cache values derived from them."""

    def one(t: torch.Tensor) -> torch.Tensor:
        t = t.to(mesh.device, copy=True)
        if mesh.group is not None:
            dist.broadcast(t, src=0, group=mesh.group)
        return t

    if isinstance(tree, nn.Module):
        tree.to(mesh.device)
        if mesh.group is not None:
            for t in tree.state_dict().values():
                dist.broadcast(t, src=0, group=mesh.group)
        return tree
    return _map_tree(one, tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows (``mesh.rows``) of every tensor of a global batch's
    tree, on mesh.device: the same global batch fed to every rank gives
    each its shard."""
    return _map_tree(lambda t: t[mesh.rows(t.shape[0])].to(mesh.device), tree)


def gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's rows in rank order, on every rank (rank counts may
    differ); for tests and for callers that want the whole batch."""
    return local if mesh.group is None else multihost.all_gather_rows(local, mesh.group)


def make_dp_predict(unet_cfg: UNetConfig, mesh: Mesh, *, compute_dtype=torch.float32):
    """Batch-sharded eval-mode forward: fwd(params, batch_stats, images)
    -> the U-Net's float32 output on this rank's images."""

    @torch.inference_mode()
    def fwd(params, batch_stats, images):
        return unet_apply(unet_cfg, params, batch_stats, images.to(mesh.device), compute_dtype=compute_dtype)[0]

    return fwd


def _dual_graph(config, net, frames, base, output_size):
    """``inference.fused_predict_dual`` on this rank's frames. A per-frame
    base (n_local, 6, H, W) is subtracted here and the kernel then runs
    against a zero base, so the front end stays the kernel; the kernel
    computes (x - base + 255) / 2 left to right, so subtracting first gives
    the bits it would give with each frame's base."""
    from gelslim_depth_tpu_torch.inference import fused_predict_dual

    if base is not None and base.ndim == 4:
        if config.use_difference_image:
            frames = frames - base
            base = torch.zeros_like(base[0])
        else:
            base = None
    return fused_predict_dual(config, net, frames.contiguous(), base, tuple(output_size))


def make_dp_fused_predictor(config, unet_cfg: UNetConfig, mesh: Mesh, output_size, *,
                            compute_dtype=torch.float32):
    """The whole dual-frame serving graph (difference, resize, normalize,
    U-Net, denormalize, resize back) on each rank's frames: weights
    replicate, frames shard on their batch axis, no collective. On CUDA the
    front end is the ``fused_preprocess_dual`` kernel on every rank, for
    any row count and for a shared (6, H, W) or per-frame (n_local, 6, H,
    W) base.

    Returns predict(params, batch_stats, frames, base) -> (n_local, 2,
    *output_size) mm depth; params and batch_stats are the reference-layout
    dictionaries of the port's training state."""

    @torch.inference_mode()
    def predict(params, batch_stats, frames, base):
        net = functools.partial(_eval_net, unet_cfg, params, batch_stats, compute_dtype)
        return _dual_graph(config, net, frames.to(mesh.device, torch.float32),
                           None if base is None else base.to(mesh.device, torch.float32), output_size)

    return predict


def _eval_net(unet_cfg, params, batch_stats, compute_dtype, x):
    return unet_apply(unet_cfg, params, batch_stats, x, compute_dtype=compute_dtype)[0]


def make_dp_fused_predictor_int8(config, mesh: Mesh, output_size, *, compute_dtype=torch.bfloat16):
    """Multi-rank serving of the int8 graph (``models/quantize.py``): the
    QuantizedUNet replicates, frames shard on their batch axis, and each
    rank runs the same path as ``QuantizedPredictor``: the
    ``fused_preprocess_dual`` kernel, then its quantized convs on
    ``conv2d_int8``. (The JAX package's also takes the model when it is
    made, and does not keep it.)

    Returns predict(q, frames, base) -> (n_local, 2, *output_size) mm;
    pass the (replicated) QuantizedUNet at each call."""

    @torch.inference_mode()
    def predict(q, frames, base):
        net = functools.partial(q, compute_dtype=compute_dtype)
        return _dual_graph(config, net, frames.to(mesh.device, torch.float32),
                           None if base is None else base.to(mesh.device, torch.float32), output_size)

    return predict


def make_dp_renderer(mesh: Mesh, *, spec, image_size=(320, 427), mm_per_pixel: float = 12.0 / 320.0,
                     fill_iters: int = 6, invert_affine: bool = False, lr_flip: bool = False):
    """Mesh->depth rendering sharded over the pose batch: the point cloud
    replicates, each rank renders its poses through
    ``meshgen.render_depth_batch`` on its device; no collective.

    Returns render(pc (P, 3) mm, poses (n_local, 3), widths (n_local,)) ->
    (n_local, 2, H, W)."""
    from gelslim_depth_tpu_torch.meshgen import render_depth_batch

    def render(pc, poses, widths):
        return render_depth_batch(pc, poses, widths, spec=spec, image_size=tuple(image_size),
                                  mm_per_pixel=mm_per_pixel, fill_iters=fill_iters,
                                  invert_affine=invert_affine, lr_flip=lr_flip, device=mesh.device)

    return render


# ---------------------------------------------------------------------------
# height-sharded serving
# ---------------------------------------------------------------------------

Rows = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Which rows each rank of a height-sharded predictor holds, as
    [start, end) pairs indexed by rank: ``levels[l]`` the U-Net's level l
    (level 0 the net input), ``frame_rows`` the frame rows a rank is fed,
    ``output_rows`` the output rows it returns. ``kernel_front_end``: the
    bands' own area windows are the global ones (an integer frame-to-net
    height ratio), so the ``fused_preprocess_dual`` kernel runs on each
    band as it is; else the front end is composed over the global windows'
    rows. ``local_back_end``: each rank's output rows read only its own net
    rows, so the resize back runs on the band alone; else every rank reads
    the gathered net output."""

    frame_hw: Tuple[int, int]
    net_hw: Tuple[int, int]
    output_hw: Tuple[int, int]
    interp_method: str
    levels: Tuple[Rows, ...]
    frame_rows: Rows
    output_rows: Rows
    kernel_front_end: bool
    local_back_end: bool

    @property
    def net_rows(self) -> Rows:
        return self.levels[0]


def spatial_band_plan(mesh, frame_hw, net_hw, output_hw, unet_cfg: UNetConfig,
                      interp_method: str = "area") -> BandPlan:
    """The bands of height-sharded serving over mesh.size ranks (mesh: a
    ``Mesh`` or a rank count), built from the bottom level up, because the
    U-Net pools. With L levels and pool m the net heights are h_0 = net_h,
    h_{l+1} = floor(h_l / m). The bottom level's h_{L-1} rows split over
    the ranks by ``Mesh.rows``' rule (the first ranks take one more); a
    boundary b there sits at b * m^(L-1-l) on level l, and the last band
    runs to h_l. So every band but the last has a height that is a
    multiple of m on every level: a band's floor-mode max-pool is the
    global one, and the transposed conv (kernel = stride = m) needs no
    halo; the last band holds the floor's dropped rows and the ``Up``
    block's bottom pad, which is all of it (dy // 2 = 0 for m = 2).
    Flagship, 4 ranks: bottom 10 rows -> (3, 3, 2, 2), net 160 rows ->
    (48, 48, 32, 32), frames 320 -> (96, 96, 64, 64).

    Frame rows are the rows the rank's net rows' resize windows read
    (``ops.resize.support``; overlapping where the ratio is not an
    integer); output rows go to the rank whose net rows hold their
    window's first row.

    Raises ValueError for a U-Net whose pools or transposed convs would
    need halos (kernel 3, pool 2, stride 2 only), and when a rank would
    get no bottom row, or no frame or output row."""
    size = mesh.size if isinstance(mesh, Mesh) else int(mesh)
    (fh, fw), (nh, nw), (oh, ow) = (tuple(int(v) for v in hw) for hw in (frame_hw, net_hw, output_hw))
    k, m, s = unet_cfg.kernel_size, unet_cfg.maxpool_size, unet_cfg.upconv_stride
    if (k, m, s) != (3, 2, 2):
        raise ValueError(f"spatial_band_plan: kernel {k}, pool {m}, upconv stride {s}: height bands need "
                         "kernel 3 (one halo row), pool 2 and upconv stride 2 (no halo)")
    heights = [nh]
    for _ in range(unet_cfg.num_levels - 1):
        heights.append(heights[-1] // m)
    if heights[-1] < size:
        raise ValueError(f"spatial_band_plan: {size} ranks over a {nh}-row net input, whose levels have "
                         f"{' -> '.join(map(str, heights))} rows: fewer bottom rows than ranks")
    per, extra = divmod(heights[-1], size)
    bottom = [r * per + min(r, extra) for r in range(size)]
    levels = []
    for level, h in enumerate(heights):
        b = [x * m ** (len(heights) - 1 - level) for x in bottom] + [h]
        levels.append(tuple(zip(b[:-1], b[1:])))
    net_rows = levels[0]
    frame_rows = tuple(support(fh, nh, interp_method, rows) for rows in net_rows)
    starts = (weight_matrix(nh, oh, interp_method) != 0).argmax(axis=1)  # each output row's first input row
    o = [int(np.searchsorted(starts, a, "left")) for a, _ in net_rows[1:]]
    output_rows = tuple(zip([0] + o, o + [oh]))
    if any(b <= a for a, b in output_rows):
        raise ValueError(f"spatial_band_plan: {size} ranks over {oh} output rows leave a rank none: {output_rows}")
    local = all(net_rows[r][0] <= lo and hi <= net_rows[r][1]
                for r, (lo, hi) in enumerate(support(nh, oh, interp_method, rows) for rows in output_rows))
    return BandPlan((fh, fw), (nh, nw), (oh, ow), interp_method, tuple(levels), frame_rows, output_rows,
                    interp_method == "area" and fh % nh == 0, local)


class HeightHalo:
    """The halo exchange of height-sharded serving: ``halo(x, dim)`` is x
    with the last row of the rank above before it and the first row of the
    rank below after it along dim, zeros at the image's top and bottom
    edges (the conv's own zero padding). One all-reduce of a zero-filled
    (ranks, 2, *row) buffer into which each rank writes its two edge rows
    (adding zeros is exact), so it runs on gloo with CUDA tensors as on
    NCCL, int8 included, and moves 2 rows a rank; a mesh of one rank pads
    with zeros and runs no collective. ``exchanges`` counts the calls;
    every rank makes the same ones."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.exchanges = 0

    def __call__(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        self.exchanges += 1
        first, last = x.narrow(dim, 0, 1), x.narrow(dim, x.shape[dim] - 1, 1)
        rank, size = self.mesh.rank, self.mesh.size
        top = bottom = torch.zeros_like(first)
        if size > 1:
            buf = x.new_zeros((size, 2, *first.shape))
            buf[rank, 0], buf[rank, 1] = first, last
            dist.all_reduce(buf, group=self.mesh.group)
            if rank > 0:
                top = buf[rank - 1, 1]
            if rank < size - 1:
                bottom = buf[rank + 1, 0]
        return torch.cat([top, x, bottom], dim)


def shard_height(mesh: Mesh, plan: BandPlan, frames, base=None):
    """This rank's frame rows (``plan.frame_rows``) of (N, 6, H, W) frames
    and of a (6, H, W) or (N, 6, H, W) base, on mesh.device."""
    f0, f1 = plan.frame_rows[mesh.rank]
    band = torch.as_tensor(frames)[:, :, f0:f1].to(mesh.device)
    return band, None if base is None else torch.as_tensor(base)[..., f0:f1, :].to(mesh.device)


def gather_height(mesh: Mesh, band: torch.Tensor) -> torch.Tensor:
    """Every rank's (N, C, rows, W) band, stacked in rank order along the
    height, on every rank (``gather_rows`` along dim 2)."""
    if mesh.group is None:
        return band
    return multihost.all_gather_rows(band.movedim(2, 0).contiguous(), mesh.group).movedim(0, 2).contiguous()


def _spatial_graph(config, plan: BandPlan, mesh: Mesh, net, frames, base, use_kernel):
    """This rank's band of the dual-frame graph: the front end on its frame
    rows, net (the U-Net on the band, exchanging halos), the denormalize,
    and the resize back to its output rows. -> (N, 2, rows, W_out) mm."""
    from gelslim_depth_tpu_torch import ops
    from gelslim_depth_tpu_torch.inference import _denormalize, dual_frames_to_fingers, kernel_front_end

    n, r = frames.shape[0], mesh.rank
    (f0, f1), (s0, e0), (o0, o1) = plan.frame_rows[r], plan.net_rows[r], plan.output_rows[r]
    if tuple(frames.shape[2:]) != (f1 - f0, plan.frame_hw[1]):
        raise ValueError(f"rank {r} is fed frame rows [{f0}, {f1}) of {plan.frame_hw}: want (N, 6, {f1 - f0}, "
                         f"{plan.frame_hw[1]}) frames, got {tuple(frames.shape)}")
    if use_kernel is None:
        use_kernel = frames.is_cuda
    if use_kernel and plan.kernel_front_end:
        if base is not None and base.ndim == 4:  # as _dual_graph: subtract here, the kernel sees a zero base
            frames, base = (frames - base, torch.zeros_like(base[0])) if config.use_difference_image else (frames, None)
        y = net(kernel_front_end(config, frames, base, (e0 - s0, plan.net_hw[1])))
        split = True  # rows [0, n) the left finger's, [n, 2n) the right's
    else:
        fingers = dual_frames_to_fingers(config, frames, base)
        x = resize_rows(fingers, plan.frame_hw[0], plan.net_hw, (s0, e0), f0, plan.interp_method)
        y = net(ops.normalize_tactile_image(x, config.image_normalization_method, config.norm_scale,
                                            config.image_normalization_parameters))
        split = False  # rows interleave left and right
    y = _denormalize(config, y)
    if plan.local_back_end:
        depth = resize_rows(y, plan.net_hw[0], plan.output_hw, (o0, o1), s0, plan.interp_method)
    else:
        depth = resize_rows(gather_height(mesh, y), plan.net_hw[0], plan.output_hw, (o0, o1), 0, plan.interp_method)
    if split:
        return torch.stack([depth[:n, 0], depth[n:, 0]], dim=1)
    return depth.reshape(n, 2, o1 - o0, plan.output_hw[1])


def make_spatial_predictor(config, unet_cfg: UNetConfig, mesh: Mesh, output_size, *, compute_dtype=torch.float32,
                           frame_size=None, use_kernel: Optional[bool] = None):
    """Single-frame latency scaling: one frame's HEIGHT split over the
    ranks, weights replicated (JAX's ``make_spatial_predictor``). Each
    rank runs the whole dual-frame graph on its band of rows
    (``spatial_band_plan`` for frames of frame_size, default output_size):
    the ``fused_preprocess_dual`` kernel on its frame rows where the bands'
    area windows are the global ones (use_kernel None: on CUDA), the
    composed front end over the global windows' rows otherwise; the U-Net
    through ``unet_apply(halo=...)``, one ``HeightHalo`` exchange before
    each of its 3x3 convs; the resize back on its own rows, or from the
    gathered net output where output windows straddle bands.

    Returns predict(params, batch_stats, frames_band, base_band) -> this
    rank's (N, 2, rows, W_out) mm depth: frames_band its
    ``plan.frame_rows`` of the (N, 6, H, W) frames (``shard_height``),
    base_band those rows of the base. predict.plan is the plan,
    predict.halo the exchange; ``gather_height`` stacks the bands."""
    plan = spatial_band_plan(mesh, tuple(frame_size or output_size), config.input_tactile_image_size, output_size,
                             unet_cfg, config.interp_method)
    halo = HeightHalo(mesh)

    @torch.inference_mode()
    def predict(params, batch_stats, frames_band, base_band):
        def net(x):
            return unet_apply(unet_cfg, params, batch_stats, x, compute_dtype=compute_dtype, halo=halo)[0]

        return _spatial_graph(config, plan, mesh, net, frames_band.to(mesh.device, torch.float32),
                              None if base_band is None else base_band.to(mesh.device, torch.float32), use_kernel)

    predict.plan, predict.halo = plan, halo
    return predict


def make_spatial_predictor_int8(config, mesh: Mesh, output_size, *, compute_dtype=torch.bfloat16, frame_size=None,
                                use_kernel: Optional[bool] = None):
    """Height-sharded serving of the int8 graph: ``make_spatial_predictor``
    with the QuantizedUNet's forward on each band, given a ``HeightHalo``:
    ``inc/conv1`` a float conv on the haloed band, each of the 17 quantized
    convs a ``conv2d_int8`` launch on the haloed int8 band (``up_j/conv1``
    reading skip and upconv output in place, both haloed), the max-pools
    per band. As ``make_dp_fused_predictor_int8``, the model comes at each
    call.

    Returns predict(q, frames_band, base_band) -> this rank's (N, 2, rows,
    W_out) mm depth."""
    plan = spatial_band_plan(mesh, tuple(frame_size or output_size), config.input_tactile_image_size, output_size,
                             config.unet_config(), config.interp_method)
    halo = HeightHalo(mesh)

    @torch.inference_mode()
    def predict(q, frames_band, base_band):
        def net(x):
            return q(x, compute_dtype, halo=halo)

        return _spatial_graph(config, plan, mesh, net, frames_band.to(mesh.device, torch.float32),
                              None if base_band is None else base_band.to(mesh.device, torch.float32), use_kernel)

    predict.plan, predict.halo = plan, halo
    return predict
