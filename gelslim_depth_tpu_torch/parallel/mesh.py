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
that want the whole batch. The height-sharded predictors
(``make_spatial_predictor[_int8]``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from gelslim_depth_tpu_torch.models.unet import UNetConfig, unet_apply
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
