"""Multi-process execution over ``torch.distributed``, one process per rank:
the port of ``gelslim_depth_tpu/parallel/multihost.py``.

JAX runs one process per host and shards a global array over every
device; here every rank is a process that owns one device and holds its
own contiguous rows ``[r*per, (r+1)*per)`` of each global batch, the
layout ``process_local_rows`` defines. The collectives are explicit and
few (``parallel/mesh.py``, ``train/steps.py``): an all-reduce of the
batch-norm sums, of the loss and of the gradients, and a broadcast for
``replicate``. Every one of them is an all-reduce or a broadcast, the two
that gloo also runs on CUDA tensors.

Launch, one command per rank (``torchrun`` sets the environment that
``initialize()`` reads with no arguments):

    torchrun --nproc_per_node 4 -m gelslim_depth_tpu_torch train <name> --data_parallel
    python -m gelslim_depth_tpu_torch train <name> --data_parallel \\
        --coordinator_address <host0>:29500 --num_processes <n> --process_id <i>

The backend is NCCL for CUDA tensors and gloo for CPU ones.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
# what torchrun (and most launchers) export to every rank
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def is_initialized() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def default_backend() -> str:
    """NCCL for CUDA tensors and gloo for CPU tensors where this build has
    NCCL and the process sees a card; gloo alone otherwise."""
    if dist.is_nccl_available() and torch.cuda.is_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def _init(url: str, world: int, rank: int, backend: Optional[str], timeout) -> None:
    dist.init_process_group(backend or default_backend(), init_method=url, world_size=world, rank=rank,
                            timeout=timeout)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group, tolerant of single-process runs; a no-op
    once initialized.

    coordinator_address is ``host:port`` (rank 0 listens there) or a
    ``torch.distributed`` URL such as ``file:///shared/store``; it needs
    num_processes and process_id. With no arguments it joins when the
    environment names a cluster: a launcher's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (torchrun), or a SLURM job
    of several tasks (``SLURM_PROCID``, ``SLURM_NTASKS``, with
    ``MASTER_ADDR`` and ``MASTER_PORT`` exported); with none of them it does
    nothing. num_processes or process_id without a coordinator raises, and
    so does an environment that names a cluster but not all of it, and a
    group that does not form within timeout: the alternative is N
    independent trainings that each believe they are rank 0."""
    if is_initialized():
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "multihost.initialize: coordinator_address needs num_processes and process_id "
                "(torch.distributed has no way to discover them)"
            )
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        _init(url, int(num_processes), int(process_id), backend, timeout)
        return
    if num_processes is not None or process_id is not None:
        raise ValueError(
            "multihost.initialize: num_processes/process_id were given without "
            "coordinator_address; refusing to fall back to single-process mode. Pass "
            "coordinator_address=<host0>:<port>, or launch with torchrun and no arguments."
        )
    env = os.environ
    if "RANK" in env or "WORLD_SIZE" in env:
        missing = [k for k in LAUNCHER_ENV if k not in env]
        if missing:
            raise RuntimeError(f"multihost.initialize: the environment names a cluster but lacks {missing}")
        _init("env://", int(env["WORLD_SIZE"]), int(env["RANK"]), backend, timeout)
    elif "SLURM_JOB_ID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError(
                f"multihost.initialize: SLURM job of {env['SLURM_NTASKS']} tasks without MASTER_ADDR and "
                "MASTER_PORT; export them (rank 0's host and a free port) or pass coordinator_address"
            )
        _init(f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["SLURM_NTASKS"]),
              int(env["SLURM_PROCID"]), backend, timeout)


def _rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_local_indices(n_global: int, *, process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> np.ndarray:
    """Contiguous per-process slice of range(n_global); the last process
    takes the remainder."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    per = n_global // pc
    start = pi * per
    end = n_global if pi == pc - 1 else start + per
    return np.arange(start, end)


def process_local_rows(global_batch_size: int, *, process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> slice:
    """The contiguous rows of a global batch that this process feeds: rank
    r holds ``[r*per, (r+1)*per)``. The global batch must divide evenly
    (the Trainer pads its batches to a multiple of the world size)."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    if global_batch_size % pc:
        raise ValueError(f"global batch {global_batch_size} not divisible by {pc} processes")
    per = global_batch_size // pc
    return slice(pi * per, (pi + 1) * per)


def _collective_device() -> torch.device:
    """Where a collective on host data runs: the CPU under gloo, the
    current card under NCCL alone."""
    return torch.device("cpu") if "gloo" in str(dist.get_backend()) else torch.device(
        "cuda", torch.cuda.current_device())


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of x, concatenated in rank order, on every rank;
    row counts may differ. Built on one
    all-reduce of the counts and one of a zero-filled buffer that holds
    each rank's rows at its offset (adding zeros is exact), so it runs on
    gloo with CUDA tensors as on NCCL."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    counts = torch.zeros(world, dtype=torch.int64, device=x.device)
    counts[rank] = x.shape[0]
    dist.all_reduce(counts, group=group)
    counts = counts.tolist()
    start = sum(counts[:rank])
    out = x.new_zeros((sum(counts), *x.shape[1:]))
    out[start:start + x.shape[0]] = x
    dist.all_reduce(out, group=group)
    return out


def global_dataset_stats(tactile_local: np.ndarray, depth_local: np.ndarray):
    """Dataset-global normalization statistics from per-process shards.

    Each process passes its raw (pre-normalization) baked arrays, tactile
    (n_local, C, h, w) and depth (n_local, 1, h, w). Their moments (count,
    sum, sum of squares, min, max) in float64 are gathered from every rank
    and combined, so every process freezes the same statistics, those of
    the union dataset: depth (min, max, mean, unbiased std) over all values
    and the image's per-channel lists, as ``bake_dataset`` takes them. The
    unbiased std comes from the moment formula in float64, equal to numpy's
    ddof=1 up to float64 rounding. Pass it to ``bake_dataset`` as
    stats_reduce. Single-process: the local statistics."""
    c = tactile_local.shape[1]
    tac = tactile_local.astype(np.float64)
    dep = depth_local.astype(np.float64)
    parts = [[x.size, x.sum(), np.square(x).sum(), x.min(), x.max()] for x in (tac[:, i] for i in range(c))]
    parts.append([dep.size, dep.sum(), np.square(dep).sum(), dep.min(), dep.max()])
    local = torch.as_tensor(np.asarray(parts, np.float64))[None]  # (1, c+1, 5)
    if _world() > 1:
        gathered = all_gather_rows(local.to(_collective_device())).cpu().numpy()  # (P, c+1, 5)
    else:
        gathered = local.numpy()

    def combine(rows):  # rows: (P, 5) -> (min, max, mean, unbiased std)
        n, s, sq = rows[:, 0].sum(), rows[:, 1].sum(), rows[:, 2].sum()
        mean = s / n
        var = (sq - n * mean * mean) / (n - 1)
        return float(rows[:, 3].min()), float(rows[:, 4].max()), float(mean), float(np.sqrt(max(var, 0.0)))

    img = [combine(gathered[:, i]) for i in range(c)]
    dmin, dmax, dmean, dstd = combine(gathered[:, c])
    image_params = ([v[0] for v in img], [v[1] for v in img], [v[2] for v in img], [v[3] for v in img])
    return (dmin, dmax, dmean, dstd), image_params


def global_batch_from_local(mesh, local_batch) -> torch.Tensor:
    """This rank's rows of a global batch, on the rank's device, after
    checking that every rank of the mesh feeds the same row count (the
    collectives of a step are synchronous, so a rank short of rows would
    change the global batch)."""
    x = torch.as_tensor(local_batch)
    if mesh.group is not None:
        counts = all_gather_rows(torch.tensor([x.shape[0]], device=mesh.device), mesh.group).tolist()
        if len(set(counts)) > 1:
            raise ValueError(f"global_batch_from_local: ranks feed unequal row counts {counts}")
    return x.to(mesh.device)
