#!/usr/bin/env python3
"""Data-parallel scaling of the PyTorch port over the cards of one host:
one process a card, NCCL (``gelslim_depth_tpu_torch.parallel``).

    python3 scripts/time_torch_dp.py            # every visible card
    python3 scripts/time_torch_dp.py --world 2

Starts one rank a card (children of this script, joined over
tcp://localhost; a rank that fails prints its log's tail and fails the
run). Rank 0 first times ``TrainStep`` alone on its card, at the flagship
dims and 16 rows (the reference's batch); then every rank times the DP
step at 16 rows a rank (a global batch of 16 x world), f32 and bf16, and
DP bf16 and int8 serving of 64 dual frames a rank. Times are host-clock
medians of calls that end in a synchronize, so a DP step's time includes
its collectives. Each step is also traced: its device busy ms and the NCCL
kernels' device ms and share of the device op time (a torch.profiler
trace of 3 calls on every rank), and, for bf16, a host-only trace of 5
calls (``TrainStep`` on rank 0 and the DP step on every rank): host ms a
call and the HOST_TOP ops by self CPU ms. Prints the card and its power
limit, then one JSON line: per-rank times and traces, global finger
images/s and dual frames/s, and the scaling efficiency against one card.
Checks that every DP loss is finite and the ranks' parameters are equal
bit for bit.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import device_profile, host_ms, launch, seeded_state_dict  # noqa: E402
from gelslim_depth_tpu_torch import Predictor, parallel  # noqa: E402
from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object  # noqa: E402
from gelslim_depth_tpu_torch.entry import flagship_config  # noqa: E402
from gelslim_depth_tpu_torch.models.unet import split_state_dict  # noqa: E402
from gelslim_depth_tpu_torch.train import create_train_state, make_optimizer, make_train_step  # noqa: E402

ROWS = 16  # train rows a rank
FRAMES = 64  # dual frames a rank
FRAME = (320, 427)
HOST_TOP = 12  # host ops listed in a host trace, by self CPU time
NCCL_KEYS = {"nccl": ("nccl",)}


def batch(world, device):
    """A global train batch of ROWS x world finger samples from seeded
    synthetic 320x427 objects, normalized as the flagship trains."""
    from gelslim_depth_tpu_torch import bake_dataset

    rng = np.random.RandomState(0)
    n_obj = -(-ROWS * world // 16)
    ds = bake_dataset(preloaded=[make_synthetic_object(rng, 8, FRAME) for _ in range(n_obj)], device=device,
                      use_difference_image=True, image_normalization_method="0_255_to_0_1", norm_scale=0.9)
    return ds.tactile_image[:ROWS * world], ds.depth_image[:ROWS * world]


def host_profile(fn, calls: int = 5) -> dict:
    """A host-only torch.profiler trace of `calls` calls, each ending in a
    synchronize, after 2 warm-ups: host ms a call under the profiler, the
    self CPU ms of every op a call summed, and the HOST_TOP ops by self CPU
    ms a call as [name, ms, count a call]."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = prof.key_averages()
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:HOST_TOP]
    return {"host_ms": 1e3 * wall / calls, "self_cpu_ms": sum(e.self_cpu_time_total for e in ops) / calls / 1e3,
            "top": [[e.key, e.self_cpu_time_total / calls / 1e3, e.count / calls] for e in top]}


def traced(rec, key, fn, host_trace):
    """rec[key + '_device_ms'], the NCCL kernels' device ms and share, and
    with host_trace rec[key + '_host_trace']; every rank of a DP step must
    call this alike, since each traced call runs the step's collectives."""
    prof = device_profile(fn, calls=3, op_keys=NCCL_KEYS, other="rest")
    rec[f"{key}_device_ms"], rec[f"{key}_nccl_ms"], rec[f"{key}_nccl_share"] = (
        (None, None, None) if prof is None else (prof[0], prof[4]["nccl"], prof[3]["nccl"]))
    if host_trace:
        rec[f"{key}_host_trace"] = host_profile(fn)


def rank_main(rank, world, port, out_path):
    parallel.initialize(f"localhost:{port}", world, rank, timeout=datetime.timedelta(seconds=600))
    mesh = parallel.make_mesh(world)
    cfg = flagship_config()
    ucfg = cfg.unet_config()
    x, y = batch(world, mesh.device)
    mask = torch.ones(len(x), dtype=torch.bool, device=mesh.device)
    rec = {"rank": rank, "device": str(mesh.device), "backend": torch.distributed.get_backend()}
    if rank == 0:  # one card alone, the others waiting at the barrier below
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            opt = make_optimizer()
            step = make_train_step(ucfg, opt, compute_dtype=dtype, masked=True)
            state = create_train_state(ucfg, opt, generator=torch.Generator().manual_seed(2), device=mesh.device)
            run = lambda: step(state, x[:ROWS], y[:ROWS], mask[:ROWS])  # noqa: E731
            rec[f"single_step_{name}_ms"] = host_ms(run, reps=5, warmup=2)
            traced(rec, f"single_step_{name}", run, name == "bf16")
            del run, state, step
            torch.cuda.empty_cache()
    torch.distributed.barrier()
    rows = mesh.rows(len(x))
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        opt = make_optimizer()
        dp = parallel.make_dp_train_step(ucfg, opt, mesh, compute_dtype=dtype, masked=True)
        state = parallel.replicate(mesh, create_train_state(ucfg, opt, generator=torch.Generator().manual_seed(2),
                                                            device=mesh.device))
        new, loss = dp(state, x[rows], y[rows], mask[rows])
        flat = torch.cat([v.reshape(-1) for v in new.params.values()])
        gathered = parallel.gather_rows(mesh, flat[None])
        if not (np.isfinite(loss.item()) and all(torch.equal(gathered[0], g) for g in gathered[1:])):
            raise SystemExit(f"rank {rank}: DP {name} step: loss {loss.item()}, ranks' parameters differ")
        del new, flat, gathered
        run = lambda: dp(state, x[rows], y[rows], mask[rows])  # noqa: E731
        rec[f"dp_step_{name}_ms"] = host_ms(run, reps=5, warmup=2)
        traced(rec, f"dp_step_{name}", run, name == "bf16")
        del state, dp, run
        torch.cuda.empty_cache()
    sd = seeded_state_dict(ucfg, 0)
    params, stats = parallel.replicate(mesh, split_state_dict(sd))
    g = torch.Generator(device=mesh.device).manual_seed(8 + rank)
    frames = torch.rand((FRAMES, 6, *FRAME), generator=g, device=mesh.device) * 255.0
    base = torch.rand((6, *FRAME), generator=g, device=mesh.device) * 255.0
    dp16 = parallel.make_dp_fused_predictor(cfg, ucfg, mesh, FRAME, compute_dtype=torch.bfloat16)
    q = Predictor(cfg, sd, compute_dtype=torch.bfloat16, device=mesh.device).quantize(frames[:4], base).q
    dq = parallel.make_dp_fused_predictor_int8(cfg, mesh, FRAME, compute_dtype=torch.bfloat16)
    torch.distributed.barrier()
    rec["dp_serve_bf16_ms"] = host_ms(lambda: dp16(params, stats, frames, base))
    rec["dp_serve_int8_ms"] = host_ms(lambda: dq(q, frames, base))
    with open(out_path, "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def main():
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA cards")
    world = int(sys.argv[sys.argv.index("--world") + 1]) if "--world" in sys.argv else torch.cuda.device_count()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    with tempfile.TemporaryDirectory() as out_dir:
        outs = [os.path.join(out_dir, f"rank{r}.json") for r in range(world)]
        launch([[sys.executable, os.path.abspath(__file__), "--rank", str(r), str(world), str(port), outs[r]]
                for r in range(world)], 900, out_dir, "rank")
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    r0 = ranks[0]
    summary = {"world": world, "kind": torch.cuda.get_device_name(0), "ranks": ranks}
    for name in ("f32", "bf16"):
        single, dp = r0[f"single_step_{name}_ms"], max(r[f"dp_step_{name}_ms"] for r in ranks)
        summary[f"train_{name}"] = {
            "single_finger_images_per_s": 1e3 * ROWS / single,
            "dp_finger_images_per_s": 1e3 * ROWS * world / dp,
            "scaling_efficiency": (ROWS * world / dp) / (ROWS / single) / world,
            "single_device_ms": r0[f"single_step_{name}_device_ms"],
            "dp_device_ms_by_rank": [r[f"dp_step_{name}_device_ms"] for r in ranks],
            "dp_nccl_ms_by_rank": [r[f"dp_step_{name}_nccl_ms"] for r in ranks],
            "dp_nccl_share_by_rank": [r[f"dp_step_{name}_nccl_share"] for r in ranks],
        }
    for name in ("bf16", "int8"):
        summary[f"serve_{name}_dual_frames_per_s"] = 1e3 * FRAMES * world / max(r[f"dp_serve_{name}_ms"] for r in ranks)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
