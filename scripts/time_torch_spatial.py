#!/usr/bin/env python3
"""Height-sharded serving of the PyTorch port (``parallel.make_spatial_predictor[_int8]``)
over the cards of one host: the latency of ONE flagship dual frame (N=1)
split over 1, 2 and 4 cards, one process a card, NCCL.

    python3 scripts/time_torch_spatial.py               # worlds 1, 2, 4 (those the visible cards allow)
    python3 scripts/time_torch_spatial.py --worlds 1 2

For each world it starts one rank a card (children of this script through
``chip_smoke.launch``, joined over tcp://localhost; a rank that fails
fails the run). Rank 0 first times the unsharded ``Predictor`` (f32,
bf16) and ``QuantizedPredictor`` (int8, bf16 compute) N=1 calls alone on
its card; then every rank times its band of the spatial f32, bf16 and
int8 calls. For each: the host-clock median of ROUNDS rounds of CALLS
calls that end in a synchronize (their median and range), the device busy
ms a call and idle share (a torch.profiler trace of 10 calls on every
rank), the NCCL kernels' device ms a call, the halo exchanges a call, and
their host ms alone (the call's exchanges replayed on zero tensors of the
same shapes, ending in a synchronize). Checks that rank 0's gathered f32
depth is within rtol 1e-4 / atol 1e-5 mm of ``Predictor``'s. Prints the
card and its power limit, then one JSON line.
"""

import datetime
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import device_profile, launch, seeded_state_dict  # noqa: E402
from gelslim_depth_tpu_torch import Predictor, parallel  # noqa: E402
from gelslim_depth_tpu_torch.entry import flagship_config  # noqa: E402
from gelslim_depth_tpu_torch.inference import QuantizedPredictor  # noqa: E402
from gelslim_depth_tpu_torch.models.unet import split_state_dict  # noqa: E402

FRAME = (320, 427)
ROUNDS, CALLS = 5, 20
NCCL_KEYS = {"nccl": ("nccl",)}


def rounds_ms(fn) -> dict:
    """Host ms of one call: the median of each of ROUNDS rounds of CALLS
    calls, each call ending in a synchronize, after 3 warm-ups; returns
    their median and range."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    medians = []
    for _ in range(ROUNDS):
        times = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        medians.append(statistics.median(times))
    return {"median_ms": statistics.median(medians), "range_ms": [min(medians), max(medians)]}


def profiled(fn) -> dict:
    prof = device_profile(fn, calls=10, op_keys=NCCL_KEYS, other="rest")
    if prof is None:
        return {"device_busy_ms": None, "idle_share": None, "nccl_device_ms": None}
    return {"device_busy_ms": prof[0], "idle_share": prof[1], "nccl_device_ms": prof[4]["nccl"]}


def record_exchanges(fn):
    """The (shape, dtype, dim) of each halo exchange of one call of fn
    (every rank calls it, so the collectives pair up)."""
    calls, exchange = [], parallel.HeightHalo.__call__

    def recording(self, x, dim):
        calls.append((tuple(x.shape), x.dtype, dim))
        return exchange(self, x, dim)

    parallel.HeightHalo.__call__ = recording
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        parallel.HeightHalo.__call__ = exchange
    return calls


def exchanges_ms(mesh, calls) -> float:
    """Host ms of the exchanges of one call alone, replayed on zeros."""
    halo = parallel.HeightHalo(mesh)
    xs = [(torch.zeros(shape, dtype=dtype, device=mesh.device), dim) for shape, dtype, dim in calls]
    return rounds_ms(lambda: [halo(x, dim) for x, dim in xs])["median_ms"]


def rank_main(rank, world, port, out_path):
    parallel.initialize(f"localhost:{port}", world, rank, timeout=datetime.timedelta(seconds=600))
    mesh = parallel.make_mesh(world)
    cfg = flagship_config()
    ucfg = cfg.unet_config()
    sd = seeded_state_dict(ucfg, 0)
    g = torch.Generator(device=mesh.device).manual_seed(9)
    frame = torch.rand((1, 6, *FRAME), generator=g, device=mesh.device) * 255.0
    base = torch.rand((6, *FRAME), generator=g, device=mesh.device) * 255.0
    q = Predictor(cfg, sd, device=mesh.device).quantize(frame.expand(4, -1, -1, -1), base).q
    q = parallel.replicate(mesh, q)
    rec = {"rank": rank, "device": str(mesh.device), "backend": torch.distributed.get_backend()}
    preds = {"f32": Predictor(cfg, sd, device=mesh.device),
             "bf16": Predictor(cfg, sd, compute_dtype=torch.bfloat16, device=mesh.device),
             "int8": QuantizedPredictor(cfg, q, compute_dtype=torch.bfloat16, device=mesh.device)}
    if rank == 0:  # one card alone, the others waiting at the barrier below
        for name, pred in preds.items():
            fn = lambda: pred.predict_dual_frames(frame, base, FRAME)  # noqa: E731
            rec[f"unsharded_{name}"] = {**rounds_ms(fn), **profiled(fn)}
    torch.distributed.barrier()
    params, stats = parallel.replicate(mesh, split_state_dict(sd))
    spatial = {"f32": parallel.make_spatial_predictor(cfg, ucfg, mesh, FRAME),
               "bf16": parallel.make_spatial_predictor(cfg, ucfg, mesh, FRAME, compute_dtype=torch.bfloat16),
               "int8": parallel.make_spatial_predictor_int8(cfg, mesh, FRAME, compute_dtype=torch.bfloat16)}
    band, base_band = parallel.shard_height(mesh, spatial["f32"].plan, frame, base)
    rec["net_rows"] = spatial["f32"].plan.net_rows[rank]
    for name, sp in spatial.items():
        args = (q,) if name == "int8" else (params, stats)
        fn = lambda: sp(*args, band, base_band)  # noqa: E731
        if name == "f32":
            got = parallel.gather_height(mesh, fn())
            if rank == 0:
                want = preds["f32"].predict_dual_frames(frame, base, FRAME)
                rec["f32_max_abs_diff_mm"] = (got - want).abs().max().item()
                if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
                    raise SystemExit(f"spatial f32 vs Predictor: max|diff| {rec['f32_max_abs_diff_mm']} mm")
        calls = record_exchanges(fn)
        rec[f"spatial_{name}"] = {**rounds_ms(fn), **profiled(fn), "exchanges_a_call": len(calls),
                                  "exchanges_host_ms": exchanges_ms(mesh, calls)}
    with open(out_path, "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def main():
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA cards")
    cards = torch.cuda.device_count()
    if "--worlds" in sys.argv:
        worlds = [int(w) for w in sys.argv[sys.argv.index("--worlds") + 1:]]
    else:
        worlds = [w for w in (1, 2, 4) if w <= cards]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    summary = {"kind": torch.cuda.get_device_name(0), "cards": card.splitlines(), "worlds": {}}
    for world in worlds:
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        with tempfile.TemporaryDirectory() as out_dir:
            outs = [os.path.join(out_dir, f"rank{r}.json") for r in range(world)]
            launch([[sys.executable, os.path.abspath(__file__), "--rank", str(r), str(world), str(port), outs[r]]
                    for r in range(world)], 900, out_dir, f"world{world}_rank")
            ranks = []
            for path in outs:
                with open(path) as f:
                    ranks.append(json.load(f))
        summary["worlds"][world] = {"ranks": ranks}
        print(f"world {world}: " + "; ".join(
            f"{name} N=1 {max(r[f'spatial_{name}']['median_ms'] for r in ranks):.3f} ms (unsharded "
            f"{ranks[0][f'unsharded_{name}']['median_ms']:.3f})" for name in ("f32", "bf16", "int8")), flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
