"""One rank of the port's data-parallel CPU tests, and the launcher that
starts the ranks.

    python tests/torch_parallel_worker.py <job> <rank> <world> <workdir>

Each rank joins a gloo group through a file store in workdir, builds a CPU
mesh, runs one job on its rows of inputs made with numpy from a seed (the
test builds the same inputs for the JAX package from the same functions),
and writes what it computed to workdir/<job>_<rank>.npz. The jobs:

- steps: the DP train step's gradients, and 2 steps, plain and masked
  with a padded tail; the DP eval step; make_dp_predict; the mesh's
  refusals;
- serving: DP fused float32 serving (shared base, per-frame base, rows
  that do not divide), DP int8 serving, the DP renderer;
- trainer: the DP Trainer, replicated and sharded, on the uneven 9/5/9/7
  objects of tests/multihost_worker.py, rebuilt with the port's own code;
- spatial: height-sharded float32 and int8 serving of one dual frame
  (make_spatial_predictor[_int8]) on each of SPATIAL_CASES, gathered.

The worker imports nothing of JAX.
"""

import datetime
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (8, 16, 32)
HW = (16, 21)
FRAME = (32, 43)
SERVE_CFG = dict(
    CNN_dimensions=DIMS, input_tactile_image_size=(16, 21), image_normalization_method="0_255_to_0_1",
    depth_normalization_method="min_max_to_0_-1", depth_normalization_parameters=(-1.9, 0.0), norm_scale=0.9,
    use_difference_image=True,
)
RENDER_KW = dict(image_size=(40, 53), mm_per_pixel=20.0 / 40.0, fill_iters=4)
# the trainer job: tests/multihost_worker.py's configuration and objects
TRAIN_DIMS = (8, 16)
TRAIN_CFG = dict(
    weights_name="mh", CNN_dimensions=TRAIN_DIMS, batch_size=8, input_tactile_image_size=(16, 21),
    image_normalization_method="0_255_to_0_1", depth_normalization_method="min_max_to_0_-1", norm_scale=0.9,
    use_difference_image=True, val_loss_SMA_window=3, validation_loss_count_threshold=20,
)
BAKE = dict(use_difference_image=True, image_normalization_method="0_255_to_0_1", norm_scale=0.9)
MAX_EPOCHS = 2
# the spatial job: tests/test_inference.py's small_config shapes, plus one
# whose level 1 has an odd 21 rows and one whose frame-to-net height ratio
# (84 -> 40) is not an integer; name -> (frame = output size, net size)
SPATIAL_DIMS = (8, 16, 32)
SPATIAL_CASES = {"small": ((80, 107), (40, 53)), "odd": ((84, 107), (42, 53)), "ratio": ((84, 107), (40, 53))}


# ----------------------------------------------------------------------------
# inputs, shared with the tests
# ----------------------------------------------------------------------------

def step_inputs():
    """Reference-layout weights and two batches of 8 for each mode; the
    masked mode's last batch holds 5 valid samples, its tail padded by
    repeating sample 0 as BatchIterator pads."""
    from tests.torch_fixture import make_state_dict

    rng = np.random.RandomState(42)
    sd = make_state_dict(rng, DIMS)
    batches = {}
    for mode in ("plain", "masked"):
        out = []
        for b in range(2):
            x = rng.uniform(0, 1, (8, 3, *HW)).astype(np.float32)
            y = rng.uniform(-0.9, 0, (8, 1, *HW)).astype(np.float32)
            m = np.ones(8, bool)
            if mode == "masked" and b == 1:
                m[5:] = False
                x[5:], y[5:] = x[0], y[0]
            out.append((x, y, m))
        batches[mode] = out
    return sd, batches


def serving_inputs():
    from tests.torch_fixture import make_state_dict

    rng = np.random.RandomState(21)
    sd = make_state_dict(rng, DIMS)
    frames = rng.uniform(0, 255, (8, 6, *FRAME)).astype(np.float32)
    base = rng.uniform(0, 255, (6, *FRAME)).astype(np.float32)
    bases = rng.uniform(0, 255, (8, 6, *FRAME)).astype(np.float32)
    return sd, frames, base, bases


def render_inputs():
    rng = np.random.RandomState(7)
    pc = rng.uniform(-8, 8, (4000, 3)).astype(np.float32)
    poses = rng.uniform(-0.002, 0.002, (6, 3)).astype(np.float32)
    widths = rng.uniform(10, 14, (6,)).astype(np.float32)
    return pc, poses, widths


def spatial_config(net_hw):
    return dict(CNN_dimensions=SPATIAL_DIMS, input_tactile_image_size=net_hw, image_normalization_method="0_255_to_0_1",
                depth_normalization_method="min_max_to_0_-1", depth_normalization_parameters=(-1.9180814027786255, 0.0),
                norm_scale=0.9, use_difference_image=True)


def spatial_inputs(frame_hw):
    """Weights, one dual frame, its base, and 4 calibration frames."""
    from tests.torch_fixture import make_state_dict

    rng = np.random.RandomState(77)
    sd = make_state_dict(rng, SPATIAL_DIMS)
    frames = rng.uniform(0, 255, (1, 6, *frame_hw)).astype(np.float32)
    base = rng.uniform(0, 255, (6, *frame_hw)).astype(np.float32)
    return sd, frames, base, rng.uniform(0, 255, (4, 6, *frame_hw)).astype(np.float32)


def make_all_objects():
    """tests/multihost_worker.py's objects, made by the port's
    make_synthetic_object (the same draws as the JAX package's)."""
    from gelslim_depth_tpu_torch.data.synthetic import make_synthetic_object

    rng = np.random.RandomState(7)
    objs = [make_synthetic_object(rng, n=n, image_size=FRAME) for n in (9, 5, 9, 7)]
    return objs, [make_synthetic_object(rng, n=n, image_size=FRAME) for n in (5, 4)]


def build_datasets(shard=None, device="cpu"):
    """shard=(rank, world) bakes that rank's round-robin objects with
    statistics reduced over the ranks; None bakes them all."""
    from gelslim_depth_tpu_torch import bake_dataset
    from gelslim_depth_tpu_torch.parallel import global_dataset_stats

    objs, val_objs = make_all_objects()
    kw = {}
    if shard is not None:
        objs, val_objs = objs[shard[0]::shard[1]], val_objs[shard[0]::shard[1]]
        kw["stats_reduce"] = global_dataset_stats
    train = bake_dataset(preloaded=objs, device=device, **BAKE, **kw)
    val = bake_dataset(preloaded=val_objs, device=device, **BAKE,
                       depth_normalization_parameters=train.depth_normalization_parameters,
                       image_normalization_parameters=train.image_normalization_parameters)
    return train, val


def start_weights(workdir):
    """The starting weights the test wrote (the JAX package's Trainer's own
    seed-0 initialization, in the reference layout)."""
    import torch

    with np.load(os.path.join(workdir, "start.npz")) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def run_trainer(output_dir, starting, mesh=None, sharded=False):
    from gelslim_depth_tpu_torch import GelslimConfig, Trainer

    train, val = build_datasets((mesh.rank, mesh.size) if sharded else None)
    trainer = Trainer(GelslimConfig(**TRAIN_CFG), train, val, val, output_dir=output_dir, device="cpu", mesh=mesh,
                      dataset_sharding="sharded" if sharded else "replicated", starting_weights=starting,
                      enable_plots=False, log_fn=lambda m: None)
    return trainer, trainer.fit(max_epochs=MAX_EPOCHS)


# ----------------------------------------------------------------------------
# jobs, each on one rank
# ----------------------------------------------------------------------------

def _flat(prefix, tree):
    return {f"{prefix}|{k}": v.numpy() for k, v in tree.items()}


def job_steps(mesh, workdir):
    import torch

    from gelslim_depth_tpu_torch.models.unet import UNetConfig, split_state_dict
    from gelslim_depth_tpu_torch.parallel import (
        gather_rows, global_batch_from_local, make_dp_eval_step, make_dp_predict, make_dp_train_step, make_mesh,
        replicate, shard_batch,
    )
    from gelslim_depth_tpu_torch.train import create_train_state, make_optimizer

    cfg = UNetConfig(layer_dimensions=DIMS)
    sd, batches = step_inputs()
    opt = make_optimizer(1e-3, 1e-6)
    out = {}
    for mode, masked in (("plain", False), ("masked", True)):
        p, s = split_state_dict(sd)
        state = replicate(mesh, create_train_state(cfg, opt, params=p, batch_stats=s))
        step = make_dp_train_step(cfg, opt, mesh, masked=masked)
        # Adam hides a gradient's scale, so the gradients are held directly
        x, y, m = shard_batch(mesh, batches[mode][-1])
        out.update(_flat(f"{mode}|grads", step.loss_and_grads(state, x, y, m if masked else None)[2]))
        losses = []
        for x, y, m in batches[mode]:
            xl, yl, ml = shard_batch(mesh, (x, y, m))
            state, loss = step(state, xl, yl, ml if masked else None)
            losses.append(loss.item())
        out[f"{mode}|losses"] = np.asarray(losses)
        out.update(_flat(f"{mode}|params", state.params))
        out.update(_flat(f"{mode}|stats", state.batch_stats))
        out.update(_flat(f"{mode}|ema", state.ema.shadow))
        out[f"{mode}|counters"] = np.asarray([int(state.step), int(state.opt_state.count),
                                              int(state.ema.num_updates)])
    x, y, m = batches["masked"][1]
    out["eval_loss"] = np.asarray(make_dp_eval_step(cfg, mesh, masked=True)(state, *shard_batch(mesh, (x, y, m))).item())
    predict = make_dp_predict(cfg, mesh)
    out["predict"] = gather_rows(mesh, predict(state.params, state.batch_stats, shard_batch(mesh, x))).numpy()
    # uneven rows: 7 over 2 ranks is 4 + 3, gathered back in order
    out["uneven"] = gather_rows(mesh, shard_batch(mesh, torch.arange(7.0))).numpy()
    refusals = []
    for call in (lambda: make_mesh(mesh.size * 2, device="cpu"),
                 lambda: global_batch_from_local(mesh, np.zeros((2 + mesh.rank, 3), np.float32))):
        try:
            call()
            refusals.append(0)
        except (RuntimeError, ValueError):
            refusals.append(1)
    out["refusals"] = np.asarray(refusals)
    return out


def job_serving(mesh, workdir):
    import torch

    from gelslim_depth_tpu_torch import GelslimConfig, Predictor
    from gelslim_depth_tpu_torch.meshgen import plane_spec
    from gelslim_depth_tpu_torch.models.unet import split_state_dict
    from gelslim_depth_tpu_torch.parallel import (
        gather_rows, make_dp_fused_predictor, make_dp_fused_predictor_int8, make_dp_renderer, replicate, shard_batch,
    )

    cfg = GelslimConfig(**SERVE_CFG)
    sd, frames, base, bases = serving_inputs()
    params, stats = replicate(mesh, split_state_dict(sd))
    dp = make_dp_fused_predictor(cfg, cfg.unet_config(), mesh, FRAME)
    out = {
        "float": gather_rows(mesh, dp(params, stats, shard_batch(mesh, frames), torch.from_numpy(base))),
        "float_bases": gather_rows(mesh, dp(params, stats, *shard_batch(mesh, (frames, bases)))),
        "float_uneven": gather_rows(mesh, dp(params, stats, shard_batch(mesh, frames[:7]), torch.from_numpy(base))),
    }
    q = Predictor(cfg, sd, device="cpu").quantize(frames[:4], base).q
    if mesh.rank:  # the broadcast must bring rank 0's model
        for t in q.state_dict().values():
            t.zero_()
    q = replicate(mesh, q)
    dq = make_dp_fused_predictor_int8(cfg, mesh, FRAME, compute_dtype=torch.float32)
    out["int8"] = gather_rows(mesh, dq(q, shard_batch(mesh, frames), torch.from_numpy(base)))
    pc, poses, widths = render_inputs()
    render = make_dp_renderer(mesh, spec=plane_spec("+y+z"), **RENDER_KW)
    out["render"] = gather_rows(mesh, render(pc, *shard_batch(mesh, (poses, widths))))
    return {k: v.numpy() for k, v in out.items()}


def job_trainer(mesh, workdir):
    out = {}
    for mode in ("replicated", "sharded"):
        trainer, history = run_trainer(os.path.join(workdir, f"{mode}_rank{mesh.rank}"), start_weights(workdir), mesh,
                                       mode == "sharded")
        for k, v in history.items():
            out[f"{mode}|{k}"] = np.asarray(v)
        out[f"{mode}|n_local"] = np.asarray(len(trainer.train_ds))
        out[f"{mode}|depth_norm"] = np.asarray(trainer.config.depth_normalization_parameters)
        out[f"{mode}|image_norm"] = np.asarray(trainer.config.image_normalization_parameters)
        out.update(_flat(f"{mode}|params", trainer.state.params))
    return out


def job_spatial(mesh, workdir):
    import torch

    from gelslim_depth_tpu_torch import GelslimConfig, Predictor
    from gelslim_depth_tpu_torch.models.unet import split_state_dict
    from gelslim_depth_tpu_torch.parallel import (
        gather_height, make_spatial_predictor, make_spatial_predictor_int8, replicate, shard_height,
    )

    out = {}
    for name, (frame_hw, net_hw) in SPATIAL_CASES.items():
        cfg = GelslimConfig(**spatial_config(net_hw))
        sd, frames, base, calib = spatial_inputs(frame_hw)
        params, stats = replicate(mesh, split_state_dict(sd))
        sp = make_spatial_predictor(cfg, cfg.unet_config(), mesh, frame_hw)
        band, base_band = shard_height(mesh, sp.plan, frames, base)
        out[f"{name}|float"] = gather_height(mesh, sp(params, stats, band, base_band))
        q = replicate(mesh, Predictor(cfg, sd, device="cpu").quantize(calib, base).q)
        sq = make_spatial_predictor_int8(cfg, mesh, frame_hw, compute_dtype=torch.float32)
        out[f"{name}|int8"] = gather_height(mesh, sq(q, band, base_band))
        out[f"{name}|exchanges"] = torch.tensor([sp.halo.exchanges, sq.halo.exchanges])
    return {k: v.numpy() for k, v in out.items()}


JOBS = {"steps": job_steps, "serving": job_serving, "trainer": job_trainer, "spatial": job_spatial}


def main():
    job, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from gelslim_depth_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(f"file://{os.path.join(workdir, job + '_store')}", world, rank, backend="gloo",
                         timeout=datetime.timedelta(seconds=120))
    try:
        out = JOBS[job](make_mesh(world, device="cpu", backend="gloo"), workdir)
        np.savez(os.path.join(workdir, f"{job}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# launcher, for the tests
# ----------------------------------------------------------------------------

def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(argvs, timeout: float, env_extra=None):
    """Start one process per argv, wait for all of them, and return their
    logs. The first to fail (or the deadline) kills the rest, so a dead
    rank never leaves its peers blocked in a collective; raises with every
    log on a failure."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(env_extra or {}))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(a, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO)
             for a in argvs]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(f"--- process {i} rc {p.returncode}\n{log[-4000:]}"
                                       for i, (p, log) in enumerate(zip(procs, logs))))
    return logs


def spawn(job: str, workdir, world: int = 2, timeout: float = 180):
    """Run job on world ranks; returns each rank's outputs."""
    launch([[sys.executable, os.path.abspath(__file__), job, str(r), str(world), str(workdir)]
            for r in range(world)], timeout)
    return [dict(np.load(os.path.join(workdir, f"{job}_{r}.npz"))) for r in range(world)]


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
