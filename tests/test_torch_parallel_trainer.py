"""The port's data-parallel Trainer on 2 gloo ranks on the CPU
(tests/torch_parallel_worker.py, job 'trainer'), in the replicated and the
sharded mode, on tests/multihost_worker.py's uneven 9/5/9/7 objects rebuilt
with the port's own code, and the CLI's ``train --data_parallel`` in 2
processes.

Bars (tests/test_multihost.py): both ranks' histories within rtol 1e-6;
the histories within rtol 1e-4 / atol 1e-6 of the port's single-process
Trainer (replicated: the same global batches; sharded: a single-process run
of the sharded schedule, each step the ranks' rows side by side) and of the
JAX package's DP Trainer on the same data, from the same weights (the JAX
Trainer's seed-0 initialization) (replicated: on make_mesh(2) in this
process; sharded: its own 2-process worker, tests/multihost_worker.py,
whose global batches are the ranks' side by side too); the sharded run's
frozen statistics those of the union dataset (rtol 1e-10 against the
port's single-process bake, as tests/test_multihost.py holds JAX's moment
formula); only rank 0 writes weights/.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from gelslim_depth_tpu import parallel as jax_parallel
from gelslim_depth_tpu.data.dataset import bake_dataset as jax_bake
from gelslim_depth_tpu.config import GelslimConfig as JaxConfig
from gelslim_depth_tpu.train import Trainer as JaxTrainer
from gelslim_depth_tpu.train import create_train_state as jax_create_train_state
from gelslim_depth_tpu.train import make_optimizer as jax_make_optimizer
from gelslim_depth_tpu_torch import bake_dataset
from gelslim_depth_tpu_torch.data.synthetic import write_synthetic_dataset_tree
from gelslim_depth_tpu_torch.models import params_from_jax
from gelslim_depth_tpu_torch.models.unet import UNetConfig, split_state_dict
from gelslim_depth_tpu_torch.parallel import global_dataset_stats
from gelslim_depth_tpu_torch.train import make_eval_step, make_train_step
from gelslim_depth_tpu_torch.train.loop import sharded_epoch_indices
from gelslim_depth_tpu_torch.train.steps import eval_epoch, train_epoch
from tests import torch_parallel_worker as worker
from tests.torch_port_helpers import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("train_loss", "validation_loss", "test_loss")
HIST_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 2 ranks and the JAX package's 2-process sharded run,
    started together."""
    work = tmp_path_factory.mktemp("trainer")
    # every run starts from the JAX Trainer's own seed-0 initialization
    jcfg = JaxConfig(**worker.TRAIN_CFG)
    jstate = jax_create_train_state(jax.random.PRNGKey(0), jcfg.unet_config(), jax_make_optimizer(
        jcfg.training_learning_rate, jcfg.weight_decay))
    start = params_from_jax(jstate.params, jstate.batch_stats, UNetConfig(layer_dimensions=worker.TRAIN_DIMS))
    np.savez(work / "start.npz", **{k: v.numpy() for k, v in start.items()})
    jax_dir = work / "jax"
    jax_dir.mkdir()
    port = worker.free_port()
    argvs = [[sys.executable, os.path.abspath(worker.__file__), "trainer", str(r), "2", str(work)] for r in range(2)]
    argvs += [[sys.executable, os.path.join(REPO, "tests", "multihost_worker.py"), str(pid), "2", str(port),
               str(jax_dir / f"history_{pid}.json"), str(jax_dir), "sharded"] for pid in range(2)]
    worker.launch(argvs, timeout=300, env_extra={"JAX_PLATFORMS": "cpu"})
    ranks = [dict(np.load(work / f"trainer_{r}.npz")) for r in range(2)]
    jax_sharded = []
    for pid in range(2):
        with open(jax_dir / f"history_{pid}.json") as f:
            jax_sharded.append(json.load(f))
    return work, ranks, jax_sharded


def _history(out, mode):
    return {k: out[f"{mode}|{k}"] for k in KEYS}


def _assert_histories(got, want, tol):
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_ranks_agree_and_only_rank_0_writes(runs, mode):
    work, ranks, _ = runs
    _assert_histories(_history(ranks[1], mode), _history(ranks[0], mode), dict(rtol=1e-6))
    for k in ranks[0]:
        if k.startswith(f"{mode}|params|"):
            assert np.array_equal(ranks[0][k], ranks[1][k]), k
    assert (work / f"{mode}_rank0" / "weights" / "mh.npz").exists()
    assert not (work / f"{mode}_rank1").exists()
    tl = ranks[0][f"{mode}|train_loss"]
    assert np.isfinite(tl).all() and tl[-1] < tl[0]


def test_replicated_matches_single_process_and_jax_dp(runs, tmp_path):
    work, ranks, _ = runs
    got = _history(ranks[0], "replicated")
    _, single = worker.run_trainer(str(tmp_path / "single"), worker.start_weights(work))
    _assert_histories(got, single, HIST_TOL)

    from gelslim_depth_tpu.data.synthetic import make_synthetic_object as jax_make_object

    rng = np.random.RandomState(7)
    objs = [jax_make_object(rng, n=n, image_size=worker.FRAME) for n in (9, 5, 9, 7)]
    val_objs = [jax_make_object(rng, n=n, image_size=worker.FRAME) for n in (5, 4)]
    train = jax_bake(preloaded=objs, **worker.BAKE)
    val = jax_bake(preloaded=val_objs, **worker.BAKE,
                   depth_normalization_parameters=train.depth_normalization_parameters,
                   image_normalization_parameters=train.image_normalization_parameters)
    jt = JaxTrainer(JaxConfig(**worker.TRAIN_CFG), train, val, val, output_dir=str(tmp_path / "jax"),
                    mesh=jax_parallel.make_mesh(2), enable_plots=False, log_fn=lambda m: None)
    _assert_histories(got, jt.fit(max_epochs=worker.MAX_EPOCHS), HIST_TOL)


def _sharded_schedule_single_process(start):
    """The sharded run's epochs on one process: each rank's shard baked
    with the union's statistics, each step the ranks' rows side by side
    (rank 0's first) through the single-device masked steps."""
    from gelslim_depth_tpu_torch import GelslimConfig
    from gelslim_depth_tpu_torch.train import create_train_state, make_optimizer

    objs, val_objs = worker.make_all_objects()
    union = bake_dataset(preloaded=objs, device="cpu", **worker.BAKE)
    norm = dict(depth_normalization_parameters=union.depth_normalization_parameters,
                image_normalization_parameters=union.image_normalization_parameters)
    shards = {name: [bake_dataset(preloaded=o[r::2], device="cpu", **worker.BAKE, **norm) for r in range(2)]
              for name, o in (("train", objs), ("val", val_objs))}
    cfg = GelslimConfig(**worker.TRAIN_CFG)
    opt = make_optimizer(cfg.training_learning_rate, cfg.weight_decay)
    state = create_train_state(cfg.unet_config(), opt, params=start[0], batch_stats=start[1])
    step = make_train_step(cfg.unet_config(), opt, masked=True)
    evaluate = make_eval_step(cfg.unet_config(), masked=True)
    local_bs = cfg.batch_size // 2

    def epoch(name, seed):
        ds = shards[name]
        n_steps = max(-(-max(len(d) for d in ds) // local_bs), 1)
        parts = [sharded_epoch_indices(len(d), n_steps, local_bs, seed + 7919 * r) for r, d in enumerate(ds)]
        perm = np.concatenate([parts[0][0], parts[1][0] + len(ds[0])], axis=1)
        masks = np.concatenate([parts[0][1], parts[1][1]], axis=1)
        images = torch.cat([d.tactile_image for d in ds])
        depths = torch.cat([d.depth_image for d in ds])
        return images, depths, perm, masks

    history = {k: [] for k in KEYS}
    for e in range(worker.MAX_EPOCHS):
        state, loss = train_epoch(step, state, *epoch("train", 1000 + e))
        history["train_loss"].append(float(loss))
        history["validation_loss"].append(float(eval_epoch(evaluate, state, *epoch("val", 2000 + e))))
        history["test_loss"].append(float(eval_epoch(evaluate, state, *epoch("val", 3000 + e))))
    return union, history


def test_sharded_matches_single_process_schedule_and_jax(runs):
    work, ranks, jax_sharded = runs
    got = _history(ranks[0], "sharded")
    # disjoint, uneven shards: 9 + 9 and 5 + 7 samples, two fingers each
    assert sorted(int(r["sharded|n_local"]) for r in ranks) == [24, 36]
    union, single = _sharded_schedule_single_process(split_state_dict(worker.start_weights(work)))
    np.testing.assert_allclose(ranks[0]["sharded|depth_norm"], union.depth_normalization_parameters, rtol=1e-10)
    np.testing.assert_allclose(ranks[0]["sharded|image_norm"], np.asarray(union.image_normalization_parameters),
                               rtol=1e-10)
    _assert_histories(got, single, HIST_TOL)
    assert sorted(h["n_local"] for h in jax_sharded) == [24, 36]
    np.testing.assert_allclose(jax_sharded[0]["depth_norm_params"], union.depth_normalization_parameters, rtol=1e-5)
    _assert_histories(got, jax_sharded[0], HIST_TOL)


def test_global_dataset_stats_single_process_matches_bake():
    objs, _ = worker.make_all_objects()
    plain = bake_dataset(preloaded=objs, device="cpu", **worker.BAKE)
    reduced = bake_dataset(preloaded=objs, device="cpu", stats_reduce=global_dataset_stats, **worker.BAKE)
    np.testing.assert_allclose(reduced.depth_normalization_parameters, plain.depth_normalization_parameters,
                               rtol=1e-10)
    for a, b in zip(reduced.image_normalization_parameters, plain.image_normalization_parameters):
        np.testing.assert_allclose(a, b, rtol=1e-10)


def test_cli_train_data_parallel_two_processes(tmp_path):
    """train --data_parallel for one epoch through --coordinator_address (a
    file store), 2 processes on the CPU over gloo: rc 0 each, the checkpoint
    and the log from rank 0 alone, and the two ranks' logs the same epoch
    line."""
    root = tmp_path / "data"
    write_synthetic_dataset_tree(str(root), n_per_object=5, image_size=worker.FRAME, seed=0)
    out = tmp_path / "out"
    argvs = [[sys.executable, "-m", "gelslim_depth_tpu_torch", "train", "dp", "cpu", "--data_parallel",
              "--coordinator_address", f"file://{tmp_path / 'store'}", "--num_processes", "2",
              "--process_id", str(r), "--dist_backend", "gloo", "--data_path", str(root), "--output_dir", str(out),
              "--use_difference_image", "--max_epochs", "1", "--dims", "8", "16", "--batch_size", "8",
              "--downsample_factor", "0.5"] for r in range(2)]
    logs = worker.launch(argvs, timeout=240)
    assert all("Data-parallel over 2 ranks" in log for log in logs)
    lines = [[ln for ln in log.splitlines() if ln.startswith("Train loss")] for log in logs]
    assert lines[0] == lines[1] and len(lines[0]) == 1
    weights = out / "weights"
    assert (weights / "dp.npz").exists() and (weights / "train_state.npz").exists()
    with open(out / "loss_values" / "dp.txt") as f:
        assert f.read().count("Train loss") == 1  # one writer


@pytest.mark.parametrize("flags", [["--shard_dataset"], ["--data_parallel", "--num_processes", "2"],
                                   ["--data_parallel", "--process_id", "1"],
                                   ["--data_parallel", "--coordinator_address", "localhost:1234"]])
def test_cli_train_refuses_a_partial_cluster(flags, tmp_path, capsys):
    """--shard_dataset without --data_parallel, and the process flags
    without a coordinator or without both counts, return 2 before anything
    runs or joins."""
    from gelslim_depth_tpu_torch.cli import main as cli
    from gelslim_depth_tpu_torch.parallel import is_initialized

    assert cli(["train", "w", "cpu", "--data_path", str(tmp_path), *flags]) == 2
    assert "train" in capsys.readouterr().err
    assert not os.listdir(tmp_path) and not is_initialized()
