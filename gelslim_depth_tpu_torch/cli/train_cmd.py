"""`train` command — flag-compatible rebuild of train_utils/train_unet.py,
the port of ``gelslim_depth_tpu/cli/train_cmd.py`` on one device.

Replicates the reference's object-list assembly (ref :110-192):
- train objects = listdir(train_data/), minus names listed in
  validation_objects.txt and test_objects.txt (those files EXCLUDE from
  the train list and from each other's lists);
- real_data inclusion lists ({train,validation,test}_real_objects.txt);
- --exclude_objects substring filtering (implemented as a proper filter,
  not the reference's mutate-while-iterating loop);
- the reference's `limit_object_lists = 1` debug leftover (:68,186-192) —
  which silently truncates every split to one object — is NOT replicated;
  use --limit_objects N explicitly for that behavior.

Trains on cuda unless the ``gpu`` positional says otherwise.
``--data_parallel`` trains over every rank of the process group, one
process and device a rank: launch it under torchrun, or once per rank with
``--coordinator_address``, ``--num_processes`` and ``--process_id``
(``parallel/multihost.py``). Without ``gpu`` each rank takes
cuda:LOCAL_RANK; naming ``gpu`` and ``--dist_backend`` puts the ranks where
they say, two on one card included. ``--shard_dataset`` has each rank bake
its round-robin share of the objects with statistics reduced over the
ranks. ``--channels_last`` bakes every split NHWC and trains NHWC.
"""

from __future__ import annotations

import argparse
import os
import sys

from gelslim_depth_tpu_torch.cli.quantize_cmd import GPU_HELP, parse_device

def parse_args(argv):
    p = argparse.ArgumentParser(prog="gelslim-depth-tpu-torch train",
                                description="Train a tactile depth estimation U-Net.")
    p.add_argument("weights_name", type=str, help="Name for the weights")
    p.add_argument("gpu", type=str, nargs="?", default=None, help=GPU_HELP)
    p.add_argument("--exclude_objects", nargs="+", help="List of objects to exclude")
    p.add_argument("--activation_func", type=str, default="relu", choices=["relu", "tanh", "mish"])
    p.add_argument("--train_indefinitely", action="store_true")
    p.add_argument("--use_difference_image", action="store_true")
    p.add_argument("--max_datapoints_per_object", type=int)
    p.add_argument("--starting_weights", type=str, help="Fine-tune from this weights name")
    p.add_argument("--data_path", type=str, default=None, help="Override GELSLIM_DATA_PATH")
    p.add_argument("--output_dir", type=str, default="train_output")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--limit_objects", type=int, default=None,
                   help="Debug: truncate every object list to N entries")
    p.add_argument("--data_parallel", action="store_true",
                   help="Train over every rank of the process group, one process and "
                        "device a rank (launch with torchrun or the three flags below)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="Multi-process: <host0>:<port> of rank 0, or a torch.distributed "
                        "URL (file://...); omit under torchrun")
    p.add_argument("--num_processes", type=int, default=None,
                   help="Multi-process: total number of processes (ranks)")
    p.add_argument("--process_id", type=int, default=None, help="Multi-process: this process's rank")
    p.add_argument("--dist_backend", type=str, default=None,
                   help="torch.distributed backend (default: NCCL for CUDA tensors, gloo for "
                        "CPU ones); naming it and the gpu positional lets ranks share a card")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--shard_dataset", action="store_true",
                   help="With --data_parallel: each rank bakes only its round-robin share of "
                        "the object files instead of replicating the dataset on every rank; "
                        "normalization statistics are reduced over the ranks")
    p.add_argument("--channels_last", action="store_true",
                   help="Bake the datasets NHWC and train NHWC (the convs run in "
                        "torch.channels_last memory format); the same math as NCHW")
    p.add_argument("--bf16_data", action="store_true",
                   help="Store baked tactile images as bfloat16 (halves "
                        "their device memory and gather traffic); "
                        "statistics and depth targets stay float32")
    p.add_argument("--plots", action="store_true",
                   help="matplotlib triptychs + loss curves per epoch "
                        "(the reference's always-on behavior)")
    p.add_argument("--remat", action="store_true",
                   help="recompute DoubleConv blocks in the backward "
                        "(activation checkpointing) for larger batches")
    p.add_argument("--resume", action="store_true",
                   help="continue from <output_dir>/weights/train_state.npz")
    p.add_argument("--dims", type=int, nargs="+", default=[64, 128, 256, 512, 1024])
    p.add_argument("--downsample_factor", type=float, default=0.5)
    p.add_argument("--early_stop_mode", choices=["reference", "primed"], default="reference",
                   help="'reference' keeps the reference's zero-initialized "
                        "SMA window (stops after ~threshold+1 epochs unless "
                        "--train_indefinitely); 'primed' seeds the window "
                        "with the first validation loss so early stop fires "
                        "only on a real upward trend")
    args = p.parse_args(argv)
    args.device = parse_device(p, args.gpu)
    return args


def _read_list(path, suffix=".pt"):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line + suffix for line in f.read().splitlines() if line.strip()]


def assemble_object_lists(dataset_path: str, exclude_objects=None, limit=None):
    """(train, val, test, real_train, real_val, real_test) file lists with
    the reference's exclusion/suffix rules."""
    train = [f.replace("_train.pt", ".pt") for f in sorted(os.listdir(os.path.join(dataset_path, "train_data")))]
    val_excl = _read_list(os.path.join(dataset_path, "validation_objects.txt"))
    test_excl = _read_list(os.path.join(dataset_path, "test_objects.txt"))
    val = [f for f in train if f not in test_excl]
    test = [f for f in train if f not in val_excl]
    train = [f for f in train if f not in val_excl and f not in test_excl]
    if exclude_objects:
        def keep(lst):
            return [f for f in lst if not any(name in f for name in exclude_objects)]

        train, val, test = keep(train), keep(val), keep(test)
    train = [f[:-3] + "_train.pt" for f in train]
    val = [f[:-3] + "_val.pt" for f in val]
    test = [f[:-3] + "_test.pt" for f in test]
    rd = os.path.join(dataset_path, "real_data")
    real_train = _read_list(os.path.join(rd, "train_real_objects.txt"))
    real_val = _read_list(os.path.join(rd, "validation_real_objects.txt"))
    real_test = _read_list(os.path.join(rd, "test_real_objects.txt"))
    lists = [train, val, test, real_train, real_val, real_test]
    if limit:
        lists = [lst[:limit] for lst in lists]
    return tuple(lists)


def run(argv):
    args = parse_args(argv)
    if args.shard_dataset and not args.data_parallel:
        print("train --shard_dataset: needs --data_parallel", file=sys.stderr)
        return 2

    import torch.distributed as dist

    from gelslim_depth_tpu_torch.parallel import multihost

    joined = not multihost.is_initialized()
    try:
        multihost.initialize(args.coordinator_address, args.num_processes, args.process_id,
                             backend=args.dist_backend)
    except ValueError as e:
        print(f"train: {e}", file=sys.stderr)
        return 2
    joined = joined and multihost.is_initialized()
    try:
        if multihost.is_initialized() and dist.get_world_size() > 1 and not args.data_parallel:
            print(f"train: {dist.get_world_size()} processes without --data_parallel would train that many "
                  "independent copies into one output directory", file=sys.stderr)
            return 2
        return _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args):
    import torch

    from gelslim_depth_tpu_torch.config import GelslimConfig
    from gelslim_depth_tpu_torch.data.dataset import bake_dataset
    from gelslim_depth_tpu_torch.models.torch_import import params_from_jax
    from gelslim_depth_tpu_torch.train import Trainer
    from gelslim_depth_tpu_torch.train.checkpoint import load_checkpoint

    dataset_path = args.data_path
    if dataset_path is None:
        from gelslim_depth_tpu_torch import main_config

        dataset_path = main_config.DATA_PATH

    train_o, val_o, test_o, rtrain_o, rval_o, rtest_o = assemble_object_lists(
        dataset_path, args.exclude_objects, args.limit_objects
    )
    config = GelslimConfig(
        weights_name=args.weights_name,
        dataset_path=dataset_path + "/",
        exclude_objects=args.exclude_objects or [],
        batch_size=args.batch_size,
        training_learning_rate=args.learning_rate,
        train_indefinitely=args.train_indefinitely,
        early_stop_mode=args.early_stop_mode,
        use_difference_image=args.use_difference_image,
        activation_func=args.activation_func,
        CNN_dimensions=tuple(args.dims),
        downsample_factor=args.downsample_factor,
        image_normalization_method="0_255_to_0_1",
        depth_normalization_method="min_max_to_0_-1",
        norm_scale=0.9,
        train_objects=train_o,
        validation_objects=val_o,
        test_objects=test_o,
        real_train_objects=rtrain_o,
        real_validation_objects=rval_o,
        real_test_objects=rtest_o,
    )

    common = dict(
        use_difference_image=args.use_difference_image,
        image_normalization_method=config.image_normalization_method,
        depth_normalization_method=config.depth_normalization_method,
        norm_scale=config.norm_scale,
        downsample_factor=args.downsample_factor,
        depth_image_blur_kernel=config.depth_image_blur_kernel,
        max_datapoints_per_object=args.max_datapoints_per_object,
        interp_method=config.interp_method,
        channels_last=args.channels_last,
        image_store_dtype=torch.bfloat16 if args.bf16_data else None,
    )
    mesh = None
    if args.data_parallel:
        from gelslim_depth_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device=None if args.gpu is None else args.device, backend=args.dist_backend)
        print(f"Data-parallel over {mesh.size} ranks; rank {mesh.rank} on {mesh.device}")
    common["device"] = mesh.device if mesh is not None else args.device
    sharded = False
    if args.shard_dataset:
        pc, pi = mesh.size, mesh.rank
        if pc > 1:
            sharded = True

            def shard(lst):
                return lst[pi::pc]

            if not shard(train_o) and not shard(rtrain_o):
                raise SystemExit(
                    f"--shard_dataset: rank {pi} of {pc} would receive no train files ({len(train_o)} "
                    "objects total); use the replicated default for datasets this small"
                )
            train_o, val_o, test_o = shard(train_o), shard(val_o), shard(test_o)
            rtrain_o, rval_o, rtest_o = shard(rtrain_o), shard(rval_o), shard(rtest_o)
            from gelslim_depth_tpu_torch.parallel import global_dataset_stats

            common["stats_reduce"] = global_dataset_stats
        else:
            print("--shard_dataset ignored: single process")
    print(f"Baking train set ({len(train_o)} objects + {len(rtrain_o)} real)...")
    train_ds = bake_dataset(
        os.path.join(dataset_path, "train_data"), train_o,
        os.path.join(dataset_path, "real_data"), rtrain_o, **common,
    )
    print(f"Found {len(train_ds)} training points")
    norm = dict(
        depth_normalization_parameters=train_ds.depth_normalization_parameters,
        image_normalization_parameters=train_ds.image_normalization_parameters,
    )
    val_ds = bake_dataset(
        os.path.join(dataset_path, "validation_data"), val_o,
        os.path.join(dataset_path, "real_data"), rval_o, **common, **norm,
    )
    print(f"Found {len(val_ds)} validation points")
    test_ds = bake_dataset(
        os.path.join(dataset_path, "test_data"), test_o,
        os.path.join(dataset_path, "real_data"), rtest_o, **common, **norm,
    )
    print(f"Found {len(test_ds)} test points")

    starting = None
    if args.starting_weights:
        # the JAX-layout checkpoint as the reference-layout state dict the
        # port's Trainer takes
        start_cfg, params, stats = load_checkpoint(
            os.path.join(args.output_dir, "weights"), args.starting_weights
        )
        starting = params_from_jax(params, stats, start_cfg.unet_config())

    trainer = Trainer(
        config, train_ds, val_ds, test_ds,
        output_dir=args.output_dir,
        device=None if mesh is not None else args.device,
        mesh=mesh,
        dataset_sharding="sharded" if sharded else "replicated",
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        starting_weights=starting,
        enable_plots=args.plots,
        remat=args.remat,
    )
    if args.resume:
        trainer.load_resume_state()
        print(f"resumed from step {int(trainer.state.step)} (epoch {trainer.epoch})")
    trainer.fit(max_epochs=args.max_epochs)
    trainer.save_resume_state()
    return 0
