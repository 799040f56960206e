"""Data-parallel, height-sharded and multi-process execution over
``torch.distributed``, one process per rank: the port of
``gelslim_depth_tpu/parallel``."""

from gelslim_depth_tpu_torch.parallel.mesh import (
    BandPlan,
    HeightHalo,
    Mesh,
    gather_height,
    gather_rows,
    make_dp_fused_predictor,
    make_dp_fused_predictor_int8,
    make_dp_predict,
    make_dp_renderer,
    make_mesh,
    make_spatial_predictor,
    make_spatial_predictor_int8,
    replicate,
    shard_batch,
    shard_height,
    spatial_band_plan,
)
from gelslim_depth_tpu_torch.parallel.multihost import (
    global_batch_from_local,
    global_dataset_stats,
    initialize,
    is_initialized,
    process_local_indices,
    process_local_rows,
)
from gelslim_depth_tpu_torch.train.steps import make_dp_eval_step, make_dp_train_step

__all__ = [
    "make_mesh",
    "replicate",
    "shard_batch",
    "make_dp_train_step",
    "make_dp_eval_step",
    "make_dp_predict",
    "make_dp_fused_predictor",
    "make_dp_fused_predictor_int8",
    "make_dp_renderer",
    "make_spatial_predictor",
    "make_spatial_predictor_int8",
    "initialize",
    "is_initialized",
    "process_local_indices",
    "process_local_rows",
    "global_batch_from_local",
    "global_dataset_stats",
    "Mesh",
    "gather_rows",
    "BandPlan",
    "HeightHalo",
    "spatial_band_plan",
    "shard_height",
    "gather_height",
]
