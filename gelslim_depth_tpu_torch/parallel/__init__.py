"""Data-parallel and multi-process execution over ``torch.distributed``,
one process per rank: the port of ``gelslim_depth_tpu/parallel``, less the
height-sharded predictors (``make_spatial_predictor[_int8]``), which are
not ported yet."""

from gelslim_depth_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    make_dp_fused_predictor,
    make_dp_fused_predictor_int8,
    make_dp_predict,
    make_dp_renderer,
    make_mesh,
    replicate,
    shard_batch,
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
    "initialize",
    "is_initialized",
    "process_local_indices",
    "process_local_rows",
    "global_batch_from_local",
    "global_dataset_stats",
    "Mesh",
    "gather_rows",
]
