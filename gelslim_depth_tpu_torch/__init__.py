"""PyTorch/CUDA port of gelslim_depth_tpu: tactile depth estimation for
GelSlim sensors on an NVIDIA GPU.

Ported so far: the ops and config, the U-Net eval forward, reference and
JAX-checkpoint weights in and out, fused dual-frame serving, whose
diff + resize + normalize front end runs as a hand-written CUDA kernel,
int8 post-training-quantized serving, whose quantized convs run as a
second one, and single-device training: the dataset bake, the train-mode
U-Net, the Adam + EMA train step, checkpoints and resume, and the
``Trainer``; the serving surface: the ``StreamingEngine``, ``entry()``,
export to a ``.gsx`` artifact of ``torch.export`` programs in which both
kernels are ``torch.library`` custom ops; mesh->depth ground truth
(``meshgen``: the renderer on the card, a host C++ copy, the dataset
generator); data-parallel and multi-process training and serving over
``torch.distributed`` (``parallel``: the DP train and eval steps with global
batch norm, DP serving through both kernels, the DP renderer, the DP
``Trainer``); and the CLI's seven commands (``python -m
gelslim_depth_tpu_torch``). The package imports torch and numpy, never JAX
or gelslim_depth_tpu.
"""

from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.data import bake_dataset
from gelslim_depth_tpu_torch.inference import Predictor, QuantizedPredictor, StreamingEngine, predict_depth_from_RGB
from gelslim_depth_tpu_torch.train import Trainer

__all__ = [
    "GelslimConfig", "Predictor", "QuantizedPredictor", "StreamingEngine", "Trainer", "bake_dataset",
    "predict_depth_from_RGB",
]
