"""Config spine: the weights<->frozen-config pairing.

The reference's key reproducibility mechanism is a *generated importable
Python module* `gelslim_depth/config/config_<name>.py` written by the
trainer and re-imported by every consumer (ref train_utils/train_unet.py:
253-303, test_utils/test_depth_estimation.py:56). This rebuild keeps that
contract three ways:

- `GelslimConfig` — one frozen dataclass holding every knob plus the
  *learned* normalization parameters and resolved object lists.
- JSON artifact (`config_<name>.json`) saved beside each checkpoint —
  the native format here.
- `from_python_module` / `emit_python_config` — read and write the
  reference's .py format so existing reference configs (e.g.
  config_unet_bigdata.py) and reference consumers interoperate.

The PyTorch port's copy of ``gelslim_depth_tpu.config``: the same fields,
the same JSON and the same .py format, so either package reads what the
other writes. ``unet_config()`` returns the port's ``UNetConfig``.

The port serves two more architectures, each with a field of its widths
that the JAX package lacks: a dense-prediction transformer
(``models/dpt.py``) where ``model_type`` is ``"dpt"``, its widths ``dpt``
(a ``DPTConfig``, or a dict of its fields), and Depth Pro
(``models/depth_pro.py``) where it is ``"depth_pro"``, its widths
``depth_pro`` (a ``DepthProConfig`` or a dict); each None for the U-Net,
the default. ``dpt_config()`` and ``depth_pro_config()`` return them with
the input size filled in. A third field of the port's own,
``output_interp_method``, is the post's resize back where it differs from
the front end's ``interp_method`` (None, the default: the same). The JAX
package reads the port's files and drops these fields.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List, Optional, Tuple

from gelslim_depth_tpu_torch.models.depth_pro import DepthProConfig
from gelslim_depth_tpu_torch.models.dpt import DPTConfig
from gelslim_depth_tpu_torch.models.unet import UNetConfig


@dataclasses.dataclass
class GelslimConfig:
    # training options (ref config_unet_bigdata.py:3-18)
    weights_name: str = "unet"
    weights_path: str = "train_output/weights/"
    loss_curve_path: str = "train_output/loss_curves/"
    dataset_path: str = ""
    num_images_to_display_live: int = 5
    exclude_objects: List[str] = dataclasses.field(default_factory=list)
    batch_size: int = 16
    val_loss_SMA_window: int = 10
    training_learning_rate: float = 1e-3
    validation_loss_count_threshold: int = 5
    weight_decay: float = 1e-6
    train_indefinitely: bool = False
    save_at_epochs: List[int] = dataclasses.field(default_factory=lambda: [200])
    plot_every_epoch: int = 1
    # 'reference' preserves the reference's zero-initialized SMA window
    # (which trips early stop after ~threshold+1 epochs unconditionally,
    # ref train_unet.py:316-322 — why the published run needed
    # train_indefinitely); 'primed' seeds the window with the first
    # validation loss so the stop only fires on a genuine upward trend.
    early_stop_mode: str = "reference"

    # data processing options (:21-25)
    depth_image_blur_kernel: int = 1
    downsample_factor: float = 0.5
    use_difference_image: bool = True
    interp_method: str = "area"
    # the post's resize back to the frame, where it is not interp_method (the port only)
    output_interp_method: Optional[str] = None

    # CNN options (:28-35)
    input_tactile_image_size: Tuple[int, int] = (160, 213)
    CNN_dimensions: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    upconv_stride: int = 2
    maxpool_size: int = 2
    model_type: str = "unet"
    activation_func: str = "relu"
    kernel_size: int = 3
    # the transformer's widths where model_type is "dpt", Depth Pro's where
    # it is "depth_pro" (the port only)
    dpt: Optional[DPTConfig] = None
    depth_pro: Optional[DepthProConfig] = None

    # normalization (:38-43)
    image_normalization_method: str = "0_255_to_0_1"
    image_normalization_parameters: Optional[tuple] = None
    depth_normalization_method: str = "min_max_to_0_-1"
    depth_normalization_parameters: Optional[tuple] = None
    norm_scale: float = 0.9

    # object lists (:46-52)
    train_objects: List[str] = dataclasses.field(default_factory=list)
    validation_objects: List[str] = dataclasses.field(default_factory=list)
    test_objects: List[str] = dataclasses.field(default_factory=list)
    real_train_objects: List[str] = dataclasses.field(default_factory=list)
    real_validation_objects: List[str] = dataclasses.field(default_factory=list)
    real_test_objects: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if isinstance(self.dpt, dict):
            self.dpt = DPTConfig.from_dict(self.dpt)
        if isinstance(self.depth_pro, dict):
            self.depth_pro = DepthProConfig.from_dict(self.depth_pro)

    # --- aliases the reference uses inconsistently -------------------------
    # complete_prediction.py reads `tactile_normalization_*` while the
    # generated configs define `image_normalization_*` (a shipped
    # AttributeError bug, ref complete_prediction.py:6 vs train_unet.py:
    # 290-291). Expose both names so either call-site works here.
    @property
    def tactile_normalization_method(self) -> str:
        return self.image_normalization_method

    @property
    def tactile_normalization_parameters(self):
        return self.image_normalization_parameters

    def unet_config(self, n_channels: int = 3, n_classes: int = 1) -> UNetConfig:
        return UNetConfig(
            n_channels=n_channels,
            n_classes=n_classes,
            layer_dimensions=tuple(self.CNN_dimensions),
            kernel_size=self.kernel_size,
            maxpool_size=self.maxpool_size,
            upconv_stride=self.upconv_stride,
            activation=self.activation_func,
        )

    def dpt_config(self) -> DPTConfig:
        """The transformer's configuration, its input the network input size."""
        if self.model_type != "dpt" or self.dpt is None:
            raise ValueError(f"model_type {self.model_type!r} with dpt={self.dpt!r} is not a DPT configuration")
        return dataclasses.replace(self.dpt, image_size=tuple(self.input_tactile_image_size))

    def depth_pro_config(self) -> DepthProConfig:
        """Depth Pro's configuration, its input the network input size."""
        if self.model_type != "depth_pro" or self.depth_pro is None:
            raise ValueError(f"model_type {self.model_type!r} with depth_pro={self.depth_pro!r} "
                             "is not a Depth Pro configuration")
        return dataclasses.replace(self.depth_pro, image_size=tuple(self.input_tactile_image_size))

    @property
    def post_interp_method(self) -> str:
        """The method of the post's resize back to the frame."""
        return self.output_interp_method or self.interp_method

    # --- JSON artifact ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_json(cls, path_or_str: str) -> "GelslimConfig":
        if os.path.exists(path_or_str):
            with open(path_or_str) as f:
                d = json.load(f)
        else:
            d = json.loads(path_or_str)
        return cls(**{k: _tuplify(k, v) for k, v in d.items() if k in _FIELD_NAMES})

    # --- reference .py format ------------------------------------------------
    @classmethod
    def from_python_module(cls, module_or_path) -> "GelslimConfig":
        """Load a reference-style generated config (module object, import
        path like 'gelslim_depth.config.config_unet_bigdata', or file path)."""
        if isinstance(module_or_path, str):
            if module_or_path.endswith(".py") or os.path.sep in module_or_path:
                _stub_reference_main_config()
                spec = importlib.util.spec_from_file_location("_gelslim_cfg", module_or_path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            else:
                mod = importlib.import_module(module_or_path)
        else:
            mod = module_or_path
        kwargs = {}
        for name in _FIELD_NAMES:
            if hasattr(mod, name):
                kwargs[name] = _tuplify(name, getattr(mod, name))
        return cls(**kwargs)

    def emit_python_config(self, path: str) -> None:
        """Write the reference-compatible config_<name>.py (section layout
        per ref train_unet.py:253-303)."""
        sections = [
            ("#TRAINING OPTIONS", [
                "weights_name", "weights_path", "loss_curve_path", "dataset_path",
                "num_images_to_display_live", "exclude_objects", "batch_size",
                "val_loss_SMA_window", "training_learning_rate",
                "validation_loss_count_threshold", "weight_decay",
                "train_indefinitely", "save_at_epochs", "plot_every_epoch",
            ]),
            ("#DATA PROCESSING OPTIONS", [
                "depth_image_blur_kernel", "downsample_factor",
                "use_difference_image", "interp_method", "output_interp_method",
            ]),
            ("#CNN OPTIONS AND PARAMETERS", [
                "input_tactile_image_size", "CNN_dimensions", "upconv_stride",
                "maxpool_size", "model_type", "activation_func", "kernel_size", "dpt", "depth_pro",
            ]),
            ("#NORMALIZATION PARAMETERS", [
                "image_normalization_method", "image_normalization_parameters",
                "depth_normalization_method", "depth_normalization_parameters",
                "norm_scale",
            ]),
            ("#OBJECTS", [
                "train_objects", "validation_objects", "test_objects",
                "real_train_objects", "real_validation_objects", "real_test_objects",
            ]),
        ]
        lines = []
        for header, names in sections:
            lines.append(header)
            for n in names:
                v = getattr(self, n)
                if isinstance(v, (DPTConfig, DepthProConfig)):
                    v = dataclasses.asdict(v)
                elif isinstance(v, tuple):
                    v = tuple(v)
                elif n == "CNN_dimensions":
                    v = list(v)
                lines.append(f"{n} = {v!r}")
            lines.append("")
        with open(path, "w") as f:
            f.write("\n".join(lines))


def _stub_reference_main_config() -> None:
    """Reference-generated configs start with `import gelslim_depth.main_config`
    (ref config_unet_bigdata.py:1). When loading such a file outside the
    reference package, satisfy that import with a stub exposing DATA_PATH."""
    import sys
    import types

    try:
        importlib.import_module("gelslim_depth.main_config")
        return
    except ImportError:
        pass
    pkg = sys.modules.get("gelslim_depth") or types.ModuleType("gelslim_depth")
    mc = types.ModuleType("gelslim_depth.main_config")
    mc.DATA_PATH = os.environ.get("GELSLIM_DATA_PATH", "")
    pkg.main_config = mc
    sys.modules.setdefault("gelslim_depth", pkg)
    sys.modules["gelslim_depth.main_config"] = mc


_FIELD_NAMES = {f.name for f in dataclasses.fields(GelslimConfig)}
_TUPLE_FIELDS = {
    "input_tactile_image_size",
    "CNN_dimensions",
    "image_normalization_parameters",
    "depth_normalization_parameters",
}


def _tuplify(name: str, v):
    if v is not None and name in _TUPLE_FIELDS:
        return tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in v)
    return v
