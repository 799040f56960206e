"""The training loop: epochs, early stopping, checkpoint policy, logging.
The port of ``gelslim_depth_tpu/train/loop.py::Trainer``, single device, with
the reference's observable policy (ref train_utils/train_unet.py:306-523):

- per epoch: a full train pass, then val and test passes under the EMA
  parameters; the shuffles are seeded 1000/2000/3000 + epoch, so the
  batches are the JAX package's.
- batches: every batch padded to the batch size with a per-sample mask
  (mask-weighted loss and BN statistics), batch for batch the math of the
  JAX package's default scan epochs.
- early stop: a simple moving average of the validation loss over
  val_loss_SMA_window epochs; when it has risen against the previous
  epoch's more than validation_loss_count_threshold epochs in a row, stop,
  unless train_indefinitely, which only announces it (:316-322, 459-475).
  early_stop_mode 'reference' keeps the reference's zero-initialized
  window (it trips at epoch threshold+1 whatever the losses); 'primed'
  seeds it with the first validation loss.
- checkpoints: EMA weights + frozen config at every new raw validation
  minimum (:476-484); epoch-pinned snapshots at save_at_epochs when
  train_indefinitely (:485-490); full train-state files for resume, with a
  ``<name>_loop.json`` sidecar of the loop's bookkeeping.
- logging: an append-only text file in the reference's line format (:324,
  491-498), plus matplotlib loss curves and sample triptychs.

Runs on ``cuda`` unless device says otherwise, and raises without a card.

Data-parallel: pass a ``parallel.Mesh`` and every rank runs this loop on
its device with the DP train and eval steps (global batch norm, global
masked loss, all-reduced gradients). Each global batch is padded to a
multiple of the ranks and every rank takes its own rows of it under the
mask. dataset_sharding 'replicated' (the default) has every rank hold the
whole baked dataset and share the epoch's shuffle through the seed, so the
batches and the math are the single-device run's. 'sharded' has each
rank's datasets hold only its shard (bake it with
``stats_reduce=parallel.global_dataset_stats`` for global statistics):
each rank shuffles its shard with seed + 7919 * rank, the largest shard
sets the steps of an epoch (gathered once, at construction), and smaller
shards pad their tail under mask False. Only rank 0 writes logs, plots,
checkpoints and the resume file.

The train split's bake sets the run's layout: an NHWC bake
(``bake_dataset(channels_last=True)``) runs every step NHWC, and a val or
test split baked otherwise is refused. ``profile_first_epoch`` records a
``torch.profiler`` trace of epoch 0's train pass under
``output_dir/profile`` (``utils.profiling.trace``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gelslim_depth_tpu_torch import ops
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.data.dataset import BakedDataset, BatchIterator
from gelslim_depth_tpu_torch.models.unet import split_state_dict, unet_apply
from gelslim_depth_tpu_torch.train import checkpoint as ckpt
from gelslim_depth_tpu_torch.train.steps import (
    create_train_state,
    eval_epoch,
    make_dp_eval_step,
    make_dp_train_step,
    make_eval_step,
    make_optimizer,
    make_train_step,
    train_epoch,
)
from gelslim_depth_tpu_torch.utils.device import resolve_device
from gelslim_depth_tpu_torch.utils.profiling import trace


def sharded_epoch_indices(n_local: int, n_steps: int, local_bs: int, seed: int):
    """(perm, masks), each (n_steps, local_bs), of one rank's shard in a
    sharded epoch: the shard shuffled by RandomState(seed), its tail padded
    with sample 0 under mask False."""
    order = np.random.RandomState(seed).permutation(n_local)
    perm = np.zeros(n_steps * local_bs, np.int32)
    masks = np.zeros(n_steps * local_bs, bool)
    take = min(perm.size, n_local)
    perm[:take], masks[:take] = order[:take], True
    return perm.reshape(n_steps, local_bs), masks.reshape(n_steps, local_bs)


class Trainer:
    def __init__(
        self,
        config: GelslimConfig,
        train_ds: BakedDataset,
        val_ds: BakedDataset,
        test_ds: BakedDataset,
        *,
        output_dir: str = "train_output",
        device=None,
        mesh=None,
        dataset_sharding: str = "replicated",
        compute_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        starting_weights=None,  # a reference-layout state dict, for fine-tuning
        log_fn: Callable[[str], None] = print,
        enable_plots: bool = True,
        resume_every_epochs: Optional[int] = None,
        remat: bool = False,
        profile_first_epoch: bool = False,
    ):
        self.config = config
        self.unet_cfg = config.unet_config()
        if mesh is not None and device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        if dataset_sharding not in ("replicated", "sharded"):
            raise ValueError(f"dataset_sharding {dataset_sharding!r}: want replicated|sharded")
        if dataset_sharding == "sharded" and mesh is None:
            raise ValueError("dataset_sharding='sharded' needs a mesh")
        self.sharded = dataset_sharding == "sharded"
        # rank 0 owns every file the run writes
        self.is_main = mesh is None or mesh.rank == 0
        self.train_ds, self.val_ds, self.test_ds = train_ds, val_ds, test_ds
        # the train split's baked layout is the run's
        self.channels_last = bool(getattr(train_ds, "channels_last", False))
        for split_name, ds in (("val", val_ds), ("test", test_ds)):
            if bool(getattr(ds, "channels_last", False)) != self.channels_last:
                raise ValueError(
                    f"{split_name} split layout (channels_last={getattr(ds, 'channels_last', False)}) differs "
                    f"from the train split ({self.channels_last}); bake all splits alike"
                )
        self.profile_first_epoch = profile_first_epoch
        self.output_dir = output_dir
        self.compute_dtype = compute_dtype
        self.log_fn = log_fn
        self.enable_plots = enable_plots
        # preemption recovery: persist the FULL train state every so many
        # epochs, so a killed run resumes with its moments and EMA
        self.resume_every_epochs = resume_every_epochs

        self.weights_dir = os.path.join(output_dir, "weights")
        self.loss_values_path = os.path.join(output_dir, "loss_values")
        self.loss_curve_dir = os.path.join(output_dir, "loss_curves")
        self.live_display_dir = os.path.join(output_dir, "live_display")
        if self.is_main:
            for d in (self.weights_dir, self.loss_values_path, self.loss_curve_dir, self.live_display_dir):
                os.makedirs(d, exist_ok=True)
        self.loss_file = os.path.join(self.loss_values_path, f"{config.weights_name}.txt")

        self.optimizer = make_optimizer(config.training_learning_rate, config.weight_decay)
        if starting_weights is not None:
            params, stats = split_state_dict(starting_weights)
            self.state = create_train_state(self.unet_cfg, self.optimizer, params=params,
                                            batch_stats=stats, device=self.device)
        else:
            self.state = create_train_state(self.unet_cfg, self.optimizer,
                                            generator=torch.Generator().manual_seed(seed), device=self.device)
        if mesh is None:
            self._train_step = make_train_step(self.unet_cfg, self.optimizer, compute_dtype=compute_dtype,
                                               masked=True, remat=remat, channels_last=self.channels_last)
            self._eval_step = make_eval_step(self.unet_cfg, compute_dtype=compute_dtype, masked=True,
                                             channels_last=self.channels_last)
        else:
            from gelslim_depth_tpu_torch.parallel import gather_rows, replicate

            self._train_step = make_dp_train_step(self.unet_cfg, self.optimizer, mesh, compute_dtype=compute_dtype,
                                                  masked=True, remat=remat, channels_last=self.channels_last)
            self._eval_step = make_dp_eval_step(self.unet_cfg, mesh, compute_dtype=compute_dtype, masked=True,
                                                channels_last=self.channels_last)
            self.state = replicate(mesh, self.state)
            # a global batch of batch_size rounded up to a multiple of the ranks
            self._local_bs = -(-config.batch_size // mesh.size)
            if self.sharded:
                # steps an epoch of each split: the largest shard's
                splits = list({id(ds): ds for ds in (train_ds, val_ds, test_ds)}.values())
                sizes = gather_rows(mesh, torch.tensor([[len(ds) for ds in splits]], device=mesh.device))
                self._n_steps = {id(ds): max(-(-int(n) // self._local_bs), 1)
                                 for ds, n in zip(splits, sizes.max(0).values.tolist())}

        # freeze the LEARNED preprocessing state into the config artifact, as
        # the reference's generated configs do (ref train_unet.py:208-216, 288-291)
        config.depth_normalization_parameters = tuple(train_ds.depth_normalization_parameters)
        config.image_normalization_parameters = tuple(
            tuple(p) for p in train_ds.image_normalization_parameters
        )
        config.input_tactile_image_size = tuple(train_ds.input_tactile_image_size)

        self.history: Dict[str, List[float]] = {"train_loss": [], "validation_loss": [], "test_loss": []}
        self.min_validation_loss = float("inf")
        self._val_window = np.zeros(config.val_loss_SMA_window)
        self._prev_sma = 0.0
        self._upward_counter = 0
        # True once the SMA early-stop rule has fired, even under
        # train_indefinitely, where it only logs
        self.early_stop_tripped = False
        self.epoch = 0

        # the frozen config artifacts, written before training starts like
        # the reference's config_<name>.py (:253-303)
        if self.is_main:
            config.save_json(os.path.join(self.weights_dir, f"{config.weights_name}.json"))
            config.emit_python_config(os.path.join(self.weights_dir, f"config_{config.weights_name}.py"))

    # ------------------------------------------------------------------
    def _log(self, msg: str):
        self.log_fn(msg)
        if self.is_main:
            with open(self.loss_file, "a") as f:
                f.write(msg + "\n")

    def _arrays(self, ds: BakedDataset):
        return ds.tactile_image.to(self.device), ds.depth_image.to(self.device)

    def _epoch_indices(self, ds: BakedDataset, seed: int):
        """(perm, masks) of this rank's rows of one epoch's padded batches."""
        if self.sharded:
            return sharded_epoch_indices(len(ds), self._n_steps[id(ds)], self._local_bs, seed + 7919 * self.mesh.rank)
        it = BatchIterator(ds, self.config.batch_size, shuffle=True, seed=seed)
        if self.mesh is None:
            return it.padded_epoch_indices()
        perm, masks = it.padded_epoch_indices(pad_to_multiple_of=self.mesh.size)
        rows = self.mesh.rows(perm.shape[1])
        return perm[:, rows], masks[:, rows]

    def _train_epoch(self, seed: int) -> float:
        perm, masks = self._epoch_indices(self.train_ds, seed)
        self.state, loss = train_epoch(self._train_step, self.state, *self._arrays(self.train_ds), perm, masks)
        return float(loss)  # one host readback an epoch

    def _eval_epoch(self, ds: BakedDataset, seed: int) -> float:
        perm, masks = self._epoch_indices(ds, seed)
        return float(eval_epoch(self._eval_step, self.state, *self._arrays(ds), perm, masks))

    def _early_stop_update(self, val_loss: float) -> bool:
        """Advance the SMA window with this epoch's validation loss; True
        when the upward-SMA counter has tripped (ref train_unet.py:459-475)."""
        cfg = self.config
        if cfg.early_stop_mode == "primed" and self.epoch == 0:
            self._val_window[:] = val_loss
            self._prev_sma = float("inf")
        self._val_window[self.epoch % cfg.val_loss_SMA_window] = val_loss
        sma = float(self._val_window.mean())
        if sma > self._prev_sma:
            self._upward_counter += 1
        else:
            self._upward_counter = 0
        self._prev_sma = sma
        return self._upward_counter > cfg.validation_loss_count_threshold

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The EMA weights with the live running statistics, as a
        reference-layout state dict: what the checkpoints hold."""
        return {**self.state.ema.shadow, **self.state.batch_stats}

    def _save_best(self):
        self._log("Validation loss is at a minimum. Saving the model")
        if self.is_main:
            ckpt.save_weights(self.weights_dir, self.config, self.ema_state_dict())

    # ------------------------------------------------------------------
    def fit(self, max_epochs: Optional[int] = None) -> Dict[str, List[float]]:
        cfg = self.config
        start = time.time()
        stop = False
        # a run resumed at or past max_epochs runs no epoch
        while not stop and not (max_epochs is not None and self.epoch >= max_epochs):
            t0 = time.time()
            with (trace(os.path.join(self.output_dir, "profile")) if self.profile_first_epoch and self.epoch == 0
                  else contextlib.nullcontext()):
                train_loss = self._train_epoch(seed=1000 + self.epoch)
            val_loss = self._eval_epoch(self.val_ds, seed=2000 + self.epoch)
            test_loss = self._eval_epoch(self.test_ds, seed=3000 + self.epoch)

            self.history["train_loss"].append(train_loss)
            self.history["validation_loss"].append(val_loss)
            self.history["test_loss"].append(test_loss)

            if self._early_stop_update(val_loss):
                self.early_stop_tripped = True
                if cfg.train_indefinitely:
                    self._log(f"Validation loss stopped decreasing at epoch {self.epoch + 1}")
                else:
                    stop = True

            if val_loss < self.min_validation_loss:
                self._save_best()
                self.min_validation_loss = val_loss

            if cfg.train_indefinitely and self.epoch in cfg.save_at_epochs and self.is_main:
                ckpt.save_weights(self.weights_dir, self.config, self.ema_state_dict(),
                                  name=f"{cfg.weights_name}_epoch{self.epoch}")

            self._log(f"[INFO] EPOCH: {self.epoch + 1}")
            self._log(
                "Train loss: {:.6f},  Validation loss: {:.6f}, Test loss: {:.6f}".format(
                    train_loss, val_loss, test_loss
                )
            )
            self._log(f"Time for epoch: {time.time() - t0}")

            if self.enable_plots and self.is_main and self.epoch % max(cfg.plot_every_epoch, 1) == 0:
                self._plot_curves()
                self._plot_samples()

            self.epoch += 1
            if self.resume_every_epochs and self.epoch % self.resume_every_epochs == 0:
                self.save_resume_state()

        self._log("Training complete")
        self._log(f"Training time: {time.time() - start}s")
        return self.history

    # ------------------------------------------------------------------
    def save_resume_state(self, name: str = "train_state") -> str:
        """Persist the full train state, plus a <name>_loop.json sidecar of
        the loop's bookkeeping: the epoch counter (which seeds the
        shuffles), the best validation minimum and the loss history. Without
        it a resumed run would replay epoch 0's batch order, save a spurious
        'best' and reset the early-stop window. Only rank 0 writes; every
        rank returns the path."""
        if not self.is_main:
            return os.path.join(self.weights_dir, f"{name}.npz")
        path = ckpt.save_train_state(self.weights_dir, self.state, name=name)
        loop = {
            "epoch": self.epoch,
            # step ties the sidecar to its .npz: both writes are atomic, so
            # a preemption between them leaves a detectable mismatch
            "step": int(self.state.step),
            "min_validation_loss": float(self.min_validation_loss),
            "history": {k: [float(v) for v in vs] for k, vs in self.history.items()},
        }
        loop_path = os.path.join(self.weights_dir, f"{name}_loop.json")
        tmp = loop_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(loop, f)
        ckpt.replace_durable(tmp, loop_path)
        return path

    def load_resume_state(self, name: str = "train_state"):
        self.state = ckpt.load_train_state(self.weights_dir, name=name, device=self.device)
        if self.mesh is not None:
            from gelslim_depth_tpu_torch.parallel import replicate

            self.state = replicate(self.mesh, self.state)
        loop_path = os.path.join(self.weights_dir, f"{name}_loop.json")
        if not os.path.exists(loop_path):
            warnings.warn(
                f"resume: no loop-bookkeeping sidecar at {loop_path}; device "
                "state restored but epoch counter / early-stop window / "
                "best-val minimum reset — the resumed run will NOT reproduce "
                "the uninterrupted trajectory"
            )
            return
        with open(loop_path) as f:
            loop = json.load(f)
        if "step" not in loop:
            warnings.warn(
                f"resume: sidecar {loop_path} has no 'step' key, so it cannot "
                f"be verified against {name}.npz — ignoring it, loop "
                "bookkeeping reset"
            )
            return
        if int(loop["step"]) != int(self.state.step):
            warnings.warn(
                f"resume: sidecar {loop_path} (step {loop['step']}) is out of "
                f"sync with {name}.npz (step {int(self.state.step)}) — torn "
                "checkpoint pair (preempted between the two writes?); "
                "ignoring the stale sidecar, loop bookkeeping reset"
            )
            return
        self.epoch = int(loop["epoch"])
        self.min_validation_loss = float(loop["min_validation_loss"])
        self.history = {k: list(vs) for k, vs in loop["history"].items()}
        # replay the early-stop bookkeeping from the history under the live
        # config: equal to the uninterrupted run when the config is unchanged
        self._val_window = np.zeros(self.config.val_loss_SMA_window)
        self._prev_sma = 0.0
        self._upward_counter = 0
        saved_epoch = self.epoch
        for i, v in enumerate(self.history.get("validation_loss", [])):
            self.epoch = i
            if self._early_stop_update(float(v)):
                self.early_stop_tripped = True
        self.epoch = saved_epoch

    # ------------------------------------------------------------------
    def _plot_curves(self):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        plt.figure()
        for k in ("train_loss", "validation_loss", "test_loss"):
            plt.plot(self.history[k], label=k)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.legend(loc="upper right")
        plt.yscale("log")
        plt.savefig(os.path.join(self.loss_curve_dir, f"{self.config.weights_name}.png"))
        plt.close()

    def _display_inputs(self, img: torch.Tensor) -> np.ndarray:
        """NCHW normalized inputs -> uint8 [0, 255] display images, by
        inverting the frozen normalization."""
        cfg = self.config
        denorm = ops.denormalize_tactile_image(
            img.float(), cfg.image_normalization_method, cfg.norm_scale, cfg.image_normalization_parameters,
        )
        return np.clip(denorm.cpu().numpy(), 0, 255).astype(np.uint8)

    @torch.no_grad()
    def _plot_samples(self):
        """Live triptych (input / prediction / ground truth) per split
        (ref :326-328, 348-369), predicted under the EMA weights."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        k = min(self.config.num_images_to_display_live, len(self.val_ds))
        if k == 0:
            return
        rng = np.random.RandomState(self.epoch)
        for split_name, ds in (("train", self.train_ds), ("validation", self.val_ds), ("test", self.test_ds)):
            idx = rng.choice(len(ds), size=min(k, len(ds)), replace=False)
            sel = torch.as_tensor(idx, device=ds.tactile_image.device)
            img = ds.tactile_image.index_select(0, sel).to(self.device)
            dep = ds.depth_image.index_select(0, sel)
            pred, _ = unet_apply(self.unet_cfg, self.state.ema.shadow, self.state.batch_stats, img,
                                 channels_last=self.channels_last)
            if self.channels_last:  # -> NCHW for display
                img, pred, dep = (t.permute(0, 3, 1, 2) for t in (img, pred, dep))
            img_np = self._display_inputs(img)
            pred_np, dep_np = pred.cpu().numpy(), dep.float().cpu().numpy()
            fig, axes = plt.subplots(len(idx), 3, figsize=(10, 10), squeeze=False)
            for r in range(len(idx)):
                axes[r, 0].imshow(img_np[r].transpose(1, 2, 0))
                axes[r, 1].imshow(pred_np[r, 0])
                axes[r, 2].imshow(dep_np[r, 0])
                for c in range(3):
                    axes[r, c].set_xticks([])
                    axes[r, c].set_yticks([])
            axes[0, 0].set_title("Input")
            axes[0, 1].set_title("Output")
            axes[0, 2].set_title("Ground Truth")
            fig.suptitle(f"Epoch {self.epoch + 1} {split_name.capitalize()} Images")
            fig.savefig(
                os.path.join(self.live_display_dir, f"{self.config.weights_name}_{split_name}_images.png")
            )
            plt.close(fig)
