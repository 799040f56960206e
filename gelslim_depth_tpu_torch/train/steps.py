"""Pure train and eval steps, the port of ``gelslim_depth_tpu/train/steps.py``
(the reference's inner loops, ref train_utils/train_unet.py):

- loss: MSE over the batch (:51-52); with a per-sample mask, sum-based over
  one denominator, so a padded batch's value and gradient equal the
  unpadded batch's. A non-finite loss leaves parameters, Adam moments and
  count, EMA and running statistics as they were and reports 0; ``step``
  still advances. Every new value is computed beside the old one and
  selected on the device (``torch.where``), so the step never waits for the
  host to read the loss.
- optimizer: Adam(lr=1e-3, weight_decay=1e-6) with torch semantics, the L2
  term added to the gradient before the moments (:306), as
  ``optax.chain(add_decayed_weights, scale_by_adam, scale(-lr))`` computes
  it, written functionally over ``torch._foreach`` ops.
- EMA(0.995) after every optimizer step; validation, test and checkpoints
  use the EMA shadow (:309,376,389,480).

State is a ``TrainState`` of reference-layout dictionaries on one device:
float32 parameters (the masters; the forward casts them to the compute
dtype), running statistics, Adam moments, the EMA shadow, and int32 device
counters. float32 steps hold cuDNN TF32 off across the forward AND the
backward, as the JAX package differentiates at ``Precision.HIGHEST``.
``make_dp_train_step`` and ``make_dp_eval_step`` run the same steps over
the ranks of a ``parallel.Mesh``, each rank on its own rows of a global
batch (the port of ``gelslim_depth_tpu/parallel/mesh.py``'s DP steps).
Every step takes ``channels_last``: NHWC images and targets, as
``unet_apply(channels_last=True)`` takes them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch.models.unet import (
    UNetConfig,
    init_unet,
    full_precision,
    reinit_weights_normal,
    unet_apply,
)
from gelslim_depth_tpu_torch.train.ema import EmaState, ema_init, ema_update

Tensors = Dict[str, torch.Tensor]


def mse_loss(pred: torch.Tensor, target: torch.Tensor, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE over all elements; with a per-sample valid_mask ((N,) bool) the
    padded samples are excluded: sum(sq * w) over (valid count x elements
    per sample)."""
    sq = torch.square(pred - target)
    if valid_mask is None:
        return sq.mean()
    m = valid_mask.to(sq.dtype)
    denom = torch.clamp(m.sum(), min=1.0) * int(np.prod(sq.shape[1:]))
    return (sq * m.view(-1, *([1] * (sq.ndim - 1)))).sum() / denom


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # int32 scalar: optax's ScaleByAdamState.count
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class Adam:
    """torch.optim.Adam's update, L2 into the gradient, then the moments,
    then -lr scaling (not decoupled AdamW), as a pure function."""

    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Tensors) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamState, params: Tensors) -> Tuple[Tensors, AdamState]:
        keys = list(params)
        p = [params[k] for k in keys]
        g = torch._foreach_add([grads[k] for k in keys], p, alpha=self.weight_decay)
        mu = torch._foreach_mul([state.mu[k] for k in keys], self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        nu = torch._foreach_mul([state.nu[k] for k in keys], self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state.count + 1
        t = count.float()
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, t))
        denom = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        new = torch._foreach_add(p, mu_hat, alpha=-self.learning_rate)
        return dict(zip(keys, new)), AdamState(count, dict(zip(keys, mu)), dict(zip(keys, nu)))


def make_optimizer(learning_rate: float = 1e-3, weight_decay: float = 1e-6) -> Adam:
    return Adam(learning_rate=learning_rate, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    params: Tensors
    batch_stats: Tensors
    opt_state: AdamState
    ema: EmaState
    step: torch.Tensor  # int32 scalar

    def tensors(self) -> Tensors:
        """Every tensor of the state in one flat dictionary, keyed
        ``<part>/<state-dict name>`` (for comparing two states)."""
        out = {"step": self.step, "ema/num_updates": self.ema.num_updates, "adam/count": self.opt_state.count}
        for prefix, tree in (("params", self.params), ("batch_stats", self.batch_stats),
                             ("adam/mu", self.opt_state.mu), ("adam/nu", self.opt_state.nu),
                             ("ema/shadow", self.ema.shadow)):
            out.update({f"{prefix}/{k}": v for k, v in tree.items()})
        return out

    def to(self, device) -> "TrainState":
        def mv(tree):
            return {k: v.to(device) for k, v in tree.items()}

        return TrainState(
            mv(self.params), mv(self.batch_stats),
            AdamState(self.opt_state.count.to(device), mv(self.opt_state.mu), mv(self.opt_state.nu)),
            EmaState(mv(self.ema.shadow), self.ema.num_updates.to(device), self.ema.decay),
            self.step.to(device),
        )


def create_train_state(
    unet_cfg: UNetConfig,
    optimizer: Adam,
    *,
    generator: Optional[torch.Generator] = None,
    ema_decay: float = 0.995,
    reinit_std: Optional[float] = 0.01,
    params: Optional[Tensors] = None,
    batch_stats: Optional[Tensors] = None,
    device="cpu",
) -> TrainState:
    """Fresh state with the reference's N(0, 0.01) weight re-init
    (train_unet.py:246-250), drawn on the CPU from generator, or wrap given
    (fine-tune) weights; then on device."""
    if params is None:
        params, batch_stats = init_unet(unet_cfg, generator)
        if reinit_std is not None:
            params = reinit_weights_normal(params, generator, std=reinit_std)
    params = {k: v.to(device=device, dtype=torch.float32).clone() for k, v in params.items()}
    batch_stats = {k: v.to(device=device, dtype=torch.float32).clone() for k, v in batch_stats.items()}
    return TrainState(
        params=params,
        batch_stats=batch_stats,
        opt_state=optimizer.init(params),
        ema=ema_init(params, decay=ema_decay),
        step=torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device),
    )


class TrainStep:
    """step(state, images, targets[, valid_mask]) -> (new state, loss), pure:
    the given state is not modified. With masked=True a per-sample bool mask
    keeps padded samples out of the loss AND the batch statistics
    (mask-weighted BN in unet_apply), so a padded batch's update equals the
    ragged batch's. remat=True recomputes each DoubleConv in the backward.
    channels_last=True takes NHWC images and targets.

    Its two halves, ``loss_and_grads`` and ``apply_updates``, are public so
    that a profiler can time the forward + backward apart from the
    optimizer + EMA."""

    def __init__(self, unet_cfg: UNetConfig, optimizer: Adam, *, compute_dtype=torch.float32,
                 masked: bool = False, remat: bool = False, channels_last: bool = False):
        self.unet_cfg, self.optimizer = unet_cfg, optimizer
        self.compute_dtype, self.masked, self.remat = compute_dtype, masked, remat
        self.channels_last = channels_last

    def loss_and_grads(self, state: TrainState, images, targets, valid_mask=None):
        """-> (loss, new batch stats, gradients by parameter name)."""
        mask = valid_mask if self.masked else None
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        with full_precision(self.compute_dtype):
            pred, new_stats = unet_apply(
                self.unet_cfg, params, state.batch_stats, images, train=True,
                compute_dtype=self.compute_dtype, remat=self.remat, sample_mask=mask,
                channels_last=self.channels_last,
            )
            loss = mse_loss(pred, targets, mask)
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), new_stats, dict(zip(params, grads))

    @torch.no_grad()
    def apply_updates(self, state: TrainState, loss, new_stats: Tensors, grads: Tensors):
        """Adam, then the EMA of the new parameters; every new value is kept
        only where the loss is finite."""
        params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        ema = ema_update(state.ema, params)
        bad = torch.logical_not(torch.isfinite(loss))

        def pick(new: Tensors, old: Tensors) -> Tensors:
            return {k: torch.where(bad, old[k], new[k]) for k in old}

        new_state = TrainState(
            params=pick(params, state.params),
            batch_stats=pick(new_stats, state.batch_stats),
            opt_state=AdamState(torch.where(bad, state.opt_state.count, opt_state.count),
                                pick(opt_state.mu, state.opt_state.mu), pick(opt_state.nu, state.opt_state.nu)),
            ema=EmaState(pick(ema.shadow, state.ema.shadow),
                         torch.where(bad, state.ema.num_updates, ema.num_updates), ema.decay),
            step=state.step + 1,
        )
        return new_state, torch.where(bad, torch.zeros_like(loss), loss)

    def __call__(self, state: TrainState, images, targets, valid_mask=None):
        return self.apply_updates(state, *self.loss_and_grads(state, images, targets, valid_mask))


def make_train_step(unet_cfg: UNetConfig, optimizer: Adam, *, compute_dtype=torch.float32,
                    masked: bool = False, remat: bool = False, channels_last: bool = False) -> TrainStep:
    return TrainStep(unet_cfg, optimizer, compute_dtype=compute_dtype, masked=masked, remat=remat,
                     channels_last=channels_last)


def _squared_error_and_count(pred, target, valid_mask):
    """(sum of squared errors over the valid samples, their count, elements
    a sample): the parts of ``mse_loss`` that add up over ranks."""
    sq = torch.square(pred - target)
    if valid_mask is None:
        count = torch.tensor(float(sq.shape[0]), device=sq.device, dtype=sq.dtype)
        return sq.sum(), count, int(np.prod(sq.shape[1:]))
    m = valid_mask.to(sq.dtype)
    return (sq * m.view(-1, *([1] * (sq.ndim - 1)))).sum(), m.sum(), int(np.prod(sq.shape[1:]))


def _global_mse(mesh, sse, count, per_sample):
    """The masked MSE over every rank's rows: (loss, its denominator)."""
    tot = mesh.all_reduce(torch.stack([sse.detach(), count]))
    denom = torch.clamp(tot[1], min=1.0) * per_sample
    return tot[0] / denom, denom


class DPTrainStep(TrainStep):
    """``TrainStep`` over the ranks of a ``parallel.Mesh``, each feeding its
    own rows of the global batch (the state replicated on every rank):

    - batch norm is global: unet_apply all-reduces its batch sums and
      counts (``reduce=mesh.all_reduce_grad``);
    - the loss is the global masked mean, all-reduced squared-error sums
      over the all-reduced valid count. Each rank backpropagates its own
      rows' squared errors over that count; the all-reduce's backward sums
      the batch-norm gradients over the ranks, and the parameter gradients
      are then all-reduced, so every rank holds the gradient of the global
      loss;
    - every rank runs the same Adam + EMA update, and the NaN guard reads
      the global loss, so the ranks keep or drop a step together and their
      states stay equal bit for bit.

    One step equals ``TrainStep`` on the whole global batch up to float32
    summation order."""

    def __init__(self, unet_cfg: UNetConfig, optimizer: Adam, mesh, **kw):
        super().__init__(unet_cfg, optimizer, **kw)
        self.mesh = mesh

    def loss_and_grads(self, state: TrainState, images, targets, valid_mask=None):
        mask = valid_mask if self.masked else None
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        with full_precision(self.compute_dtype):
            pred, new_stats = unet_apply(
                self.unet_cfg, params, state.batch_stats, images, train=True, compute_dtype=self.compute_dtype,
                remat=self.remat, sample_mask=mask, reduce=self.mesh.all_reduce_grad,
                channels_last=self.channels_last,
            )
            sse, count, per_sample = _squared_error_and_count(pred, targets, mask)
            loss, denom = _global_mse(self.mesh, sse, count, per_sample)
            grads = torch.autograd.grad(sse / denom, list(params.values()))
        flat = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        return loss, new_stats, dict(zip(params, grads))


def make_dp_train_step(unet_cfg: UNetConfig, optimizer: Adam, mesh, *, compute_dtype=torch.float32,
                       masked: bool = False, remat: bool = False, channels_last: bool = False) -> DPTrainStep:
    """step(state, local images, local targets[, local valid_mask]) ->
    (new state, global loss) on each rank of mesh (``DPTrainStep``)."""
    return DPTrainStep(unet_cfg, optimizer, mesh, compute_dtype=compute_dtype, masked=masked, remat=remat,
                       channels_last=channels_last)


def make_eval_step(unet_cfg: UNetConfig, *, use_ema: bool = True, compute_dtype=torch.float32,
                   masked: bool = False, channels_last: bool = False):
    """eval(state, images, targets[, valid_mask]) -> loss under the EMA
    shadow by default (the reference validates and tests under
    ema.average_parameters(), train_unet.py:389,428); a non-finite loss
    reports 0. The BN is folded from the live running statistics at every
    call."""

    @torch.no_grad()
    def step(state: TrainState, images, targets, valid_mask=None) -> torch.Tensor:
        params = state.ema.shadow if use_ema else state.params
        pred, _ = unet_apply(unet_cfg, params, state.batch_stats, images, compute_dtype=compute_dtype,
                             channels_last=channels_last)
        loss = mse_loss(pred, targets, valid_mask if masked else None)
        return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))

    return step


def make_dp_eval_step(unet_cfg: UNetConfig, mesh, *, use_ema: bool = True, compute_dtype=torch.float32,
                      masked: bool = False, channels_last: bool = False):
    """``make_eval_step`` over the ranks of mesh: each rank evaluates its
    rows and every rank returns the global masked loss (0 when it is not
    finite)."""

    @torch.no_grad()
    def step(state: TrainState, images, targets, valid_mask=None) -> torch.Tensor:
        params = state.ema.shadow if use_ema else state.params
        pred, _ = unet_apply(unet_cfg, params, state.batch_stats, images, compute_dtype=compute_dtype,
                             channels_last=channels_last)
        loss, _ = _global_mse(mesh, *_squared_error_and_count(pred, targets, valid_mask if masked else None))
        return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))

    return step


def _batches(images, depths, perm: np.ndarray, masks: np.ndarray):
    """The gathered (images, targets, mask) of each row of perm, on the
    dataset's device."""
    dev = images.device
    for idx, m in zip(torch.as_tensor(perm, device=dev), torch.as_tensor(masks, device=dev)):
        yield images.index_select(0, idx), depths.index_select(0, idx), m


def train_epoch(step: TrainStep, state: TrainState, images, depths, perm: np.ndarray, masks: np.ndarray):
    """One training epoch over padded static-shape batches: perm and masks
    are (n_batches, batch) sample indices and validity, as
    ``BatchIterator.padded_epoch_indices`` gives them. Batch for batch the
    math of the JAX package's scan-epoch program (``make_train_epoch_fn``).
    Returns (state, mean loss as a device scalar)."""
    losses = []
    for img, dep, m in _batches(images, depths, perm, masks):
        state, loss = step(state, img, dep, m)
        losses.append(loss)
    return state, torch.stack(losses).mean()


def eval_epoch(eval_step, state: TrainState, images, depths, perm: np.ndarray, masks: np.ndarray) -> torch.Tensor:
    """Mean eval loss over padded batches (``make_eval_epoch_fn``)."""
    return torch.stack([eval_step(state, img, dep, m) for img, dep, m in _batches(images, depths, perm, masks)]).mean()
