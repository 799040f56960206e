"""Fused inference: the deployable RGB -> mm-depth chain, in PyTorch.

The reference's inference chain is resize -> normalize -> UNet ->
denormalize -> resize-back (ref test_utils/test_depth_estimation.py:14-20,
processing_utils/complete_prediction.py:4-10), optionally preceded by the
dual-finger base-image subtraction. On a CUDA device the dual-frame path
runs its diff + resize + normalize front end as one hand-written kernel
(``ops.kernels.fused_preprocess_dual``), the U-Net as cuDNN convolutions
(``Predictor``) or as hand-written int8 convolutions
(``ops.kernels.conv2d_int8``, ``QuantizedPredictor``), and the denormalize +
resize-back as plain tensor ops. ``StreamingEngine`` feeds a predictor a
live stream of single frames, coalescing those that arrive while the
device is busy into micro-batches.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch import ops
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.models.unet import UNet
from gelslim_depth_tpu_torch.utils.device import resolve_device


def _preprocess(config: GelslimConfig, images: torch.Tensor) -> torch.Tensor:
    x = ops.resize(images, config.input_tactile_image_size, config.interp_method)
    return ops.normalize_tactile_image(
        x, config.image_normalization_method, config.norm_scale, config.image_normalization_parameters
    )


def fused_predict(
    config: GelslimConfig, net: Callable, images: torch.Tensor, output_size: Tuple[int, int]
) -> torch.Tensor:
    """resize -> normalize -> UNet(eval) -> denormalize -> resize-back.

    images: (N, 3, H, W) tactile (or difference) images in [0, 255].
    net maps the NCHW network input to NCHW float32 logits: a ``UNet``, or
    a quantized one's forward. Returns (N, 1, *output_size) depth in mm (<= 0).
    """
    return _postprocess(config, net(_preprocess(config, images)), output_size)


def _denormalize(config: GelslimConfig, y: torch.Tensor) -> torch.Tensor:
    return ops.denormalize_depth_image(
        y, config.depth_normalization_method, config.norm_scale, config.depth_normalization_parameters
    )


def _postprocess(config: GelslimConfig, y: torch.Tensor, output_size) -> torch.Tensor:
    return ops.resize(_denormalize(config, y), output_size, config.interp_method)


def kernel_front_end(config: GelslimConfig, frames: torch.Tensor, base_frame: Optional[torch.Tensor],
                     out_size: Tuple[int, int]) -> torch.Tensor:
    """The diff + area resize + normalize front end as one
    ``fused_preprocess_dual`` launch: (N, 6, H, W) frames and a shared (6,
    H, W) base (or None) -> (2N, 3, *out_size), rows [0, N) the left
    finger's, [N, 2N) the right's."""
    from gelslim_depth_tpu_torch.ops.kernels import fused_preprocess_dual

    scale, bias, denom = ops.image_norm_coeffs(
        config.image_normalization_method, config.norm_scale, config.image_normalization_parameters, 3,
    )
    use_diff = bool(config.use_difference_image and base_frame is not None)
    return fused_preprocess_dual(
        frames.contiguous(),
        base_frame.contiguous() if use_diff else None,
        (scale / denom).astype(np.float32),
        (-bias * scale / denom).astype(np.float32),
        out_size=out_size,
        use_diff=use_diff,
    )


def dual_frames_to_fingers(
    config: GelslimConfig, frames: torch.Tensor, base_frame: Optional[torch.Tensor]
) -> torch.Tensor:
    """(N, 6, H, W) dual frames -> (2N, 3, H, W) per-finger images after the
    configured difference-image step (rows interleave frame-left/frame-right).
    base_frame is (6, H, W) or (N, 6, H, W)."""
    n, _, h, w = frames.shape
    fingers = frames.reshape(n, 2, 3, h, w)
    if config.use_difference_image and base_frame is not None:
        fingers = ops.get_difference_image(fingers, base_frame.reshape(-1, 2, 3, h, w))
    return fingers.reshape(2 * n, 3, h, w)


def fused_predict_dual(
    config: GelslimConfig,
    net: Callable,
    frames: torch.Tensor,
    base_frame: Optional[torch.Tensor],
    output_size: Tuple[int, int],
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Full dual-GelSlim frame path: (N, 6, H, W) raw frames (left 0:3,
    right 3:6) -> per-finger difference vs base_frame (6, H, W) or (N, 6,
    H, W) -> both fingers batched through the network -> (N, 2, *output_size)
    mm depth.

    use_kernel routes the diff+resize+normalize front end through
    ``fused_preprocess_dual``; None takes it when the frames are on CUDA.
    The kernel hard-wires the area resize and a shared (6, H, W) base, so
    another interp_method or a batched (N, 6, H, W) base takes the composed
    path."""
    n = frames.shape[0]
    if use_kernel is None:
        use_kernel = frames.is_cuda
    use_kernel = use_kernel and config.interp_method == "area"
    if use_kernel and (base_frame is None or base_frame.ndim == 3):
        x = kernel_front_end(config, frames, base_frame, config.input_tactile_image_size)
        depth = _postprocess(config, net(x), output_size)
        # kernel layout: rows [0, n) = left finger, [n, 2n) = right
        return torch.stack([depth[:n, 0], depth[n:, 0]], dim=1)
    fingers = dual_frames_to_fingers(config, frames, base_frame)
    depth = fused_predict(config, net, fingers, output_size)
    return depth.reshape(n, 2, *output_size)


class _Serving:
    """The predict API over ``self._net()``, a callable from the NCHW
    network input to NCHW float32 logits, on ``self.device``. Inputs may be
    numpy arrays or tensors on any device; outputs are float32 tensors on
    the predictor's device."""

    config: GelslimConfig
    device: torch.device

    def _net(self) -> Callable:
        raise NotImplementedError

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def predict_depth_from_RGB(self, images, output_size: Tuple[int, int]) -> torch.Tensor:
        """(N, 3, H, W) [0,255] images -> (N, 1, *output_size) mm depth."""
        return fused_predict(self.config, self._net(), self._tensor(images), tuple(output_size))

    @torch.inference_mode()
    def predict_dual_frames(self, frames, base_frame, output_size: Tuple[int, int]) -> torch.Tensor:
        """(N, 6, H, W) dual frames (+ base) -> (N, 2, *output_size) mm depth."""
        base = None if base_frame is None else self._tensor(base_frame)
        return fused_predict_dual(
            self.config, self._net(), self._tensor(frames), base, tuple(output_size)
        )

    def predict_dual_frames_multi(self, frames_list, base_frame, output_size) -> torch.Tensor:
        """Micro-batch entry: a list/tuple of k (1, 6, H, W) frames ->
        (k, 2, *output_size), concatenated into one call."""
        frames = torch.cat([self._tensor(f) for f in frames_list], dim=0)
        return self.predict_dual_frames(frames, base_frame, output_size)

    def __call__(self, images, output_size: Tuple[int, int]) -> torch.Tensor:
        return self.predict_depth_from_RGB(images, output_size)


class Predictor(_Serving):
    """Bundles config + weights into single-finger and dual-frame
    predictors on one device.

    The reference's external-API contract (README.md:130-178): build model
    from a config module, load weights, call predict_depth_from_RGB:

        cfg = GelslimConfig.from_python_module('...config_unet_bigdata')
        pred = Predictor.from_torch_checkpoint('unet_bigdata.pth', cfg)
        depth_mm = pred.predict_depth_from_RGB(diff_images, (320, 427))

    state_dict is the reference-layout U-Net state dict (tensors or numpy
    arrays); the predictor keeps it as given, and ``quantize`` calibrates a
    float32 U-Net built from it whatever the compute dtype. device
    defaults to ``cuda`` and raises when no CUDA device is present.
    """

    def __init__(
        self,
        config: GelslimConfig,
        state_dict,
        *,
        compute_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.config = config
        self.unet_cfg = config.unet_config()
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.state_dict = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        self.net = self._unet().to_compute_dtype(compute_dtype)

    def _unet(self) -> UNet:
        with torch.device(self.device):
            net = UNet(self.unet_cfg)
        net.load_state_dict(self.state_dict)
        return net

    def _net(self) -> Callable:
        return self.net

    @classmethod
    def from_torch_checkpoint(cls, path: str, config: GelslimConfig, **kw) -> "Predictor":
        from gelslim_depth_tpu_torch.models.torch_import import load_torch_checkpoint

        return cls(config, load_torch_checkpoint(path, config.unet_config()), **kw)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, name: str = None, **kw) -> "Predictor":
        from gelslim_depth_tpu_torch.models.torch_import import params_from_jax
        from gelslim_depth_tpu_torch.train.checkpoint import load_checkpoint

        config, params, stats = load_checkpoint(ckpt_dir, name)
        return cls(config, params_from_jax(params, stats, config.unet_config()), **kw)

    def quantize(
        self, calib_frames, base_frame=None, *,
        percentile: float = 100.0, quantize_upconvs: bool = False,
    ) -> "QuantizedPredictor":
        """Post-training int8 quantization calibrated on representative raw
        dual frames (N, 6, H, W), from the float32 weights whatever the
        predictor's compute dtype. Returns a drop-in predictor that serves in
        the same compute dtype, its quantized convs on ``conv2d_int8``.
        percentile < 100 clips activation-scale outliers. quantize_upconvs
        also runs the transposed convs in int8 as row-split 1x1 convs.
        Check .delta_mm, the output deviation from the float graph on the
        calibration batch, before deploying."""
        from gelslim_depth_tpu_torch.models.quantize import quantize_unet

        # a float32 UNet of its own: the quantized model moves between
        # devices without taking this predictor's net along
        q = quantize_unet(
            self._unet(), _calibration_inputs(self.config, calib_frames, base_frame, self.device),
            percentile=percentile, quantize_upconvs=quantize_upconvs,
        )
        return QuantizedPredictor(self.config, q, compute_dtype=self.compute_dtype, device=self.device)


@torch.inference_mode()
def _calibration_inputs(cfg: GelslimConfig, calib_frames, base_frame, device) -> torch.Tensor:
    """Calibration preprocessing == serving preprocessing: the composed
    diff/resize/normalize chain of ``fused_predict_dual``, honoring
    config.interp_method and batched (N, 6, H, W) base frames (the kernel
    front end computes the same values for the area case within float32
    summation order, so this calibrates both front ends)."""
    frames = torch.as_tensor(calib_frames, dtype=torch.float32, device=device)
    base = None if base_frame is None else torch.as_tensor(base_frame, dtype=torch.float32, device=device)
    return _preprocess(cfg, dual_frames_to_fingers(cfg, frames, base))


class QuantizedPredictor(_Serving):
    """Predictor running the int8-quantized U-Net (``models/quantize.py``)
    inside the same pre- and post-processing as ``Predictor``, with the same
    predict API. Build one with ``Predictor.quantize(calib_frames)`` or
    ``QuantizedPredictor.from_checkpoint``. Runs on ``cuda`` unless
    ``device="cpu"`` is passed."""

    def __init__(self, config: GelslimConfig, q, *, compute_dtype: torch.dtype = torch.bfloat16, device=None):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {compute_dtype}")
        self.config = config
        self.device = resolve_device(device)
        self.q = q.to(self.device)
        self.compute_dtype = compute_dtype

    def _net(self) -> Callable:
        return functools.partial(self.q, compute_dtype=self.compute_dtype)

    @property
    def delta_mm(self) -> float:
        """Calibration-batch output RMSE vs the float graph, in mm.

        The network output is in normalized-depth units; the mm factor is
        the denormalization slope of the configured depth method
        (ref normalization_utils.py:101-130): (max-min)/norm_scale for the
        min_max methods, std for mean_std."""
        cfg = self.config
        p = cfg.depth_normalization_parameters
        if p is None:
            raise ValueError(
                "delta_mm needs config.depth_normalization_parameters "
                "(the frozen training statistics) to convert to mm"
            )
        if cfg.depth_normalization_method == "mean_std":
            factor = float(p[3])
        else:
            factor = abs(float(p[1]) - float(p[0])) / cfg.norm_scale
        return float(self.q.float_delta) * factor

    def save(self, ckpt_dir: str, name: str = None) -> str:
        """Persist the quantized model so serving skips re-calibration."""
        from gelslim_depth_tpu_torch.train.checkpoint import save_quantized

        return save_quantized(ckpt_dir, self.config, self.q, name=name)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, name: str = None, **kw) -> "QuantizedPredictor":
        from gelslim_depth_tpu_torch.train.checkpoint import load_quantized

        config, q = load_quantized(ckpt_dir, name)
        return cls(config, q, **kw)

    def recalibrate(self, calib_frames, base_frame=None, *, percentile: float = 100.0) -> "QuantizedPredictor":
        """Re-derive the activation scales from new representative frames
        on the same int8 weights, in place: the scale tensors are
        overwritten, nothing is rebuilt. Check .delta_mm afterwards. Returns
        self for chaining."""
        from gelslim_depth_tpu_torch.models.quantize import calibrate_act_scales, measure_float_delta

        q = self.q
        x = _calibration_inputs(self.config, calib_frames, base_frame, self.device)
        q.set_act_scales(calibrate_act_scales(
            q.net, x, percentile=percentile, quantize_upconvs=q.has_int8_upconvs,
        ))
        q.float_delta.fill_(measure_float_delta(q, x))
        return self


def predict_depth_from_RGB(images, model: Predictor, output_size, config: GelslimConfig = None):
    """Reference-signature convenience wrapper
    (ref complete_prediction.py:4 — with the attribute-name bug fixed)."""
    return model.predict_depth_from_RGB(images, output_size)


class _Completed:
    """The "done" object of a dispatch that finished when it returned (a
    predictor on the CPU)."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


def _completion(out):
    """The dispatch's "done" object, with ``query()`` (does not block) and
    ``synchronize()``: a ``torch.cuda.Event`` recorded on the current stream
    right after a dispatch on CUDA, else one that is already done."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        return event
    return _Completed()


class _Dispatch:
    """One predictor call covering k queued frames."""

    __slots__ = ("out", "done", "k", "realized", "t_done")

    def __init__(self, out, k):
        self.out = out          # (k, 2, h, w) tensor; None once realized
        self.done = _completion(out)
        self.k = k
        self.realized = None    # np.ndarray once read back
        self.t_done = None      # host time of realization


class StreamingEngine:
    """Video-rate streaming harness for dual-GelSlim frames, with adaptive
    micro-batching: frames that arrive while the device is busy coalesce
    into one dispatch.

    submit(frame) enqueues and returns without waiting for the device;
    results come back with get()/drain() in FIFO order, as numpy arrays.
    Dispatch policy: at most ``max_dispatches`` predictor calls are
    outstanding at once (slots are freed by non-blocking completion checks,
    a ``torch.cuda.Event`` recorded after each dispatch, or by the consumer
    realizing results). When the device is idle a lone frame dispatches at
    once; when all slots are busy, arriving frames queue on the host and
    the next free slot dispatches them together as one micro-batch of up to
    ``microbatch`` frames (power-of-2 bucketed), one
    ``predict_dual_frames_multi`` call, so a coalesced dispatch costs one
    call's host overhead. The engine takes any predictor with
    ``predict_dual_frames_multi``: ``Predictor``, ``QuantizedPredictor``.

    Upload: for a predictor on CUDA each host frame is staged into a fresh
    pinned host tensor and copied to the card with ``non_blocking=True`` at
    submit, so submit does not wait for the dispatch in flight (a pageable
    copy would synchronize the stream). A fresh tensor per frame: torch's
    caching host allocator keeps a pinned block until its copy has landed.

    Queue semantics on the FIFO of unclaimed frames:
    - Bounded depth (max_inflight, counted in frames): a sensor outrunning
      the device cannot grow host or device queues without bound.
    - Drop policy when the queue is full at submit:
        'oldest' (default): discard the oldest unclaimed frame and admit
          the new one, the live-view behavior. A dropped frame that was
          already dispatched is not cancelled, only its result discarded.
        'newest': refuse the new frame (submit returns False), the
          lossless-logging behavior.
        'block': wait for the oldest outstanding dispatch's device work to
          finish, then admit. Nothing is dropped; if the consumer never
          drains, the unclaimed-result queue grows without bound, and the
          engine warns (once) past ``results_warn`` unclaimed frames.
    - update_base(frame): swap the base frame between submissions.
      Queued but undispatched frames are flushed with the old base first.
    - flush(): dispatch everything queued without waiting for free slots.
    - stats(): throughput, latency and dispatch-size self-report.

    ``chip_smoke.py`` measures the engine's frames/s, latency and dispatch
    size on the card at micro-batches 1, 2 and 4 (PERF.md)."""

    def __init__(
        self,
        predictor,
        output_size: Tuple[int, int],
        base_frame=None,
        *,
        max_inflight: int = 4,
        drop_policy: str = "oldest",
        microbatch: int = 4,
        max_dispatches: int = 2,
        results_warn: int = 64,
    ):
        if drop_policy not in ("oldest", "newest", "block"):
            raise ValueError(f"drop_policy {drop_policy!r}: want oldest|newest|block")
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if microbatch < 1:
            raise ValueError("microbatch must be >= 1")
        if max_dispatches < 1:
            raise ValueError("max_dispatches must be >= 1")
        self.predictor = predictor
        device = getattr(predictor, "device", None)
        self._cuda = device if device is not None and torch.device(device).type == "cuda" else None
        self.output_size = tuple(output_size)
        self.base_frame = None if base_frame is None else self._stage(base_frame)
        self.max_inflight = int(max_inflight)
        self.drop_policy = drop_policy
        self.microbatch = int(microbatch)
        self.max_dispatches = int(max_dispatches)
        self.results_warn = int(results_warn)
        # FIFO of unclaimed frames: [frame|None, _Dispatch|None, row, t_submit]
        self._queue = []
        self._outstanding = []  # dispatches whose device work may still run
        self._warned = False
        self._submitted = 0
        self._dropped = 0
        self._completed = 0
        self._n_dispatches = 0
        self._frames_dispatched = 0
        self._latency_sum = 0.0
        self._first_submit_time = None
        self._last_complete_time = None

    # -- dispatch machinery ------------------------------------------------
    def _stage(self, x) -> torch.Tensor:
        """A host frame as a float32 tensor; on the predictor's card when
        that is CUDA, through a fresh pinned buffer and a copy that does not
        block the host."""
        t = torch.as_tensor(x, dtype=torch.float32)
        if self._cuda is None or t.is_cuda:
            return t
        pinned = torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(self._cuda, non_blocking=True)

    def _pending_items(self):
        return [it for it in self._queue if it[1] is None]

    def _dispatch(self, items) -> None:
        frames = [it[0] for it in items]
        out = self.predictor.predict_dual_frames_multi(frames, self.base_frame, self.output_size)
        d = _Dispatch(out, len(items))
        for row, it in enumerate(items):
            it[0] = None
            it[1] = d
            it[2] = row
        self._outstanding.append(d)
        self._n_dispatches += 1
        self._frames_dispatched += len(items)

    def _dispatch_pending(self, bounded: bool) -> None:
        """Dispatch queued frames in power-of-2 micro-batches: while a slot
        is free, or all of them when not ``bounded``."""
        while not bounded or len(self._outstanding) < self.max_dispatches:
            pend = self._pending_items()
            if not pend:
                return
            k = min(len(pend), self.microbatch)
            self._dispatch(pend[: 1 << (k.bit_length() - 1)])

    def _pump(self) -> None:
        # free slots held by dispatches whose device work finished (in
        # order on one stream; query() does not block)
        while self._outstanding and (
            self._outstanding[0].realized is not None or self._outstanding[0].done.query()
        ):
            self._outstanding.pop(0)
        self._dispatch_pending(bounded=True)

    def _realize(self, d: _Dispatch) -> np.ndarray:
        if d.realized is None:
            d.realized = d.out.cpu().numpy()
            d.out = None
            d.t_done = time.perf_counter()
        return d.realized

    def _claim(self, item) -> np.ndarray:
        d, row = item[1], item[2]
        arr = self._realize(d)
        self._completed += 1
        self._latency_sum += d.t_done - item[3]
        if self._last_complete_time is None or d.t_done > self._last_complete_time:
            self._last_complete_time = d.t_done
        return arr[row:row + 1]

    # -- public API --------------------------------------------------------
    def update_base(self, base_frame) -> None:
        self.flush()  # queued frames keep the base they were submitted under
        self.base_frame = None if base_frame is None else self._stage(base_frame)

    def flush(self) -> None:
        """Dispatch every queued but undispatched frame now, ignoring the
        dispatch-slot bound (a bounded burst: the queue itself is bounded)."""
        self._dispatch_pending(bounded=False)

    def submit(self, frame) -> bool:
        """Enqueue one dual frame, (6, H, W) or (1, 6, H, W); returns True
        if admitted (False only under drop_policy='newest' with a full
        queue)."""
        if len(self._queue) >= self.max_inflight:
            if self.drop_policy == "newest":
                self._dropped += 1
                return False
            if self.drop_policy == "oldest":
                self._queue.pop(0)  # its device work, if any, is not cancelled
                self._dropped += 1
            else:  # block: bound device work; the result queue may grow
                if self._outstanding:
                    d = self._outstanding.pop(0)
                    if d.out is not None:  # not already realized by a get()
                        d.done.synchronize()
                if not self._warned and len(self._queue) > self.results_warn:
                    warnings.warn(
                        f"StreamingEngine(drop_policy='block'): {len(self._queue)} "
                        "unclaimed results queued: the consumer is not draining; "
                        "memory grows until get()/drain() is called",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    self._warned = True
        frame = self._stage(frame)
        if frame.ndim == 3:
            frame = frame[None]
        t = time.perf_counter()
        if self._first_submit_time is None:
            self._first_submit_time = t
        self._queue.append([frame, None, None, t])
        self._submitted += 1
        self._pump()
        return True

    def get(self) -> np.ndarray:
        """Realize and return the oldest unclaimed result (FIFO)."""
        if not self._queue:
            raise IndexError("get() on an empty StreamingEngine")
        if self._queue[0][1] is None:
            # head still undispatched (slots were held by dropped frames'
            # work): the consumer asked, so dispatch past the bound
            self.flush()
        item = self._queue.pop(0)
        out = self._claim(item)
        self._pump()  # realization freed a slot: coalesce what queued up
        return out

    def drain(self):
        """Realize and return all unclaimed results, in FIFO order."""
        self.flush()
        out = [self._claim(it) for it in self._queue]
        self._queue.clear()
        return out

    @property
    def pending(self) -> int:
        return len(self._queue)

    def stats(self) -> dict:
        """Self-reported counters: frames submitted/completed/dropped,
        dispatch count and mean micro-batch size, mean submit->result
        latency, and end-to-end throughput over the completed stream."""
        elapsed = (
            self._last_complete_time - self._first_submit_time
            if self._completed and self._first_submit_time is not None
            else 0.0
        )
        return {
            "submitted": self._submitted,
            "completed": self._completed,
            "dropped": self._dropped,
            "pending": len(self._queue),
            "dispatches": self._n_dispatches,
            "mean_dispatch_size": (
                self._frames_dispatched / self._n_dispatches if self._n_dispatches else None
            ),
            "mean_latency_ms": (
                1e3 * self._latency_sum / self._completed if self._completed else None
            ),
            "throughput_fps": (
                self._completed / elapsed if self._completed and elapsed > 0 else None
            ),
        }
