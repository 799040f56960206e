"""Device-resident baked dataset, the port of ``gelslim_depth_tpu/data/dataset.py``.

Each object file is preprocessed once on the host, in numpy (difference
image -> per-finger split -> area resize -> optional blur), statistics are
taken over the baked arrays, the whole set is normalized in one pass, and
the result lives on the device; a training batch is then a gather.

Reference semantics kept (ref gelslim_depth/datasets/general_dataset.py):
- separate_fingers: the 6-channel dual-finger image splits into two
  3-channel samples concatenated along the batch axis, doubling N (:69-77);
  depth 2ch -> two 1ch the same way;
- difference image vs base_tactile_image per finger (:70-71);
- input size = (int(H*downsample_factor), int(W*downsample_factor)) of the
  FIRST object file (:66-67);
- Gaussian blur of depth when depth_image_blur_kernel > 1 (:74-75);
- object_index tags (:88); the extra (real_data) directory restarts its
  object indices at 0 (:99-132);
- max_datapoints_per_object random subsetting (:91-97), from the same
  ``RandomState(seed)`` draws as the JAX package;
- train-set statistics: depth (min, max, mean, std) over all depth values,
  image per-channel (mins, maxes, means, stds), std unbiased like torch
  (:189-209); val/test receive the train set's parameters;
- both 'depth_image' and 'depth_images' keys.

The resize is any of ``ops.resize``'s methods, with its weight matrices
applied in numpy. ``channels_last=True`` stores NHWC ``(N, h, w, C)``
tensors, as the JAX package's bake does, for ``unet_apply(channels_last=True)``.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch.data.pt_io import load_pt
from gelslim_depth_tpu_torch.ops.image import _gaussian_kernel_1d
from gelslim_depth_tpu_torch.ops.normalize import depth_norm_coeffs, image_norm_coeffs
from gelslim_depth_tpu_torch.ops.resize import METHODS, weight_matrix
from gelslim_depth_tpu_torch.utils.device import resolve_device


def _float32(v) -> np.ndarray:
    """A loaded value (numpy array or CPU tensor, bfloat16 included) as a
    float32 array."""
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v, np.float32)


def _get_depth(data: Dict) -> Optional[np.ndarray]:
    for key in ("depth_image", "depth_images"):
        if key in data:
            return _float32(data[key])
    return None


@dataclasses.dataclass
class BakedDataset:
    """Preprocessed, normalized, device-resident tensors. Statistics are
    always taken and frozen in float32, whatever the storage dtype;
    channels_last=True stores the images NHWC."""

    tactile_image: torch.Tensor  # (N, 3, h, w) normalized (or NHWC)
    depth_image: torch.Tensor    # (N, 1, h, w) normalized, float32 (or NHWC)
    object_index: torch.Tensor   # (N,) int32
    depth_normalization_parameters: Tuple[float, float, float, float]
    image_normalization_parameters: Tuple[list, list, list, list]
    input_tactile_image_size: Tuple[int, int]
    channels_last: bool = False

    def __len__(self) -> int:
        return int(self.tactile_image.shape[0])


def _np_resize(x: np.ndarray, size: Tuple[int, int], method: str = "area") -> np.ndarray:
    """Host-side resize with the weight matrices of ``ops.resize``."""
    h_in, w_in = x.shape[-2:]
    h_out, w_out = int(size[0]), int(size[1])
    if (h_in, w_in) == (h_out, w_out):
        return x
    ah = weight_matrix(h_in, h_out, method)
    aw = weight_matrix(w_in, w_out, method)
    y = np.einsum("oh,...hw->...ow", ah, x, optimize=True)
    return np.einsum("pw,...ow->...op", aw, y, optimize=True).astype(np.float32)


def _np_gaussian_blur(x: np.ndarray, k: int) -> np.ndarray:
    kern = _gaussian_kernel_1d(int(k))
    pad = k // 2
    nd = x.ndim
    y = np.pad(x, [(0, 0)] * (nd - 2) + [(pad, pad), (0, 0)], mode="reflect")
    y = np.apply_along_axis(lambda a: np.convolve(a, kern, mode="valid"), -2, y)
    y = np.pad(y, [(0, 0)] * (nd - 2) + [(0, 0), (pad, pad)], mode="reflect")
    return np.apply_along_axis(lambda a: np.convolve(a, kern, mode="valid"), -1, y).astype(np.float32)


def _preprocess_object(
    data: Dict,
    *,
    use_difference_image: bool,
    separate_fingers: bool,
    target_size: Tuple[int, int],
    depth_image_blur_kernel: int,
    interp_method: str,
) -> Tuple[np.ndarray, np.ndarray]:
    """One object's dict -> (tactile (M,3,h,w), depth (M,1,h,w)) float32."""
    img = _float32(data["tactile_image"])
    depth = _get_depth(data)
    if depth is None:
        depth = np.zeros((img.shape[0], 2, img.shape[2], img.shape[3]), np.float32)

    if use_difference_image:
        base = _float32(data["base_tactile_image"])
        if base.ndim == 3:
            base = base[None]
        img = (img - base[:, : img.shape[1]] + 255.0) / 2.0

    if separate_fingers:
        img = np.concatenate([img[:, 0:3], img[:, 3:6]], axis=0)
        depth = np.concatenate([depth[:, 0:1], depth[:, 1:2]], axis=0)

    img = _np_resize(img, target_size, interp_method)
    depth = _np_resize(depth, target_size, interp_method)
    if depth_image_blur_kernel > 1:
        depth = _np_gaussian_blur(depth, depth_image_blur_kernel)
    return img, depth


def _unbiased_std(x: np.ndarray) -> float:
    return float(np.std(x.astype(np.float64), ddof=1))


def _load_all(directory: str, files: Sequence[str]) -> List[Dict]:
    """Load the files in parallel: the IO fans out over a thread pool."""
    paths = [os.path.join(directory, f) for f in files]
    if len(paths) <= 1:
        return [load_pt(p) for p in paths]
    with ThreadPoolExecutor(min(8, len(paths))) as ex:
        return list(ex.map(load_pt, paths))


def bake_dataset(
    directory: Optional[str] = None,
    pt_file_list: Optional[Sequence[str]] = None,
    extra_directory: Optional[str] = None,
    extra_pt_list: Optional[Sequence[str]] = None,
    *,
    use_difference_image: bool = False,
    depth_normalization_method: str = "min_max_to_0_-1",
    image_normalization_method: str = "mean_std",
    separate_fingers: bool = True,
    downsample_factor: float = 0.5,
    depth_image_blur_kernel: int = 1,
    depth_normalization_parameters=None,
    image_normalization_parameters=None,
    norm_scale: Optional[float] = None,
    max_datapoints_per_object: Optional[int] = None,
    interp_method: str = "area",
    seed: int = 0,
    device=None,
    preloaded: Optional[Sequence[Dict]] = None,
    extra_preloaded: Optional[Sequence[Dict]] = None,
    channels_last: bool = False,
    image_store_dtype: Optional[torch.dtype] = None,
    stats_reduce=None,
) -> BakedDataset:
    """Load + preprocess + normalize a dataset split into device tensors, on
    ``cuda`` unless device says otherwise.

    Mirrors GeneralDataset's constructor contract (general_dataset.py:12-14);
    `preloaded` passes dicts directly. interp_method is any of
    ``ops.resize``'s. channels_last stores NHWC (see BakedDataset).
    image_store_dtype (e.g.
    torch.bfloat16) casts the stored TACTILE images after the float32
    statistics and normalization; depth targets stay float32.

    stats_reduce((tactile_raw, depth_raw) -> (depth_params, image_params))
    replaces the local statistics when normalization parameters are not
    given: the hook for baking a shard per process with statistics reduced
    over all of them.
    """
    if interp_method not in METHODS:
        raise ValueError(f"interp_method {interp_method!r}: expected one of {METHODS}")
    device = resolve_device(device)
    rng = np.random.RandomState(seed)

    sources: List[Tuple[Dict, int]] = []
    if preloaded is not None:
        sources += [(d, i) for i, d in enumerate(preloaded)]
    elif pt_file_list:
        if not (directory and os.path.exists(directory)):
            raise FileNotFoundError(f"Dataset path {directory} does not exist")
        sources += [(d, i) for i, d in enumerate(_load_all(directory, pt_file_list))]
    if extra_preloaded is not None:
        sources += [(d, i) for i, d in enumerate(extra_preloaded)]
    elif extra_pt_list and extra_directory:
        sources += [(d, i) for i, d in enumerate(_load_all(extra_directory, extra_pt_list))]
    if not sources:
        raise ValueError("no data sources given")

    first_shape = sources[0][0]["tactile_image"].shape
    target_size = (int(first_shape[2] * downsample_factor), int(first_shape[3] * downsample_factor))

    imgs, depths, obj_idx = [], [], []
    for data, index in sources:
        img, depth = _preprocess_object(
            data,
            use_difference_image=use_difference_image,
            separate_fingers=separate_fingers,
            target_size=target_size,
            depth_image_blur_kernel=depth_image_blur_kernel,
            interp_method=interp_method,
        )
        if max_datapoints_per_object is not None and img.shape[0] > max_datapoints_per_object:
            sel = rng.permutation(img.shape[0])[:max_datapoints_per_object]
            img, depth = img[sel], depth[sel]
        imgs.append(img)
        depths.append(depth)
        obj_idx.append(np.full((img.shape[0],), index, np.int32))

    tactile = np.concatenate(imgs, axis=0)
    depth = np.concatenate(depths, axis=0)
    object_index = np.concatenate(obj_idx, axis=0)

    if stats_reduce is not None and (
        depth_normalization_parameters is None or image_normalization_parameters is None
    ):
        reduced_depth, reduced_image = stats_reduce(tactile, depth)
        if depth_normalization_parameters is None:
            depth_normalization_parameters = reduced_depth
        if image_normalization_parameters is None:
            image_normalization_parameters = reduced_image
    if depth_normalization_parameters is None:
        depth_normalization_parameters = (
            float(depth.min()), float(depth.max()), float(depth.mean(dtype=np.float64)), _unbiased_std(depth),
        )
    if image_normalization_parameters is None:
        c = tactile.shape[1]
        image_normalization_parameters = (
            [float(tactile[:, i].min()) for i in range(c)],
            [float(tactile[:, i].max()) for i in range(c)],
            [float(tactile[:, i].mean(dtype=np.float64)) for i in range(c)],
            [_unbiased_std(tactile[:, i]) for i in range(c)],
        )

    # one normalization pass on the host with the folded-affine coefficients
    # of ops.normalize_*, then one copy of the finished arrays to the device
    s, b, d = image_norm_coeffs(
        image_normalization_method, norm_scale, image_normalization_parameters, tactile.shape[1]
    )
    mult = (s / d).astype(np.float32).reshape(1, -1, 1, 1)
    add = (-b * s / d).astype(np.float32).reshape(1, -1, 1, 1)
    tactile_n = torch.from_numpy(tactile * mult + add)
    ds_, db_, dd_ = depth_norm_coeffs(depth_normalization_method, norm_scale, depth_normalization_parameters)
    depth_n = torch.from_numpy(depth * np.float32(ds_ / dd_) + np.float32(-db_ * ds_ / dd_))
    if channels_last:
        tactile_n = tactile_n.permute(0, 2, 3, 1).contiguous()
        depth_n = depth_n.permute(0, 2, 3, 1).contiguous()
    if image_store_dtype is not None:
        tactile_n = tactile_n.to(image_store_dtype)

    return BakedDataset(
        tactile_image=tactile_n.to(device),
        depth_image=depth_n.to(device),
        object_index=torch.from_numpy(object_index).to(device),
        depth_normalization_parameters=tuple(depth_normalization_parameters),
        image_normalization_parameters=tuple(image_normalization_parameters),
        input_tactile_image_size=target_size,
        channels_last=channels_last,
    )


class BatchIterator:
    """Shuffled epoch iterator over a BakedDataset: gathers on the dataset's
    device, the permutation on the host from ``RandomState(seed)``, so the
    same seed gives the JAX package's batches (shuffle=True,
    drop_last=False like ref train_unet.py:229-233)."""

    def __init__(self, dataset: BakedDataset, batch_size: int, *, shuffle: bool = True, seed: int = 0):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return -(-len(self.ds) // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.ds)
        return self._rng.permutation(n) if self.shuffle else np.arange(n)

    def _take(self, idx: np.ndarray):
        sel = torch.as_tensor(idx, device=self.ds.tactile_image.device)
        return self.ds.tactile_image.index_select(0, sel), self.ds.depth_image.index_select(0, sel), sel

    def epoch(self):
        """Yields (images, targets, object_index) batches; the last may be short."""
        order = self._order()
        for start in range(0, len(self.ds), self.batch_size):
            img, dep, sel = self._take(order[start : start + self.batch_size])
            yield img, dep, self.ds.object_index.index_select(0, sel)

    def padded_epoch_indices(self, pad_to_multiple_of: Optional[int] = None):
        """One epoch's shuffled sample indices as stacked static-shape
        arrays: (perm (n_batches, bs) int32, masks (n_batches, bs) bool);
        the ragged tail pads by repeating sample 0 with mask False."""
        bs = self.batch_size
        if pad_to_multiple_of:
            bs = -(-bs // pad_to_multiple_of) * pad_to_multiple_of
        order = self._order()
        n_batches = -(-len(self.ds) // self.batch_size)
        perm = np.zeros((n_batches, bs), np.int32)
        masks = np.zeros((n_batches, bs), bool)
        for b in range(n_batches):
            chunk = order[b * self.batch_size : (b + 1) * self.batch_size]
            perm[b, : len(chunk)] = chunk
            masks[b, : len(chunk)] = True
        return perm, masks

    def padded_epoch(self, pad_to_multiple_of: Optional[int] = None):
        """Epoch with every batch padded to the full batch size (and
        optionally a multiple): yields (images, targets, valid_mask)."""
        perm, masks = self.padded_epoch_indices(pad_to_multiple_of)
        for idx, valid in zip(perm, masks):
            img, dep, _ = self._take(idx)
            yield img, dep, torch.as_tensor(valid, device=img.device)
