"""Drop-in GeneralDataset facade over the baked pipeline, the port of
``gelslim_depth_tpu/data/general_dataset.py``.

For users migrating from the reference's torch Dataset
(ref gelslim_depth/datasets/general_dataset.py:12-14,220-231): the same
constructor signature and the same `__len__`/`__getitem__` contract
yielding {'tactile_image', 'depth_image', 'object_index'} dicts of numpy
arrays, except that samples come pre-normalized out of the device-resident
bake. `depth_normalization_parameters`, `image_normalization_parameters`
and `input_tactile_image_size` match the reference's state after
construction (train_unet.py:208-216 reads them).
"""

from __future__ import annotations

from typing import Optional, Sequence

from gelslim_depth_tpu_torch.data.dataset import BakedDataset, bake_dataset


class GeneralDataset:
    def __init__(
        self,
        directory: Optional[str] = None,
        pt_file_list: Optional[Sequence[str]] = None,
        extra_directory: Optional[str] = None,
        extra_pt_list: Optional[Sequence[str]] = None,
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
        device=None,
        interp_method: Optional[str] = "area",
    ) -> None:
        self.baked: BakedDataset = bake_dataset(
            directory,
            pt_file_list,
            extra_directory,
            extra_pt_list,
            use_difference_image=use_difference_image,
            depth_normalization_method=depth_normalization_method,
            image_normalization_method=image_normalization_method,
            separate_fingers=separate_fingers,
            downsample_factor=downsample_factor,
            depth_image_blur_kernel=depth_image_blur_kernel,
            depth_normalization_parameters=depth_normalization_parameters,
            image_normalization_parameters=image_normalization_parameters,
            norm_scale=norm_scale,
            max_datapoints_per_object=max_datapoints_per_object,
            interp_method=interp_method or "area",
            device=device,
        )
        self.depth_normalization_parameters = self.baked.depth_normalization_parameters
        self.image_normalization_parameters = self.baked.image_normalization_parameters
        self.input_tactile_image_size = self.baked.input_tactile_image_size
        self.depth_normalization_method = depth_normalization_method
        self.image_normalization_method = image_normalization_method
        self.norm_scale = norm_scale

    def __len__(self) -> int:
        return len(self.baked)

    def __getitem__(self, idx):
        return {
            "tactile_image": self.baked.tactile_image[idx].cpu().numpy(),
            "depth_image": self.baked.depth_image[idx].cpu().numpy(),
            "object_index": self.baked.object_index[idx].cpu().numpy(),
        }
