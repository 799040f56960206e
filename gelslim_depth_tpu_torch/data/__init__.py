"""Data of the port: ``.pt`` IO, the device-resident dataset bake and its
batch iterator, the GeneralDataset facade, and synthetic fixtures."""

from gelslim_depth_tpu_torch.data.pt_io import load_pt, save_pt
from gelslim_depth_tpu_torch.data.dataset import BakedDataset, BatchIterator, bake_dataset
from gelslim_depth_tpu_torch.data.general_dataset import GeneralDataset

__all__ = ["load_pt", "save_pt", "BakedDataset", "bake_dataset", "BatchIterator", "GeneralDataset"]
