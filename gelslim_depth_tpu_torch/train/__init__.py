from gelslim_depth_tpu_torch.train.checkpoint import load_checkpoint

__all__ = ["load_checkpoint"]
