"""Measurement helpers of the port (``gelslim_depth_tpu.utils``'s
counterparts; ``device_ms`` stands for ``device_time``)."""

from gelslim_depth_tpu_torch.utils.profiling import StepTimer, device_ms, trace

__all__ = ["StepTimer", "device_ms", "trace"]
