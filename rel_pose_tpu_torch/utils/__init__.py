"""Weight conversion, precision, profiling (counterpart of
rel_pose_tpu.utils)."""

from .profiling import StepTimer, trace

__all__ = ["StepTimer", "trace"]
