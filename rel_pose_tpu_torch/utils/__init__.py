"""Weight conversion (counterpart of rel_pose_tpu.utils)."""
