"""Preprocessing, positional encoding and the kernel-backed ops (counterpart of rel_pose_tpu.ops)."""
