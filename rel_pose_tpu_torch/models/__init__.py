"""The ViTEss model (counterpart of rel_pose_tpu.models)."""
