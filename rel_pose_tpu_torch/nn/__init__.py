"""Eval-mode layers and modules (counterpart of rel_pose_tpu.nn)."""
