"""Command-line entry points of the port (``python -m
rel_pose_tpu_torch.cli.<name>``): ``train``."""
