"""Command-line entry points of the port (``python -m
rel_pose_tpu_torch.cli.<name>``): ``train``, ``test_matterport``,
``test_streetlearn_interiornet``, ``demo``, ``generate_epipolar_imgs`` and
``convert_checkpoint``."""
