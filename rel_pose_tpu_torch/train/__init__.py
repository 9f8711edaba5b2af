"""Single-GPU training: the step, the optimizer and ``.pth`` checkpoints."""
