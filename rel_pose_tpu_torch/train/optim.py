"""Optimizer and learning-rate schedule of the reference recipe.

Counterpart of ``rel_pose_tpu/train/optim.py:44-91``, which was written to
match exactly these PyTorch objects (the reference's ``train.py:69-73``):
Adam with L2 weight decay added to the gradient before the moments, and
OneCycleLR with cosine annealing, no momentum cycling, div_factor 25 and
final_div_factor 1e4.  Gradient clipping (global norm 2.5) happens in
``train.step.train_step``, before ``Adam.step``.
"""

import torch


def make_optimizer(model, lr=5e-4, steps=120000, warmup=10000,
                   weight_decay=1e-5):
    """-> ``(torch.optim.Adam, torch.optim.lr_scheduler.OneCycleLR)`` over
    every parameter of ``model``; the schedule's update k uses lr(k), so
    call ``sched.step()`` once after each ``opt.step()``."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=lr, total_steps=steps, pct_start=warmup / steps,
        anneal_strategy="cos", cycle_momentum=False, div_factor=25.0,
        final_div_factor=1e4)
    return opt, sched
