"""Optimizer and learning-rate schedule of the reference recipe.

Counterpart of ``rel_pose_tpu/train/optim.py:44-91``, which was written to
match exactly these PyTorch objects (the reference's ``train.py:69-73``):
Adam with L2 weight decay added to the gradient before the moments, and
OneCycleLR with cosine annealing, no momentum cycling, div_factor 25 and
final_div_factor 1e4.  Gradient clipping (global norm 2.5) happens in
``train.step.train_step``, before ``Adam.step``.
"""

import torch


class OneCycleLR(torch.optim.lr_scheduler.OneCycleLR):
    """PyTorch's OneCycleLR, and where the step falls in a phase of no
    length, the lr that phase ends at, as the JAX package's
    ``onecycle_schedule`` gives it (``rel_pose_tpu/train/optim.py:45-77``):
    a warmup of 0 or 1 update starts at the peak lr, and ``warmup ==
    steps`` ends at the final lr.  PyTorch's own class divides by zero in
    both cases; everywhere else this is its ``get_lr``."""

    def get_lr(self):
        try:
            return super().get_lr()
        except ZeroDivisionError:
            phases = self._schedule_phases
            phase = next((p for p in phases
                          if self.last_epoch <= p["end_step"]), phases[-1])
            return [g[phase["end_lr"]] for g in self.optimizer.param_groups]


def make_scheduler(opt, lr=5e-4, steps=120000, warmup=10000, step=0):
    """The reference's OneCycleLR over ``opt``, after ``step`` updates: 0
    gives a fresh schedule; a later step needs the groups' ``initial_lr``,
    ``max_lr`` and ``min_lr``, which a fresh schedule of the same
    arguments leaves there."""
    return OneCycleLR(
        opt, max_lr=lr, total_steps=steps, pct_start=warmup / steps,
        anneal_strategy="cos", cycle_momentum=False, div_factor=25.0,
        final_div_factor=1e4, last_epoch=step - 1)


def make_optimizer(model, lr=5e-4, steps=120000, warmup=10000,
                   weight_decay=1e-5):
    """-> ``(torch.optim.Adam, OneCycleLR)`` over every parameter of
    ``model``; the schedule's update k uses lr(k), so call ``sched.step()``
    once after each ``opt.step()``."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=weight_decay)
    return opt, make_scheduler(opt, lr, steps, warmup)
