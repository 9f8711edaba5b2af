"""Geodesic SE(3) training loss.

Counterpart of ``rel_pose_tpu/geom/losses.py:18-53`` (the reference's
``src/geom/losses.py:3-21``): with index pairs ii = [0, 1], jj = [1, 0],
form both relative poses dP = P_jj P_ii^-1 of the ground truth and dG of
the prediction, take d = log(dG dP^-1), and average the norms of its
translation and rotation halves.
"""

import torch

from .lie import se3_compose, se3_inverse, se3_log


def _safe_norm(x):
    """L2 norm over the last axis with a zero gradient at x = 0 instead of
    NaN: the residual is exactly zero where prediction equals truth."""
    n2 = (x * x).sum(-1)
    zero = n2 < 1e-24
    return torch.where(zero, torch.zeros_like(n2),
                       torch.sqrt(torch.where(zero, torch.ones_like(n2), n2)))


def geodesic_loss(Ps, Gs, train_val="train"):
    """``Ps`` ground-truth and ``Gs`` predicted poses, ``(B, 2, 7)`` ->
    ``(loss_tr, loss_rot, metrics)``: scalar tensors, and a dict holding
    them under ``{train_val}_geo_loss_tr`` / ``_rot``."""
    ii, jj = [0, 1], [1, 0]
    dP = se3_compose(Ps[:, jj], se3_inverse(Ps[:, ii]))
    dG = se3_compose(Gs[:, jj], se3_inverse(Gs[:, ii]))
    d = se3_log(se3_compose(dG, se3_inverse(dP)))
    loss_tr = _safe_norm(d[..., :3]).mean()
    loss_rot = _safe_norm(d[..., 3:]).mean()
    metrics = {f"{train_val}_geo_loss_tr": loss_tr,
               f"{train_val}_geo_loss_rot": loss_rot}
    return loss_tr, loss_rot, metrics
