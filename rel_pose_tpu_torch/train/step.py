"""The train and eval steps: forward, geodesic loss, backward, clip, Adam.

Counterpart of ``rel_pose_tpu/train/step.py:23-111`` (the body of the
reference's loop, its ``train.py:140-166``).  A
train step runs the model in training mode (BatchNorm on batch statistics,
running statistics updated), the loss w_tr L_tr + w_rot L_rot, the backward
through the two stages' hand kernels, ``clip_grad_norm_(clip)``, Adam and
the OneCycle step.  The metrics carry the JAX package's names and stay
tensors on the model's device; callers ``.item()`` them.

Data parallel (``parallel``): the model may be under
``DistributedDataParallel`` and the batch this rank's shard.  BatchNorm
then takes the global batch's statistics, DDP averages the gradients in the
backward (so the clip sees the averaged ones), and the metrics are the
means over the ranks: the global batch's, as ``make_train_step`` returns
them replicated (``rel_pose_tpu/train/step.py:78-88``).  That average of
each rank's mean loss is the global mean only over equal shards, which the
step checks.
"""

import torch

from .. import parallel
from ..geom.losses import geodesic_loss
from ..utils.precision import apply_matmul_precision


def loss_fn(model, images, poses_gt, intrinsics, w_tr=10.0, w_rot=10.0,
            train_val="train"):
    """-> ``(loss, metrics, poses_est)`` with pose 0 pinned to the
    identity, as the reference's ``Gs = SE3.IdentityLike``."""
    Gs = torch.zeros_like(poses_gt)
    Gs[..., 6] = 1.0
    poses_est = model(images, intrinsics, Gs=Gs)
    loss_tr, loss_rot, metrics = geodesic_loss(poses_gt, poses_est,
                                               train_val)
    return w_tr * loss_tr + w_rot * loss_rot, metrics, poses_est


def train_step(model, opt, sched, images, poses_gt, intrinsics, w_tr=10.0,
               w_rot=10.0, clip=2.5):
    """One optimizer step on a batch: ``images (B, 2, 3, H, W)``,
    ``poses_gt (B, 2, 7)`` fp32, ``intrinsics (B, 2, 4)`` on the model's
    device (under DDP, this rank's shard).  Returns ``(metrics,
    poses_est)``: ``train_geo_loss_tr``, ``train_geo_loss_rot`` and
    ``loss`` (means over the global batch), and this shard's detached
    predictions.  Applies the fp32 precision knob (``utils.precision``)
    first."""
    apply_matmul_precision()
    if parallel.world_size() > 1:
        parallel.check_equal_shards(images.shape[0])
    model.train()
    opt.zero_grad(set_to_none=True)
    loss, metrics, poses_est = loss_fn(model, images, poses_gt, intrinsics,
                                       w_tr, w_rot, "train")
    loss.backward()
    torch.nn.utils.clip_grad_norm_(model.parameters(), clip)
    opt.step()
    sched.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return parallel.all_reduce_mean(metrics), poses_est.detach()


@torch.no_grad()
def eval_step(model, images, poses_gt, intrinsics, w_tr=10.0, w_rot=10.0,
              train_val="val"):
    """Validation: forward and loss with BatchNorm in eval mode, nothing
    updated (the reference's ``model.eval()`` under ``torch.no_grad``).
    Data parallel, the metrics are the means over the ranks' shards."""
    model.eval()
    loss, metrics, poses_est = loss_fn(model, images, poses_gt, intrinsics,
                                       w_tr, w_rot, train_val)
    metrics = dict(metrics)
    metrics["loss"] = loss
    return parallel.all_reduce_mean(metrics), poses_est
