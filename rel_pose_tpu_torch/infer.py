"""Load-once / predict-many inference on one device: the serving layer.

Counterpart of ``rel_pose_tpu/infer.py:42-241`` without sharding:

  * a fixed ``batch_size``: requests are chunked to it and a ragged tail is
    padded by repeating its last pair, so the model always sees one shape;
  * an optional ``image_size`` nearest pre-resize (the eval CLIs' 384x512
    Matterport convention); the intrinsics are then scaled from the resized
    resolution, as in the JAX package;
  * uint8 images end to end;
  * the dataset output conventions as numpy helpers.

Example::

    from rel_pose_tpu_torch.infer import PosePredictor, MATTERPORT_INTRINSICS
    pred = PosePredictor.from_checkpoint(
        "model.pth", device="cuda", intrinsics=MATTERPORT_INTRINSICS,
        image_size=(384, 512), batch_size=256)
    poses = pred.predict_batch(images)        # (B, 2, 3, H, W) -> (B, 2, 7)

A --noess checkpoint: ``PosePredictor.from_checkpoint("noess.pth",
ModelConfig(noess=True), ...)``.  A ``.ckpt`` written by the JAX package
loads the same way.  ``pred.warmup()`` before the first request builds the
kernels and plans the convolutions.
"""

import numpy as np
import torch

from .config import ModelConfig
from .models.vitess import ViTEss
from .ops.image import nearest_resize
from .train.checkpoint import load_ckpt_state_dict
from .utils.convert import load_pth, load_reference_state_dict
from .utils.precision import apply_matmul_precision

# Camera intrinsics (fx, fy, cx, cy) of the reference CLIs: Matterport, and
# the InteriorNet / StreetLearn 256x256 crops.
MATTERPORT_INTRINSICS = np.array([517.97, 517.97, 320.0, 240.0], np.float32)
INTERIORNET_STREETLEARN_INTRINSICS = np.array(
    [128.0, 128.0, 128.0, 128.0], np.float32)

# Matterport metadata stores translations divided by 5 (reference base.py:21)
DEPTH_SCALE = 5.0


def matterport_eval_pose(pose):
    """Model output -> the eval CLI's Matterport convention: quaternion
    W-last -> W-first (swap elements 3 and 6), translation * DEPTH_SCALE."""
    pose = np.asarray(pose)
    out = pose.copy()
    out[..., 3] = pose[..., 6]
    out[..., 6] = pose[..., 3]
    out[..., :3] = pose[..., :3] * DEPTH_SCALE
    return out


def matterport_demo_pose(pose):
    """Model output -> the demo CLI's Matterport convention: translation *
    DEPTH_SCALE and the ``[4, 5, 3, 6]`` quaternion reorder."""
    pose = np.asarray(pose)
    out = pose.copy()
    out[..., :3] = pose[..., :3] * DEPTH_SCALE
    out[..., 3:] = np.stack(
        [pose[..., 4], pose[..., 5], pose[..., 3], pose[..., 6]], axis=-1)
    return out


def load_checkpoint_state_dict(path, cfg):
    """The port's state dict from a reference or port ``.pth`` (a
    ``{"model", ...}`` dict or a bare state dict) or, for any other name, a
    msgpack ``.ckpt`` of the JAX package (``load_checkpoint_params``,
    ``rel_pose_tpu/infer.py:75``)."""
    if str(path).endswith(".pth"):
        ckpt = load_pth(path)
        return load_reference_state_dict(
            ckpt["model"] if "model" in ckpt else ckpt)
    return load_ckpt_state_dict(path, cfg)


class PosePredictor:
    """Batched relative-pose inference with a loaded ``ViTEss``.

    Parameters
    ----------
    model : a ``ViTEss`` with its weights loaded; it runs on its own device.
    intrinsics : default camera intrinsics, ``(4,)``, ``(2, 4)`` or
        ``(B, 2, 4)``; overridable per call, and required one way or the
        other.
    batch_size : fixed model batch; ``None`` runs each request as it comes.
    image_size : optional (H, W) nearest pre-resize.

    Construction applies the fp32 precision knob
    (``utils.precision.apply_matmul_precision``).
    """

    def __init__(self, model, *, intrinsics=None, batch_size=None,
                 image_size=None):
        apply_matmul_precision()
        self.model = model.eval()
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.image_size = tuple(image_size) if image_size else None
        self._default_intr = (None if intrinsics is None
                              else np.asarray(intrinsics, np.float32))

    @classmethod
    def from_checkpoint(cls, path, cfg=None, *, device="cuda", **kwargs):
        """Build from a ``.pth`` or ``.ckpt`` checkpoint
        (:func:`load_checkpoint_state_dict`) of the model ``cfg``
        describes: the flagship by default, ``ModelConfig(noess=True)`` for
        a --noess checkpoint."""
        cfg = cfg if cfg is not None else ModelConfig()
        sd = load_checkpoint_state_dict(path, cfg)
        model = ViTEss(cfg, device=device)
        model.load_state_dict(sd)
        return cls(model, **kwargs)

    def _as_images(self, images):
        """(B, 2, 3, H, W) / (2, 3, H, W) arrays or a list of HWC-BGR pairs
        -> (B, 2, 3, H, W) uint8 (integer input) or float32."""
        if isinstance(images, (list, tuple)):
            images = np.stack(
                [np.stack([np.transpose(np.asarray(im), (2, 0, 1))
                           for im in pair]) for pair in images])
        images = np.asarray(images)
        if images.ndim == 4:
            images = images[None]
        if images.ndim != 5 or images.shape[1] != 2 or images.shape[2] != 3:
            raise ValueError(
                f"expected images (B, 2, 3, H, W), got {images.shape}")
        dtype = (np.uint8 if np.issubdtype(images.dtype, np.integer)
                 else np.float32)
        return np.ascontiguousarray(images.astype(dtype, copy=False))

    def _intr_for(self, batch, intrinsics):
        intr = (self._default_intr if intrinsics is None
                else np.asarray(intrinsics, np.float32))
        if intr is None:
            raise ValueError(
                "no intrinsics: pass intrinsics= here or at construction "
                "(e.g. MATTERPORT_INTRINSICS or "
                "INTERIORNET_STREETLEARN_INTRINSICS)")
        if intr.ndim == 1:
            intr = np.tile(intr[None], (2, 1))
        if intr.ndim == 2:
            intr = np.tile(intr[None], (batch, 1, 1))
        if intr.shape != (batch, 2, 4):
            raise ValueError(f"intrinsics shape {intr.shape} does not "
                             f"broadcast to ({batch}, 2, 4)")
        return intr

    def _run(self, images, intr):
        x = torch.from_numpy(images).to(self.device)
        k = torch.from_numpy(intr).to(self.device)
        if self.image_size is not None:
            x = nearest_resize(x, self.image_size)
        with torch.inference_mode():
            return self.model(x, k).cpu().numpy()

    def predict_batch(self, images, intrinsics=None):
        """(B, 2, 3, H, W) images (or a list of HWC pairs) -> (B, 2, 7)
        poses (tx ty tz qx qy qz qw, pose 0 the identity)."""
        images = self._as_images(images)
        B = images.shape[0]
        if B == 0:
            return np.zeros((0, 2, 7), np.float32)
        intr = self._intr_for(B, intrinsics)
        K = self.batch_size
        if K is None:
            return self._run(images, intr)
        out = []
        for s in range(0, B, K):
            img_c, intr_c = images[s:s + K], intr[s:s + K]
            n = img_c.shape[0]
            if n < K:   # pad the ragged tail: one model shape, ever
                img_c = np.concatenate(
                    [img_c, np.repeat(img_c[-1:], K - n, 0)])
                intr_c = np.concatenate(
                    [intr_c, np.repeat(intr_c[-1:], K - n, 0)])
            out.append(self._run(img_c, intr_c)[:n])
        return np.concatenate(out)

    __call__ = predict_batch

    def predict(self, img1, img2, intrinsics=None):
        """One HWC-BGR image pair -> (2, 7) pose."""
        return self.predict_batch([(img1, img2)], intrinsics)[0]

    def warmup(self, height=None, width=None, dtype=np.uint8):
        """Run one dummy batch of ``batch_size`` pairs so that the first
        real request does not pay the one-time costs: the kernels' nvcc
        build, cuDNN's plans and the allocator's first blocks.  Returns
        ``self`` once the card has finished.

        With ``image_size`` set the dummy defaults to it; without it the
        model sees the native request resolution, so ``height`` and
        ``width`` are required and should be the resolution requests will
        come at.  ``dtype`` is the requests' (uint8 images, or float32
        ones, run as they come).  Stored per-pair intrinsics that do not
        tile to the batch are replaced by a dummy (``rel_pose_tpu/
        infer.py:226-261``)."""
        if height is None or width is None:
            if self.image_size is None:
                raise ValueError(
                    "warmup(height, width): pass the expected native "
                    "request resolution -- image_size is not set, so the "
                    "model runs at the raw input shape (e.g. "
                    "warmup(256, 256) for InteriorNet/StreetLearn-style "
                    "traffic)")
            height, width = self.image_size
        B = self.batch_size or 1
        dummy = np.zeros((B, 2, 3, height, width), dtype)
        intr = self._default_intr
        if intr is None or (intr.ndim == 3 and intr.shape[0] != B):
            intr = np.ones(4, np.float32)
        self._run(dummy, self._intr_for(B, intr))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
