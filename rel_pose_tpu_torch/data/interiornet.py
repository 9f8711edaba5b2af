"""InteriorNet / InteriorNet-T pair dataset (a copy of
``rel_pose_tpu/data/interiornet.py``).

Metadata semantics replicated from
``src/data_readers/interiornet.py``:
  * NPY metadata ``metadata/interiornet/train_pair_rotation_overlap.npy``
    (rotation-only) or ``metadata/interiornetT/train_pair_translation_overlap
    .npy`` (type 'T') — a dict of {int: {'img1': {...}, 'img2': {...}}};
  * images under ``data/interiornet/<path>``;
  * GT rotation from per-image viewpoint angles (x = pitch, y = yaw) via
    R2 @ R1^T (:27-49), converted to an xyzw quaternion; translation is zero;
  * subepoch sharding: the keyspace is split into 10 contiguous tenths and
    the subepoch selects one (:70-81); ``use_mini_dataset`` instead takes
    keys [0, 32000) (:75-78);
  * fixed intrinsics [128, 128, 128, 128] for the 256x256 images (:100).
"""

import os
import os.path as osp

import numpy as np

from .base import RGBDDataset
from ..geom.quaternion import relative_rotation_from_viewpoints, matrix_to_quat

BASE_POSE = np.array([0, 0, 0, 0, 0, 0, 1], dtype=np.float64)
INTERIORNET_INTRINSICS = np.array([128, 128, 128, 128], dtype=np.float64)


def viewpoint_pair_quat(x1, y1, x2, y2):
    """xyzw quaternion of the relative rotation between two viewpoints.

    Equivalent to the reference's scipy ``R.from_matrix(...).as_quat()``
    (interiornet.py:90-94) via the numpy converters of ``geom.quaternion``.
    """
    m = np.asarray(relative_rotation_from_viewpoints(x1, y1, x2, y2))
    return np.asarray(matrix_to_quat(m))


class InteriorNet(RGBDDataset):

    skip_bad_samples = True

    def __init__(self, mode="training", **kwargs):
        self.mode = mode
        super().__init__(name="InteriorNet", **kwargs)

    def _metadata_path(self):
        if self.streetlearn_interiornet_type == "":
            return "metadata/interiornet/train_pair_rotation_overlap.npy"
        return "metadata/interiornetT/train_pair_translation_overlap.npy"

    def _image_root(self):
        return os.path.join(self.root, "data", "interiornet")

    def _build_dataset(self, subepoch):
        split = np.load(osp.join(self.root, self._metadata_path()),
                        allow_pickle=True)
        split = np.array(split, ndmin=1)[0]

        split_size = len(split.keys()) // 10
        start = split_size * subepoch
        end = split_size * (subepoch + 1)
        if self.use_mini_dataset:
            start, end = 0, 32000

        scene_info = {"images": [], "poses": [], "intrinsics": []}
        img_root = self._image_root()
        for i in split.keys():
            if i < start or i >= end:
                continue
            rec = split[i]
            images = [os.path.join(img_root, rec["img1"]["path"]),
                      os.path.join(img_root, rec["img2"]["path"])]
            rotation = viewpoint_pair_quat(
                rec["img1"]["x"], rec["img1"]["y"],
                rec["img2"]["x"], rec["img2"]["y"])
            rel_pose = np.concatenate([np.zeros(3), rotation])
            scene_info["images"].append(images)
            scene_info["poses"].append(np.vstack([BASE_POSE, rel_pose]))
            scene_info["intrinsics"].append(
                np.stack([INTERIORNET_INTRINSICS, INTERIORNET_INTRINSICS]))
        return scene_info
