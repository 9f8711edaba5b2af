"""Matterport3D pair dataset (a copy of ``rel_pose_tpu/data/matterport.py``).

Metadata semantics replicated from
``src/data_readers/matterport.py``:
  * split files ``mp3d_planercnn_json/cached_set_{train,val,test}.json``
    (val is selected by subepoch == 10, ``base.py:33``);
  * image paths re-rooted by dropping the first 6 path components (:41);
  * translation divided by DEPTH_SCALE = 5.0 (:17,:48);
  * metadata quaternion arrives W-FIRST and is reordered to W-last by
    swapping elements 3 and 6 of the 7-vector (:50-51), then sign-normalized
    to qw >= 0 (:52-53);
  * fixed intrinsics [517.97, 517.97, 320, 240] for the 480x640 images (:56).
"""

import json
import os
import os.path as osp

import numpy as np

from .base import RGBDDataset

BASE_POSE = np.array([0, 0, 0, 0, 0, 0, 1], dtype=np.float64)
MATTERPORT_INTRINSICS = np.array([517.97, 517.97, 320, 240], dtype=np.float64)


class Matterport(RGBDDataset):

    DEPTH_SCALE = 5.0
    skip_bad_samples = False

    def __init__(self, mode="training", **kwargs):
        self.mode = mode
        super().__init__(name="Matterport", **kwargs)

    def _build_dataset(self, subepoch):
        valid = (subepoch == 10)
        path = "cached_set_val.json" if valid else "cached_set_train.json"
        with open(osp.join(self.root, "mp3d_planercnn_json", path)) as f:
            split = json.load(f)

        scene_info = {"images": [], "poses": [], "intrinsics": []}
        for entry in split["data"]:
            images = []
            for imgnum in ("0", "1"):
                img_name = os.path.join(
                    self.root,
                    "/".join(str(entry[imgnum]["file_name"]).split("/")[6:]))
                images.append(img_name)

            rel_pose = np.array(entry["rel_pose"]["position"]
                                + entry["rel_pose"]["rotation"], dtype=np.float64)
            rel_pose[:3] /= Matterport.DEPTH_SCALE
            # W-first -> W-last (swap indices 3 and 6)
            rel_pose[3], rel_pose[6] = rel_pose[6], rel_pose[3]
            if rel_pose[6] < 0:  # sign-normalize to qw >= 0
                rel_pose[3:] *= -1

            scene_info["images"].append(images)
            scene_info["poses"].append(np.vstack([BASE_POSE, rel_pose]))
            scene_info["intrinsics"].append(
                np.stack([MATTERPORT_INTRINSICS, MATTERPORT_INTRINSICS]))
        return scene_info
