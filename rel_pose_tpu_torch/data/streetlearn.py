"""StreetLearn / StreetLearn-T pair dataset (a copy of
``rel_pose_tpu/data/streetlearn.py``).

Metadata semantics replicated from
``src/data_readers/streetlearn.py`` (near-identical to
InteriorNet): NPY metadata ``metadata/streetlearn/train_pair_rotation_overlap
.npy`` or ``metadata/streetlearnT/train_pair_translation_overlap.npy``;
images under ``data/streetlearn`` for the rotation set and
``data/streetlearn_2016`` for the 'T' set (:60-68); zero translation; fixed
intrinsics [128, 128, 128, 128].
"""

import os

from .interiornet import InteriorNet


class StreetLearn(InteriorNet):

    skip_bad_samples = True

    def __init__(self, mode="training", **kwargs):
        # InteriorNet.__init__ -> RGBDDataset.__init__ handles everything;
        # only the metadata/image paths differ.
        super(InteriorNet, self).__init__(name="StreetLearn", **kwargs)
        self.mode = mode

    def _metadata_path(self):
        if self.streetlearn_interiornet_type == "":
            return "metadata/streetlearn/train_pair_rotation_overlap.npy"
        return "metadata/streetlearnT/train_pair_translation_overlap.npy"

    def _image_root(self):
        name = ("streetlearn" if self.streetlearn_interiornet_type == ""
                else "streetlearn_2016")
        return os.path.join(self.root, "data", name)
