"""Dataset factory (a copy of ``rel_pose_tpu/data/factory.py``; the
reference's ``src/data_readers/factory.py``)."""

from .base import ConcatDataset
from .matterport import Matterport
from .interiornet import InteriorNet
from .streetlearn import StreetLearn

DATASET_MAP = {
    "matterport": Matterport,
    "streetlearn": StreetLearn,
    "interiornet": InteriorNet,
}


def dataset_factory(dataset_list, **kwargs):
    """Create a combined dataset from named readers."""
    db_list = []
    for key in dataset_list:
        db = DATASET_MAP[key](**kwargs)
        print(f"Dataset {key} has {len(db)} images")
        db_list.append(db)
    return ConcatDataset(db_list)
