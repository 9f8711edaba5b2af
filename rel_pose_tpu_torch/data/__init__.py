from .factory import dataset_factory
from .base import ConcatDataset
from .matterport import Matterport
from .interiornet import InteriorNet
from .streetlearn import StreetLearn
from .augmentation import RGBDAugmentor
from .loader import DataLoader

__all__ = [
    "dataset_factory", "ConcatDataset", "Matterport", "InteriorNet",
    "StreetLearn", "RGBDAugmentor", "DataLoader",
]
