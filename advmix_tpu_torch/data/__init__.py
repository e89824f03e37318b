from .datasets import COCODataset, SyntheticPoseDataset, build_dataset
from .loader import Loader

__all__ = ["COCODataset", "SyntheticPoseDataset", "build_dataset", "Loader"]
