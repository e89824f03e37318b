from .datasets import COCODataset, SyntheticPoseDataset, build_dataset
from .loader import CachedLoader, Loader

__all__ = ["COCODataset", "SyntheticPoseDataset", "build_dataset",
           "CachedLoader", "Loader"]
