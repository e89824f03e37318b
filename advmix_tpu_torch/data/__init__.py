from .datasets import (COCODataset, ConcatDataset, MPIIDataset,
                       SyntheticPoseDataset, build_dataset,
                       build_stylized_dataset)
from .loader import CachedLoader, Loader

__all__ = ["COCODataset", "ConcatDataset", "MPIIDataset",
           "SyntheticPoseDataset", "build_dataset", "build_stylized_dataset",
           "CachedLoader", "Loader"]
