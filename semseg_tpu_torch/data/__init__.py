from .dataset import (
    BaseDataset,
    PyramidBuilder,
    TestDataset,
    TrainDataset,
    ValDataset,
    parse_odgt,
)
from .loader import EvalLoader, TrainLoader
from .transforms import (
    img_transform,
    imresize,
    round2nearest_multiple,
    scale_for,
    segm_transform,
)

__all__ = [
    "BaseDataset",
    "PyramidBuilder",
    "TrainDataset",
    "ValDataset",
    "TestDataset",
    "parse_odgt",
    "EvalLoader",
    "TrainLoader",
    "img_transform",
    "imresize",
    "segm_transform",
    "round2nearest_multiple",
    "scale_for",
]
