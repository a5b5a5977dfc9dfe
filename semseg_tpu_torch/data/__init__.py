from .dataset import BaseDataset, PyramidBuilder, TestDataset, ValDataset, parse_odgt
from .loader import EvalLoader
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
    "ValDataset",
    "TestDataset",
    "parse_odgt",
    "EvalLoader",
    "img_transform",
    "imresize",
    "segm_transform",
    "round2nearest_multiple",
    "scale_for",
]
