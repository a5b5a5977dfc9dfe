from .builder import ModelBuilder
from .segmentation import SegmentationModel

__all__ = ["ModelBuilder", "SegmentationModel"]
