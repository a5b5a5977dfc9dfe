from .builder import ModelBuilder
from .segmentation import SegmentationModel, set_process_group

__all__ = ["ModelBuilder", "SegmentationModel", "set_process_group"]
