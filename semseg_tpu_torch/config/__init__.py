from .cfgnode import CfgNode
from .defaults import cfg

__all__ = ["CfgNode", "cfg"]
