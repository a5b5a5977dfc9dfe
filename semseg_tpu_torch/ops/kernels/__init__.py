"""Hand-written CUDA kernels, each beside its plain PyTorch version."""

from .ppm_pool import pyramid_pool, pyramid_pool_backward_plain, pyramid_pool_plain

__all__ = ["pyramid_pool", "pyramid_pool_backward_plain", "pyramid_pool_plain"]
