"""semseg_tpu_torch — the PyTorch/CUDA port of ``semseg_tpu`` for NVIDIA H100.

Module for module it mirrors the JAX package, which stays the reference:
``ops`` (with the hand-written CUDA kernels under ``ops/kernels`` and
``csrc``), ``models``, ``checkpoint``, ``engine`` and ``cli``. The
framework-neutral parts (``semseg_tpu.config``, ``semseg_tpu.data``,
``semseg_tpu.utils``) are imported from the JAX package, not copied; none of
them imports JAX.

So far the port covers exact multi-scale inference of
resnet50dilated + ppm_deepsup (``cli.test``, ``cli.eval --exact``).
"""

__version__ = "0.1.0"
