"""semseg_tpu_torch — the PyTorch/CUDA port of ``semseg_tpu`` for NVIDIA H100.

Module for module it mirrors the JAX package, which stays the reference:
``ops`` (with the hand-written CUDA kernels under ``ops/kernels`` and
``csrc``), ``models``, ``checkpoint``, ``engine`` and ``cli``. The port
imports neither ``jax`` nor anything of ``semseg_tpu``: it keeps its own
copies of the framework-neutral modules it needs (``config``, ``data``,
``utils``), under the JAX package's names.

So far the port covers multi-scale inference of resnet50dilated +
ppm_deepsup: ``cli.test``, ``cli.eval --exact`` and the default batched
``cli.eval``.
"""

__version__ = "0.1.0"
