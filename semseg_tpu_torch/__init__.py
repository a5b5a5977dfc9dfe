"""semseg_tpu_torch — the PyTorch/CUDA port of ``semseg_tpu`` for NVIDIA H100.

Module for module it mirrors the JAX package, which stays the reference:
``ops`` (with the hand-written CUDA kernels under ``ops/kernels`` and
``csrc``), ``models``, ``parallel`` (the train step, one card),
``checkpoint``, ``engine`` and ``cli``. The port imports neither ``jax``
nor anything of ``semseg_tpu``: it keeps its own copies of the
framework-neutral modules it needs (``config``, ``data``, ``utils``), under
the JAX package's names.

So far the port covers the JAX package's single-card inference (every
shipped config through ``cli.test`` and ``cli.eval``, its exact, batched
and device-pyramid engines) and single-card training (``cli.train``).
"""

__version__ = "0.1.0"
