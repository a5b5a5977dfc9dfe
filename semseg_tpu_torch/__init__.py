"""semseg_tpu_torch — the PyTorch/CUDA port of ``semseg_tpu`` for NVIDIA H100.

Module for module it mirrors the JAX package, which stays the reference:
``ops`` (with the hand-written CUDA kernels under ``ops/kernels`` and
``csrc``), ``models``, ``parallel`` (the train step, one card or one rank
per card), ``checkpoint``, ``engine``, ``serving``/``server`` and ``cli``.
The port imports neither ``jax`` nor anything of ``semseg_tpu``: it keeps
its own copies of the framework-neutral modules it needs (``config``,
``data``, ``utils``, and ``native``, the host library's C++ source and
bindings), under the JAX package's names.

The port covers the JAX package's inference (every shipped config through
``cli.test`` and ``cli.eval``, its exact, batched and device-pyramid
engines), training (``cli.train``, one card or several), serving
(``cli.serve``) and its native host preprocessing; not its height sharding
across chips (``TPU.spatial``).
"""

__version__ = "0.1.0"
