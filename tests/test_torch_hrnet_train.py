"""HRNetV2 + C1's unsplit training forward against JAX's in float64: the
check of ``test_torch_spatial_zoo_train.py`` for HRNetV2, in a file of its
own so that the two run side by side (JAX's eager gradient of HRNetV2 takes
~50 s on an idle CPU). It found the port's HRNetV2 batch norms at momentum
0.001 where JAX's are at 0.1.
"""

from test_torch_spatial_train_step import two_threads  # noqa: F401
from test_torch_spatial_zoo_train import check_training_forward_matches_jax, x64  # noqa: F401


def test_unsplit_training_forward_matches_jax(x64):  # noqa: F811
    check_training_forward_matches_jax("hrnetv2_c1")
