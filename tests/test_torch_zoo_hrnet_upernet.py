"""The zoo against the JAX package on the CPU: hrnetv2 + C1, resnet50 +
UPerNet and + UPerNet-lite, with the checks and tolerances of
``test_torch_zoo.py`` (a file of its own so that the two run side by side).
"""

import pytest

from test_torch_zoo import (
    build_family,
    check_converter_matches_export,
    check_seg_size_forward,
    check_valid_hw_forward,
)

FAMILIES = [
    ("hrnetv2", "c1", 720),
    ("resnet50", "upernet", 2048),
    ("resnet50", "upernet_lite", 2048),
]


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda f: f"{f[0]}-{f[1]}")
def family(request):
    return build_family(*request.param)


def test_converter_matches_export(family):
    check_converter_matches_export(family)


def test_seg_size_forward_matches_jax(family):
    check_seg_size_forward(family)


def test_valid_hw_forward_matches_jax(family):
    check_valid_hw_forward(family)
