"""The per-image engine split by height (``cli.eval --spatial``) for HRNetV2
and the non-dilated ResNet + UPerNet on the CPU, whose band plans cut the
canvas at stride 32.

* ``hrnetv2`` + ``c1`` (full width: HRNetV2 has no narrow form) and
  ``resnet18`` + ``upernet`` (fc_dim 512, output stride 32) over ``["cpu"]
  * N`` bands, N in {2, 3, 4}, against the port's unsplit engine
  (``bucket_step=32``) over a pyramid whose 128-row level holds four
  stride-32 rows: atol 1e-5 on the averaged scores, in float32.
* Each pair split in 2 against JAX's ``InferenceEngine(exact=False,
  spatial_mesh=make_mesh(2))`` on conftest's 8 CPU devices over that level
  (one JAX program): within 1e-4 (measured: 1.1e-5 for UPerNet, whose
  zoo bar is 1e-3; HRNetV2's random-weight logits reach ~1e8, so its
  probabilities are one-hot and the argmax carries the check), argmax
  equal. The weights are the port's seeded ones carried onto JAX's
  variables (``test_torch_zoo.build_family``). Two torch threads, as
  ``test_torch_spatial_train_step.py`` has (HRNetV2's banded forward is
  many small operations, which eight threads a process slow under six
  test processes: 210 s against 8 s alone).
"""

import os

import numpy as np
import pytest
import torch

from semseg_tpu.engine import InferenceEngine as JaxInferenceEngine
from semseg_tpu.parallel.mesh import make_mesh

from semseg_tpu_torch.engine import InferenceEngine
from semseg_tpu_torch.models.segmentation import band_base

from test_torch_spatial_train_step import two_threads  # noqa: F401
from test_torch_zoo import build_family

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_SIZE = (47, 63)
FAMILIES = {"hrnetv2_c1": ("hrnetv2", "c1", 720), "resnet18_upernet": ("resnet18", "upernet", 512)}


def _pyramid():
    rng = np.random.RandomState(7)
    return [rng.randint(0, 256, (1, 100, 80, 3)).astype(np.uint8),
            rng.randint(0, 256, (1, 45, 61, 3)).astype(np.uint8)]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jax_model, variables, port, arch = build_family(*FAMILIES[request.param])
    return jax_model, variables, port, arch


def _port(model, n=None):
    return InferenceEngine(model, device="cpu", exact=False, bucket_step=32, output_stride=4,
                           spatial_devices=None if n is None else ["cpu"] * n)


def test_split_engine_matches_unsplit_engine(family):
    port = family[2]
    assert band_base(port) == 32
    ref = _port(port).scores_for_pyramid(_pyramid(), SEG_SIZE)
    for n in (2, 3, 4):
        engine = _port(port, n)
        assert engine.spatial_devices == [torch.device("cpu")] * n
        np.testing.assert_allclose(engine.scores_for_pyramid(_pyramid(), SEG_SIZE), ref,
                                   atol=1e-5, rtol=0, err_msg=f"{n} bands")


def test_split_engine_matches_jax_spatial_engine(family):
    jax_model, variables, port, _ = family
    level = _pyramid()[:1]
    ref = JaxInferenceEngine(jax_model, variables, exact=False, bucket_step=32, output_stride=4,
                             spatial_mesh=make_mesh(2), fetch_dtype=None,
                             bucket_denylist=()).scores_for_pyramid(level, SEG_SIZE)
    scores = _port(port, 2).scores_for_pyramid(level, SEG_SIZE)
    assert scores.shape == (*SEG_SIZE, 150) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(scores.argmax(-1), ref.argmax(-1))
