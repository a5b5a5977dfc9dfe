"""The per-image engine with each level's height split across devices
(``InferenceEngine(spatial_devices=...)``, ``cli.eval --spatial``) on the
CPU, against the JAX package's spatial engine.

* The port's bucketed engine over ``["cpu"] * N`` bands, N in {2, 4},
  against JAX's ``InferenceEngine(exact=False, spatial_mesh=make_mesh(N))``
  on conftest's 8 CPU devices, over the off-lattice pyramid of
  ``test_torch_engine.py`` (levels padded to their step-8 buckets, whose
  heights 48, 64 and 40 JAX's mesh divides): atol 1e-4 on the averaged
  scores, argmax equal. For the narrow bottleneck ResNet + PPMDeepsup pair
  and for ``mobilenetv2dilated`` + ``c1_deepsup``.
* Against the port's own unsplit engine: atol 1e-5, also for the splits
  JAX's mesh would refuse (3 bands) and for more bands than stride-8 rows
  (8 bands over a 5-row level: the last ones empty).
* ``exact=True`` with bands runs unsplit on the first device, as JAX's
  exact path does: equal to the unsplit exact engine.
* ``cli.eval --device cpu --spatial 2`` over a tiny val set against
  ``--batch 1``: mIoU within 1e-4 (PARITY.md's bucketed bar); the warning
  for an explicit ``--batch 4``; HRNetV2 and UPerNet refused, naming
  ROADMAP item 17.
"""

import logging
import os

import numpy as np
import pytest
import torch

from semseg_tpu.engine import InferenceEngine as JaxInferenceEngine
from semseg_tpu.parallel.mesh import make_mesh

from semseg_tpu_torch.cli import eval as eval_cli
from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.engine import InferenceEngine
from semseg_tpu_torch.models import ModelBuilder

from test_torch_model import narrow_jax_model, narrow_port_model
from test_torch_train_cli import train_set  # noqa: F401  (the fixture)
from test_torch_zoo import build_family

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_SIZE = (47, 63)


def _pyramid():
    rng = np.random.RandomState(7)
    return [rng.randint(0, 256, (1, 45, 61, 3)).astype(np.uint8),
            rng.randint(0, 256, (1, 64, 80, 3)).astype(np.uint8),
            rng.randint(0, 256, (1, 37, 50, 3)).astype(np.uint8)]


@pytest.fixture(scope="module")
def narrow():
    jax_model, variables = narrow_jax_model(jit=True)
    return jax_model, variables, narrow_port_model(variables)


@pytest.fixture(scope="module")
def mobilenet():
    jax_model, variables, port, _ = build_family("mobilenetv2dilated", "c1_deepsup", 320,
                                                 jit=True)
    return jax_model, variables, port


def _jax_spatial_scores(jax_model, variables, n):
    engine = JaxInferenceEngine(jax_model, variables, exact=False, bucket_step=8,
                                spatial_mesh=make_mesh(n), fetch_dtype=None,
                                bucket_denylist=())
    return engine.scores_for_pyramid(_pyramid(), SEG_SIZE)


def _port(model, n=None, exact=False):
    return InferenceEngine(model, device="cpu", exact=exact, bucket_step=8,
                           spatial_devices=None if n is None else ["cpu"] * n)


@pytest.mark.parametrize("family,n", [("narrow", 2), ("narrow", 4), ("mobilenet", 4)])
def test_spatial_engine_matches_jax_spatial_engine(family, n, request):
    jax_model, variables, port = request.getfixturevalue(family)
    ref = _jax_spatial_scores(jax_model, variables, n)
    scores = _port(port, n).scores_for_pyramid(_pyramid(), SEG_SIZE)
    assert scores.shape == (*SEG_SIZE, 150) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(scores.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_spatial_engine_matches_unsplit_engine(narrow, n):
    port = narrow[2]
    ref = _port(port).scores_for_pyramid(_pyramid(), SEG_SIZE)
    engine = _port(port, n)
    assert engine.spatial_devices == [torch.device("cpu")] * n
    np.testing.assert_allclose(engine.scores_for_pyramid(_pyramid(), SEG_SIZE), ref,
                               atol=1e-5, rtol=0)


def test_exact_with_bands_is_the_exact_engine(narrow):
    port = narrow[2]
    pyramid = [np.random.RandomState(3).randn(1, 40, 56, 3).astype(np.float32)]
    ref = _port(port, exact=True).scores_for_pyramid(pyramid, SEG_SIZE)
    out = _port(port, 2, exact=True).scores_for_pyramid(pyramid, SEG_SIZE)
    np.testing.assert_array_equal(out, ref)


def test_band_device_must_exist(narrow):
    if torch.cuda.device_count():
        pytest.skip("a card is visible")
    with pytest.raises(ValueError, match="0 CUDA card"):
        InferenceEngine(narrow[2], exact=False, spatial_devices=["cuda:0", "cuda:0"])


CFG18 = os.path.join(REPO, "config", "ade20k-resnet18dilated-ppm_deepsup.yaml")
TINY = ["DATASET.imgSizes", "(40, 56)", "DATASET.imgMaxSize", "72"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A seeded resnet18dilated + ppm_deepsup saved as a .pth pair."""
    out = tmp_path_factory.mktemp("ckpt")
    c = cfg.clone()
    c.merge_from_file(CFG18)
    model = ModelBuilder.build_model(c, device="cpu", seed=3)
    for part in ("encoder", "decoder"):
        torch.save(getattr(model, part).state_dict(), out / f"{part}_epoch_20.pth")
    return str(out)


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_eval_cli_spatial_matches_batch_1(train_set, ckpt, monkeypatch):  # noqa: F811
    root, odgt = train_set
    argv = ["--cfg", CFG18, "--device", "cpu", "--fetch-dtype", "float32", "DIR", ckpt,
            "DATASET.root_dataset", root, "DATASET.list_val", odgt, *TINY]
    built = []
    real = eval_cli.build_engines

    def spy(*args, **kwargs):
        built.extend(real(*args, **kwargs))
        return built

    monkeypatch.setattr(eval_cli, "build_engines", spy)
    warnings = _Warnings()
    logger = logging.getLogger("Logger")  # the CLIs' logger (utils.setup_logger)
    logger.addHandler(warnings)
    try:
        miou, acc, _, raw = eval_cli.main(["--spatial", "2", "--batch", "4", *argv])
    finally:
        logger.removeHandler(warnings)
    (engine,) = built
    assert engine.spatial_devices == [torch.device("cpu")] * 2 and not engine.exact
    assert any("single-image latency mode" in m for m in warnings.messages), warnings.messages
    ref_miou, ref_acc, _, ref_raw = eval_cli.main(["--batch", "1", *argv])
    assert raw["pix_count"] == ref_raw["pix_count"] > 0
    assert abs(miou - ref_miou) <= 1e-4 and abs(acc - ref_acc) <= 1e-4


@pytest.mark.parametrize("config", ["ade20k-hrnetv2.yaml", "ade20k-resnet50-upernet.yaml"])
def test_spatial_engine_refuses_hrnet_and_upernet(config):
    """``cli.eval --spatial``'s engine is refused at its construction,
    before any data is read."""
    c = cfg.clone()
    c.merge_from_file(os.path.join(REPO, "config", config))
    with pytest.raises(NotImplementedError, match="ROADMAP item 17c"):
        eval_cli.build_engines(c, device="cpu", spatial=2)
