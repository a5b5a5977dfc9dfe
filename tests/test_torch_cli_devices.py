"""The CLIs' device rules on the CPU, against the JAX package's.

* ``cli.train`` trains on as many ranks as the JAX CLI's
  ``build_train_mesh`` takes devices (``semseg_tpu/cli/train.py:41-69``):
  ``TPU.data_parallel``, else ``--devices``/``--gpus``, else every visible
  device, sliced to what is visible. Here JAX sees conftest's 8 CPU devices
  and the port 8 cards (``torch.cuda.device_count`` patched), and each case
  must give both the same count; with ``--device cpu`` and no number the
  port trains in one process.
* ``TPU.spatial`` > 1 is read where the JAX package reads it: ``cli.train
  --device cpu ... TPU.spatial 2`` trains with each image's height split in
  two CPU bands and writes its checkpoint; ``cli.eval`` and
  ``ModelBuilder`` ignore it, as JAX's do; ``cli.eval --spatial 2 --device
  cpu`` runs one engine over two CPU bands. ``cli.train``'s (data groups,
  spatial) selection is JAX's ``build_train_mesh(c, devices).shape`` for
  the cases of ``tests/test_cli.py:128-155`` ("must divide" included), on
  conftest's 8 CPU devices against 8 cards; ``--multihost`` with
  ``TPU.spatial`` raises, ``TPU.remat`` with it is taken (its model's
  ``spatial`` forward checkpoints the ResNet blocks).
* ``cli.eval --profile DIR`` writes a Chrome trace of the eval loop, with
  the engine's and the layers' spans, when the loop ends and when it
  raises.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from semseg_tpu.cli.train import build_train_mesh
from semseg_tpu.config import cfg as jax_cfg

from semseg_tpu_torch.cli import eval as eval_cli
from semseg_tpu_torch.cli import train as train_cli
from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.parallel import distributed
from test_torch_dist_cli import CFG18
from test_torch_train_cli import train_set  # noqa: F401  (the fixture)


def _ranks(monkeypatch, argv, cards):
    """How many processes ``cli.train.main(argv)`` trains in, with
    ``cards`` cards visible: spawned ranks, or 1 for a run in-process."""
    seen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.multiprocessing, "spawn",
                        lambda fn, args, nprocs: seen.append(nprocs))
    monkeypatch.setattr(train_cli, "run", lambda args, rendezvous=None: seen.append(1))
    train_cli.main(["--cfg", CFG18, *argv])
    (n,) = seen
    return n


# (--devices, TPU.data_parallel): the all-devices default, an explicit
# count, more than are visible, data_parallel alone and over --devices.
CASES = [(0, 0), (3, 0), (16, 0), (0, 2), (3, 2)]


@pytest.mark.parametrize("devices,data_parallel", CASES)
def test_train_ranks_follow_jax_build_train_mesh(devices, data_parallel, monkeypatch):
    jc = jax_cfg.clone()
    jc.merge_from_file(CFG18)
    jc.TPU.data_parallel = data_parallel
    visible = len(jax.devices())
    want = build_train_mesh(jc, devices).size
    argv = ["--devices", str(devices), "TPU.data_parallel", str(data_parallel)]
    assert _ranks(monkeypatch, argv, visible) == want
    # On the CPU a count is taken as asked; none asked is one process.
    assert _ranks(monkeypatch, ["--device", "cpu", *argv], 0) == (data_parallel or devices or 1)


def test_gpus_list_sizes_the_ranks(monkeypatch):
    assert _ranks(monkeypatch, ["--gpus", "0-2"], 8) == 3


@pytest.mark.parametrize("where", ["train", "eval", "eval --spatial", "builder"])
def test_spatial_raises(where, tmp_path, train_set, monkeypatch):  # noqa: F811
    """``cli.train`` trains split on ``TPU.spatial`` 2 (JAX's trainer is the
    one reader); the rest ignore it, as the JAX package's do."""
    root, odgt = train_set
    if where == "train":
        state, history = train_cli.main([
            "--cfg", CFG18, "--device", "cpu", "DIR", str(tmp_path), "TPU.spatial", "2",
            "DATASET.root_dataset", root, "DATASET.list_train", odgt,
            "DATASET.imgSizes", "(40,)", "DATASET.imgMaxSize", "64", "TRAIN.num_epoch", "1",
            "TRAIN.epoch_iters", "2", "TRAIN.disp_iter", "1", "TRAIN.workers", "1",
            "MODEL.pretrained_encoder", "False"])
        assert state.step == 2 and state.spatial == [torch.device("cpu")] * 2
        assert all(np.isfinite(history["train"]["loss"]))
        for f in ("encoder_epoch_1.pth", "decoder_epoch_1.pth", "state_epoch_1.pt"):
            assert (tmp_path / f).exists(), f
        return
    c = cfg.clone()
    c.merge_from_file(CFG18)
    c.TPU.spatial = 2
    model = ModelBuilder.build_model(c, device="cpu")
    if where == "builder":
        assert not model.training and next(model.parameters()).device.type == "cpu"
        return
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for part in ("encoder", "decoder"):
        torch.save(getattr(model, part).state_dict(), ckpt / f"{part}_epoch_20.pth")
    built = []
    real = eval_cli.build_engines
    monkeypatch.setattr(eval_cli, "build_engines",
                        lambda *a, **k: built.extend(real(*a, **k)) or built)
    flags = ["--spatial", "2"] if where == "eval --spatial" else ["--batch", "1"]
    miou, _, _, raw = eval_cli.main([
        "--cfg", CFG18, "--device", "cpu", *flags, "DIR", str(ckpt), "TPU.spatial", "2",
        "DATASET.root_dataset", root, "DATASET.list_val", odgt,
        "DATASET.imgSizes", "(40,)", "DATASET.imgMaxSize", "64"])
    (engine,) = built
    assert raw["pix_count"] > 0 and 0.0 <= miou <= 1.0
    want = [torch.device("cpu")] * 2 if where == "eval --spatial" else None
    assert engine.spatial_devices == want


# (TPU.data_parallel, --devices, TPU.spatial): tests/test_cli.py:128-155's
# cases, "must divide" (spatial 3 of 8 devices) last.
MESH_CASES = [(4, 0, 1), (4, 0, 2), (0, 2, 2), (0, 0, 2), (0, 0, 3)]


@pytest.mark.parametrize("data_parallel,devices,spatial", MESH_CASES)
def test_train_mesh_follows_jax_build_train_mesh(data_parallel, devices, spatial,
                                                 monkeypatch):
    jc = jax_cfg.clone()
    jc.merge_from_file(CFG18)
    jc.TPU.data_parallel, jc.TPU.spatial = data_parallel, spatial
    visible = len(jax.devices())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    if spatial == 3:
        with pytest.raises(ValueError, match="must divide"):
            build_train_mesh(jc, devices)
        with pytest.raises(ValueError, match="must divide"):
            train_cli.train_mesh("cuda", devices, data_parallel, spatial)
        return
    want = dict(build_train_mesh(jc, devices).shape)
    got = train_cli.train_mesh("cuda", devices, data_parallel, spatial)
    assert got == (want["data"], want.get("spatial", 1))
    # main() starts one rank per data group, each driving its cards.
    argv = ["--devices", str(devices), "TPU.data_parallel", str(data_parallel),
            "TPU.spatial", str(spatial)]
    assert _ranks(monkeypatch, argv, visible) == want["data"]
    if spatial > 1:
        assert distributed.group_devices("cuda", 1, spatial) == [
            torch.device("cuda", spatial + j) for j in range(spatial)]


def test_spatial_refuses_multihost_and_takes_remat(monkeypatch):
    with pytest.raises(NotImplementedError, match="single-host"):
        train_cli.main(["--cfg", CFG18, "--multihost", "TPU.spatial", "2"])
    args = train_cli.parse_args(["--cfg", CFG18, "--device", "cpu", "TPU.spatial", "2",
                                 "TPU.remat", "True"])
    c = train_cli.load_cfg(args)
    assert (c.TPU.spatial, c.TPU.remat) == (2, True)
    train_cli.check_spatial(c, multihost=False)
    # The built model's spatial forward checkpoints each of resnet18's 8
    # blocks.
    import torch.utils.checkpoint as ckpt

    from semseg_tpu_torch.models import resnet

    calls = []
    monkeypatch.setattr(resnet, "checkpoint", lambda *a, **k: calls.append(1) or
                        ckpt.checkpoint(*a, **k))
    model = ModelBuilder.build_model(c, device="cpu", seed=0).train()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32))
    label = torch.from_numpy(rng.randint(-1, 150, (2, 8, 8))).long()
    loss, _ = model(img, seg_label=label, spatial=["cpu", "cpu"])
    assert torch.isfinite(loss) and len(calls) == 8


def test_eval_profile_writes_a_trace_on_either_exit(train_set, tmp_path, monkeypatch):  # noqa: F811
    """The trace is written when the loop ends and when it raises (the
    engines' kernels land in it on the card, ``chip_smoke.py`` phase 11);
    one engine runs on the profiled thread, so the trace holds the
    engine's and the layers' spans."""
    root, odgt = train_set
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    c = cfg.clone()
    c.merge_from_file(CFG18)
    model = ModelBuilder.build_model(c, device="cpu", seed=0)
    for part in ("encoder", "decoder"):
        torch.save(getattr(model, part).state_dict(), os.path.join(ckpt, f"{part}_epoch_20.pth"))
    argv = ["--cfg", CFG18, "--device", "cpu", "DIR", ckpt, "DATASET.root_dataset", root,
            "DATASET.list_val", odgt, "DATASET.imgSizes", "(40,)", "DATASET.imgMaxSize", "64"]
    miou, _, _, raw = eval_cli.main(["--profile", str(tmp_path / "ok"), *argv])
    assert raw["pix_count"] > 0
    with open(tmp_path / "ok" / "eval_trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert isinstance(events, list)
    assert {"semseg::eval.plan", "semseg::eval.model", "semseg::eval.epilogue",
            "semseg::eval.fetch", "semseg::bn", "semseg::conv"} <= {e.get("name") for e in events}

    def fail(*args, **kwargs):
        raise RuntimeError("an engine failed")

    monkeypatch.setattr(eval_cli, "evaluate", fail)
    with pytest.raises(RuntimeError, match="an engine failed"):
        eval_cli.main(["--profile", str(tmp_path / "raised"), *argv])
    with open(tmp_path / "raised" / "eval_trace.json") as f:
        assert isinstance(json.load(f)["traceEvents"], list)
