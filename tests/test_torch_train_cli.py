"""The port's training data path and train CLI on the CPU.

* ``TrainDataset`` against the JAX package's with ``SEMSEG_NO_NATIVE=1``
  (PIL on both sides), from the same seed over several batches of mixed
  orientations: images (float32 and raw uint8), labels and ``img_valid_hw``
  equal; ``process_seed``; a worker error surfacing from ``TrainLoader``;
  ``device_prefetch`` on the CPU.
* ``cli.train --device cpu`` on the flagship config at tiny ``imgSizes``
  over a written odgt of PNGs: epoch 1 writes the ``.pth`` pair, the full
  state and the history; resuming at epoch 1 gives the uninterrupted
  run's epoch 2 bit for bit (same generator seeds, one worker);
  ``cli.eval`` reads the pair (``VAL.checkpoint epoch_2.pth``); a
  non-finite loss raises; ``--profile`` writes a trace of the first steps;
  ``MODEL.pretrained_encoder`` reads only the local cache; more than one
  card raises.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from semseg_tpu.config import cfg as jax_cfg
from semseg_tpu.data.dataset import TrainDataset as JaxTrainDataset
from semseg_tpu.parallel.distributed import process_seed as jax_process_seed

from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.data import TrainDataset, TrainLoader
from semseg_tpu_torch.parallel import device_prefetch, process_seed

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config",
                   "ade20k-resnet50dilated-ppm_deepsup.yaml")
SHAPES = [(48, 64), (64, 48), (40, 56), (56, 40), (48, 48), (60, 44), (37, 61), (50, 33)]


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    rng = np.random.RandomState(0)
    records = []
    for i, (h, w) in enumerate(SHAPES):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(root / f"img{i}.png")
        Image.fromarray(rng.randint(0, 151, (h, w)).astype(np.uint8), mode="L").save(
            root / f"seg{i}.png")
        records.append({"fpath_img": f"img{i}.png", "fpath_segm": f"seg{i}.png",
                        "height": h, "width": w})
    odgt = root / "train.odgt"
    odgt.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(root), str(odgt)


def _opts(c, root, odgt):
    c.merge_from_file(CFG)
    c.merge_from_list(["DATASET.root_dataset", root, "DATASET.list_train", odgt,
                       "DATASET.imgSizes", "(40, 48, 56)", "DATASET.imgMaxSize", "80"])
    return c


@pytest.mark.parametrize("raw", [False, True], ids=["float32", "uint8"])
def test_train_dataset_matches_jax(train_set, raw, monkeypatch):
    monkeypatch.setenv("SEMSEG_NO_NATIVE", "1")
    root, odgt = train_set
    jc, tc = _opts(jax_cfg.clone(), root, odgt), _opts(cfg.clone(), root, odgt)
    kw = dict(batch_per_gpu=2, seed=process_seed(304, 1), bucket_step=64, raw_transport=raw)
    jds = JaxTrainDataset(root, odgt, jc.DATASET, **kw)
    tds = TrainDataset(root, odgt, tc.DATASET, **kw)
    for _ in range(6):
        jb, tb = jds.next_batch(), tds.next_batch()
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tb["img_data"].shape[1] % 64 == 0 and tb["img_data"].shape[2] % 64 == 0
        assert tb["img_data"].dtype == (np.uint8 if raw else np.float32)


def test_process_seed_matches_jax():
    for base, worker in ((304, 0), (304, 3), (1, 15)):
        assert process_seed(base, worker) == jax_process_seed(base, worker)


def test_fast_decode_is_not_ported(train_set):
    root, odgt = train_set
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        TrainDataset(root, odgt, _opts(cfg.clone(), root, odgt).DATASET, fast_decode=True)


def test_train_loader_raises_a_worker_error(train_set):
    root, odgt = train_set

    def make(worker):
        if worker == 1:
            raise OSError("corrupt shard")
        return TrainDataset(root, odgt, _opts(cfg.clone(), root, odgt).DATASET, batch_per_gpu=2)

    loader = TrainLoader(make, num_workers=2, prefetch=2)
    with pytest.raises(RuntimeError, match="worker failed") as err:
        for _ in range(50):
            next(iter(loader))
    assert isinstance(err.value.__cause__, OSError)
    loader.close()


def test_device_prefetch_on_cpu_yields_the_batches():
    rng = np.random.RandomState(4)
    batches = [{"img_data": rng.randint(0, 256, (2, 16, 24, 3)).astype(np.uint8),
                "seg_label": rng.randint(-1, 150, (2, 2, 3)).astype(np.int32),
                "img_valid_hw": np.array([[16, 24], [9, 13]], np.int32)} for _ in range(5)]
    got = list(device_prefetch(iter(batches), "cpu", depth=2))
    assert len(got) == 5
    for b, g in zip(batches, got):
        for k in b:
            np.testing.assert_array_equal(g[k].numpy(), b[k])
    # Abandoned after one batch: the upload thread stops and drains.
    gen = device_prefetch(iter(batches), "cpu", depth=1)
    next(gen)
    gen.close()


def _train(root, odgt, out, *extra, flags=()):
    from semseg_tpu_torch.cli import train

    return train.main([
        "--cfg", CFG, "--device", "cpu", *flags, "DIR", out,
        "DATASET.root_dataset", root, "DATASET.list_train", odgt,
        "DATASET.imgSizes", "(40, 48)", "DATASET.imgMaxSize", "80",
        "TRAIN.num_epoch", "2", "TRAIN.epoch_iters", "2", "TRAIN.disp_iter", "1",
        "TRAIN.workers", "1", "TPU.compute_dtype", "float32",
        "MODEL.pretrained_encoder", "False", *extra])


@pytest.fixture(scope="module")
def trained(train_set, tmp_path_factory):
    """Two epochs of two steps, uninterrupted."""
    root, odgt = train_set
    out = str(tmp_path_factory.mktemp("run"))
    state, history = _train(root, odgt, out)
    return out, state, history


def test_epoch_writes_pair_state_and_history(trained):
    out, state, history = trained
    for name in ("encoder_epoch_1.pth", "decoder_epoch_1.pth", "state_epoch_1.pt",
                 "history_epoch_1.json", "config.yaml", "encoder_epoch_2.pth"):
        assert os.path.exists(os.path.join(out, name)), name
    assert state.step == 4 and len(history["train"]["loss"]) == 4
    assert all(np.isfinite(history["train"]["loss"]))
    pair = torch.load(os.path.join(out, "encoder_epoch_1.pth"), weights_only=True)
    assert {"bn1._running_iter", "bn1._tmp_running_mean", "layer4.2.conv3.weight"} <= set(pair)
    saved = torch.load(os.path.join(out, "state_epoch_1.pt"), weights_only=True)
    assert saved["step"] == 2 and saved["optimizer"]["state"]  # momentum buffers
    with open(os.path.join(out, "history_epoch_1.json")) as f:
        assert len(json.load(f)["train"]["loss"]) == 2


def test_resume_repeats_the_uninterrupted_run(trained, train_set, tmp_path):
    """Epoch 2 resumed from epoch 1's state: step count, learning rate,
    momentum and BN statistics continue, and the data stream and dropout
    are seeded by epoch and step."""
    import shutil

    out, _, history = trained
    root, odgt = train_set
    shutil.copy(os.path.join(out, "state_epoch_1.pt"), tmp_path / "state_epoch_1.pt")
    state, resumed = _train(root, odgt, str(tmp_path), "TRAIN.start_epoch", "1")
    assert state.step == 4
    # The resumed history holds only the epoch it ran, as JAX's does.
    assert resumed == {"train": {k: v[2:] for k, v in history["train"].items()}}
    assert all(e > 1 for e in resumed["train"]["epoch"])
    for part in ("encoder", "decoder"):
        a = torch.load(os.path.join(out, f"{part}_epoch_2.pth"), weights_only=True)
        b = torch.load(tmp_path / f"{part}_epoch_2.pth", weights_only=True)
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_eval_reads_the_trained_pair(trained, train_set):
    from semseg_tpu_torch.cli import eval as eval_cli

    out, _, _ = trained
    root, odgt = train_set
    miou, acc, _, raw = eval_cli.main([
        "--cfg", CFG, "--device", "cpu", "DIR", out, "VAL.checkpoint", "epoch_2.pth",
        "DATASET.root_dataset", root, "DATASET.list_val", odgt,
        "DATASET.imgSizes", "(40, 48)", "DATASET.imgMaxSize", "80"])
    assert np.isfinite(miou) and 0.0 <= acc <= 1.0 and raw["pix_count"] > 0


def test_non_finite_loss_raises(train_set, tmp_path):
    root, odgt = train_set
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _train(root, odgt, str(tmp_path), "TRAIN.lr_encoder", "1e30", "TRAIN.lr_decoder", "1e30")


def test_profile_writes_a_trace_of_the_first_steps(train_set, tmp_path):
    root, odgt = train_set
    _train(root, odgt, str(tmp_path / "run"), "TRAIN.num_epoch", "1",
           flags=("--profile", str(tmp_path / "trace")))
    with open(tmp_path / "trace" / "train_trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"semseg::forward", "semseg::backward", "semseg::optimizer"} <= names


def test_pretrained_encoder_reads_the_local_cache_only(tmp_path, capsys):
    """A published backbone file in the cache directory loads into the
    encoder (its ``fc.*`` left out); without the file the encoder keeps its
    random init and a warning names the file."""
    from semseg_tpu_torch.checkpoint import load_pretrained_encoder, pretrained_backbone_path
    from semseg_tpu_torch.models import ModelBuilder

    assert pretrained_backbone_path("resnet18dilated", str(tmp_path)) is None
    assert "resnet18-imagenet.pth" in capsys.readouterr().err
    assert pretrained_backbone_path("hrnetv2_w18", str(tmp_path)) is None
    src = ModelBuilder.build_encoder("resnet18", device="cpu",
                                     generator=torch.Generator().manual_seed(3))
    state = {k: v for k, v in src.state_dict().items() if not k.endswith("_running_iter")}
    state["fc.weight"] = torch.zeros(1000, 512)
    torch.save(state, tmp_path / "resnet18-imagenet.pth")
    path = pretrained_backbone_path("resnet18dilated", str(tmp_path))
    assert path == str(tmp_path / "resnet18-imagenet.pth")
    enc = ModelBuilder.build_encoder("resnet18dilated", device="cpu")
    load_pretrained_encoder(enc, path)
    for k, v in enc.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--gpus", "0-3"], ["--multihost"]])
def test_more_than_one_card_raises(flags):
    from semseg_tpu_torch.cli import train

    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        train.main(["--cfg", CFG, *flags])
