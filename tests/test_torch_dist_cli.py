"""``cli.train --device cpu --devices 2`` on the CPU: two gloo ranks train
the resnet18dilated config at tiny ``imgSizes`` over the written PNG set of
``test_torch_train_cli.py`` (two epochs of two steps, one loader worker
per rank), only rank 0 writes each checkpoint (once), and a resume at
epoch 1 on two ranks repeats the uninterrupted run's epoch 2 bit for bit.
``test_torch_dist_eval_cli.py`` holds the eval side."""

import json
import os
import shutil

import numpy as np
import torch

from semseg_tpu_torch.cli import train
from semseg_tpu_torch.parallel import distributed
from test_torch_dist_ranks import train_cli_rank
from test_torch_train_cli import train_set  # noqa: F401  (the fixture)

CFG18 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config",
                     "ade20k-resnet18dilated-ppm_deepsup.yaml")


def argv(root, odgt, out, *extra):
    return ["--cfg", CFG18, "--device", "cpu", "--devices", "2", "DIR", out,
            "DATASET.root_dataset", root, "DATASET.list_train", odgt,
            "DATASET.imgSizes", "(40, 48)", "DATASET.imgMaxSize", "80",
            "TRAIN.num_epoch", "2", "TRAIN.epoch_iters", "2", "TRAIN.disp_iter", "1",
            "TRAIN.workers", "1", "TPU.compute_dtype", "float32",
            "MODEL.pretrained_encoder", "False", *extra]


def test_two_ranks_train_resume_and_write_each_checkpoint_once(train_set, tmp_path):  # noqa: F811
    root, odgt = train_set
    out = str(tmp_path / "run")
    assert train.main(argv(root, odgt, out)) is None  # the ranks trained
    for name in ("encoder_epoch_1.pth", "decoder_epoch_1.pth", "state_epoch_1.pt",
                 "history_epoch_2.json", "config.yaml", "encoder_epoch_2.pth"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "history_epoch_2.json")) as f:
        losses = json.load(f)["train"]["loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert torch.load(os.path.join(out, "state_epoch_2.pt"), weights_only=True)["step"] == 4

    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    shutil.copy(os.path.join(out, "state_epoch_1.pt"), resumed)
    log = str(tmp_path / "writes.log")
    args = train.parse_args(argv(root, odgt, resumed, "TRAIN.start_epoch", "1"))
    torch.multiprocessing.spawn(train_cli_rank, args=(args, 2, distributed.free_port(), log),
                                nprocs=2)
    with open(log) as f:
        assert f.read().split("\n") == ["0 2", ""]  # rank 0 alone, once
    for part in ("encoder", "decoder"):
        a = torch.load(os.path.join(out, f"{part}_epoch_2.pth"), weights_only=True)
        b = torch.load(os.path.join(resumed, f"{part}_epoch_2.pth"), weights_only=True)
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
