"""The eval side of multi-card runs on the CPU: ``cli.eval --device cpu
--devices 2 --exact`` (two engines taking the val list in turn, one thread
each) and ``cli.eval_multipro --gpus 0-1`` give the one-engine run's
metric sums; two ``--start-idx/--end-idx --metrics-out`` shards combine
into the unsharded run's mIoU and accuracy through the port's
``tools/combine_eval_shards.py``, and the root tool reads the same files
the same way. resnet18dilated + ppm_deepsup with seeded random weights, at
tiny ``imgSizes``, over ``test_torch_train_cli.py``'s written PNG set.

Intersections, unions and pixel counts are integers and must be equal;
the accuracy sum adds one float per image, in the order the threads finish,
so it is held to 1e-12 relative.
"""

import os

import numpy as np
import pytest
import torch

from semseg_tpu_torch.cli import eval as eval_cli, eval_multipro
from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.tools import combine_eval_shards
from test_torch_dist_cli import CFG18
from test_torch_train_cli import train_set  # noqa: F401  (the fixture)


@pytest.fixture(scope="module")
def val(train_set, tmp_path_factory):  # noqa: F811
    root, odgt = train_set
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    c = cfg.clone()
    c.merge_from_file(CFG18)
    model = ModelBuilder.build_model(c, device="cpu", seed=0)
    for part in ("encoder", "decoder"):
        torch.save(getattr(model, part).state_dict(), os.path.join(ckpt, f"{part}_epoch_20.pth"))
    opts = ["DIR", ckpt, "DATASET.root_dataset", root, "DATASET.list_val", odgt,
            "DATASET.imgSizes", "(40, 48)", "DATASET.imgMaxSize", "80"]
    one = eval_cli.main(["--cfg", CFG18, "--device", "cpu", "--exact", *opts])
    return opts, one


def check_sums(raw, ref):
    for k in ("inter", "union", "pix_count"):
        np.testing.assert_array_equal(raw[k], ref[k], err_msg=k)
    np.testing.assert_allclose(raw["acc_sum"], ref["acc_sum"], rtol=1e-12)


@pytest.mark.parametrize("entry,flags", [(eval_cli, ["--devices", "2"]),
                                         (eval_multipro, ["--gpus", "0-1"])],
                         ids=["eval-devices", "eval_multipro-gpus"])
def test_two_engines_give_one_engines_sums(val, entry, flags):
    opts, (_, _, _, ref) = val
    miou, acc, _, raw = entry.main(["--cfg", CFG18, "--device", "cpu", "--exact", *flags, *opts])
    assert ref["pix_count"] > 0
    check_sums(raw, ref)


def test_engine_devices_follow_the_visible_cards():
    assert eval_cli.engine_devices("cpu", 3) == ["cpu"] * 3
    assert eval_cli.engine_devices("cuda", 1) == ["cuda"]


def test_shards_combine_into_the_unsharded_run(val, tmp_path, capsys):
    import importlib.util

    opts, (miou, acc, _, _) = val
    shards = []
    for i, (lo, hi) in enumerate(((0, 4), (4, 8))):
        shards.append(str(tmp_path / f"shard{i}.npz"))
        eval_cli.main(["--cfg", CFG18, "--device", "cpu", "--exact", "--start-idx", str(lo),
                       "--end-idx", str(hi), "--metrics-out", shards[-1], *opts])
    capsys.readouterr()
    _, got_miou, got_acc = combine_eval_shards.main(shards)
    np.testing.assert_allclose(got_miou, miou, rtol=1e-12)
    np.testing.assert_allclose(got_acc, acc, rtol=1e-12)
    port_lines = capsys.readouterr().out.splitlines()

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "root_combine_eval_shards", os.path.join(root, "tools", "combine_eval_shards.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main(shards)
    assert capsys.readouterr().out.splitlines() == port_lines
    assert port_lines[-1].startswith("Mean IoU: ")
