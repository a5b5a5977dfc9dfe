"""The benchmark's own FLOP and byte counts against hand counts, and the
frozen shape rules against the program's."""

import pytest
import torch

from h100_bench import frozen
from h100_bench.reference.model import Arch, Model, Numerics, forward_flops, param_shapes


def test_one_conv_counts_its_multiply_adds():
    params = {"c.weight": torch.empty(64, 3, 3, 3, device="meta")}
    model = Model(params, Arch("resnet50", "upernet"), Numerics())
    model.conv(torch.empty(2, 3, 32, 48, device="meta"), "c", stride=2, padding=1)
    assert model.num.flops == 2 * (2 * 64 * 16 * 24) * (3 * 3 * 3)


def test_a_forward_counts_every_conv_once():
    arch = Arch("resnet50dilated", "ppm_deepsup")
    # The stem at 64x64: 3->64 s2, 64->64, 64->128 at 32x32.
    stem = 2 * 32 * 32 * (64 * 27 + 64 * 576 + 128 * 576)
    total = forward_flops(arch, (1, 3, 64, 64))
    assert total > stem
    # Doubling the batch doubles the count; the training forward adds the
    # deep-supervision head (3x3 1024->512 and 1x1 512->150 at conv4, 8x8).
    assert forward_flops(arch, (2, 3, 64, 64)) == 2 * total
    head = 2 * 8 * 8 * (512 * 1024 * 9 + 150 * 512)
    assert forward_flops(arch, (1, 3, 64, 64), training=True) == total + head


@pytest.mark.parametrize("arch", [Arch("resnet50dilated", "ppm_deepsup"),
                                  Arch("resnet50", "upernet")])
@pytest.mark.parametrize("training", [False, True])
def test_the_counter_counts_as_the_reference_forward(arch, training):
    """``forward_flops`` leaves BN out; the reference forward itself counts
    the same convolutions."""
    shape = (2, 3, 72, 104)
    model = Model(param_shapes(arch, device="meta"), arch, Numerics(), training=training,
                  masks=[torch.ones(2, 512, dtype=torch.bool, device="meta")] * 2)
    model.forward(torch.empty(shape, device="meta"))
    assert forward_flops(arch, shape, training=training) == model.num.flops


def test_pool_bytes_by_hand():
    # Two slots of a bf16 map with 2048 channels: their valid regions read
    # once, 50 means each written once, 8 bytes of extents each.
    assert frozen.pool_forward_bytes([(10, 12), (5, 7)], 2048, 2) == \
        (120 + 35 + 2 * 50) * 2048 * 2 + 16
    assert frozen.pool_backward_bytes((2, 10, 12, 2048), 2) == (2 * 120 + 2 * 50) * 2048 * 2


def test_frozen_rules_equal_the_programs():
    from semseg_tpu_torch.data import dataset, transforms
    from semseg_tpu_torch.engine import BatchedInferenceEngine

    for args in [(375, 500, 300, 1000), (1600, 900, 600, 1000), (333, 333, 450, 1000)]:
        assert frozen.scale_for(*args) == transforms.scale_for(*args)
    for step, pc in [(8, 8), (8, 32), (64, 8), (0, 32), (24, 32)]:
        assert frozen.effective_lattice(step, pc) == dataset._effective_lattice(step, pc)
    groups = {(64, 96): [1, 2, 3], (72, 96): [4], (64, 104): [5, 6], (200, 200): [7]}
    mine = frozen.pack_groups({k: list(v) for k, v in groups.items()}, 4)
    engine = BatchedInferenceEngine.__new__(BatchedInferenceEngine)
    engine.pack_buckets, engine.batch_size = True, 4
    engine.pack_max_area_ratio, engine.pack_max_pad_px = 1.3, 32
    assert mine == engine._pack_groups({k: list(v) for k, v in groups.items()})


def test_level_plan_equals_the_engines():
    from semseg_tpu_torch.engine import DevicePyramidEngine

    engine = DevicePyramidEngine.__new__(DevicePyramidEngine)
    engine.img_sizes, engine.img_max_size, engine.bucket_step = (300, 375, 450, 525, 600), 1000, 8
    for h, w in [(512, 683), (375, 500), (1080, 1600), (256, 300)]:
        assert frozen.level_plan(h, w, engine.img_sizes, 1000, 8) == engine.level_plan(h, w)


def test_sample_odgt_shapes_refuses_too_many():
    with pytest.raises(ValueError, match="manifest of 2"):
        frozen.sample_odgt_shapes([(1, 2), (3, 4)], 3, 0)


def test_param_shapes_hold_every_conv():
    shapes = param_shapes(Arch("resnet50", "upernet"), device="meta")
    assert shapes["decoder.conv_last.0.0.weight"].shape == (512, 2048, 3, 3)
    assert shapes["encoder.layer4.0.downsample.0.weight"].shape == (2048, 1024, 1, 1)
