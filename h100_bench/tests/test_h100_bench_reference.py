"""The plain reference against the program at a tiny size in float64 on the
CPU: the model's eval forward, one evaluation pass through the engine, the
training steps, and the synchronised BN of a two-rank gloo step."""

import os
import socket

import pytest
import torch

from h100_bench import harness
from h100_bench.drivers import eval_ms, train
from h100_bench.reference import model as ref_model
from h100_bench.reference.model import Arch, Model, Numerics, seeded_params
from h100_bench.tests import tiny

ARCHS = {"r50d-ppm": Arch("resnet50dilated", "ppm_deepsup"),
         "r50-upernet": Arch("resnet50", "upernet")}


def _port_model(config_name):
    from semseg_tpu_torch.models.builder import ModelBuilder

    cfg = harness.port_cfg(harness.load_cell(
        "r50d-ppm.eval-ms" if config_name == "r50d-ppm" else "r50-upernet.eval-ms").config)
    return ModelBuilder.build_model(cfg, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_names_match_the_program(name):
    arch = ARCHS[name]
    with torch.device("meta"):
        from semseg_tpu_torch.models.builder import ModelBuilder

        cfg = harness.port_cfg(harness.load_cell(
            "r50d-ppm.eval-ms" if name == "r50d-ppm" else "r50-upernet.eval-ms").config)
        port = ModelBuilder.build_model(cfg, device="meta").state_dict()
    mine = ref_model.param_shapes(arch)
    assert set(port) == set(mine)
    assert all(tuple(port[k].shape) == tuple(mine[k].shape) for k in port)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_eval_forward_matches_in_float64(name):
    torch.manual_seed(0)
    arch = ARCHS[name]
    port = _port_model(name)
    params = seeded_params(arch, 11, "cpu")
    for k in params:  # running statistics away from the identity
        if k.endswith("running_var"):
            params[k] = torch.rand_like(params[k]) + 0.5
        elif k.endswith("running_mean"):
            params[k] = torch.randn_like(params[k]) * 0.1
    port.load_state_dict(params)
    x = torch.randn(2, 3, 64, 96, dtype=torch.float64)
    x[1, :, 48:] = 0
    x[1, :, :, 72:] = 0
    hw = torch.tensor([[64, 96], [48, 72]], dtype=torch.int32)
    with torch.no_grad():
        out = port(x.contiguous(memory_format=torch.channels_last), valid_hw=hw)
        ref, _ = Model(params, arch, Numerics(torch.float64)).forward(x, [(64, 96), (48, 72)])
    # The program folds BN's affine from float32 parameters: 1e-6 of the scale.
    assert (out - ref).abs().max() <= 1e-6 * ref.abs().max()


@pytest.mark.parametrize("cell", ["r50d-ppm.eval-ms", "r50-upernet.eval-ms"])
def test_eval_pass_matches_in_float64(monkeypatch, cell):
    out = eval_ms.run(tiny.tiny(cell, float64=True), 5, 0.0, False, "cpu")
    assert out["readings"] and all(g == 0.0 and p == 0.0 for g, p in out["readings"])


def test_train_steps_match_in_float64(monkeypatch):
    out = train.run(tiny.tiny("r50d-ppm.train-b8", float64=True), 7, 0.0, False, "cpu")
    r = out["readings"]
    # Step 1's gradient is exact to rounding; the program keeps its
    # parameters in float32, which the later steps' changes carry.
    assert r["grad_gap"] < 1e-6 and r["grad_median"] < 1e-6
    assert r["loss_gap"] < 1e-4
    assert r["change_median"] < 1e-3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _weights(n):
    return torch.arange(n, dtype=torch.float64).cos()


def _bn_rank(rank, world, port, x, path):
    """One rank of the program's synchronised BN over its slice of ``x``."""
    import torch.distributed as dist
    from semseg_tpu_torch.models.layers import BatchNorm2d

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        bn = BatchNorm2d(x.shape[1]).double().train()
        bn.process_group = dist.group.WORLD
        n = x.shape[0] // world
        part = x[rank * n:(rank + 1) * n].clone().requires_grad_(True)
        y = bn(part)
        (y * _weights(y.numel()).view_as(y)).sum().backward()
        torch.save((y.detach(), part.grad, bn.running_mean, bn.running_var),
                   os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_synchronised_bn_matches_two_gloo_ranks(tmp_path):
    """The program's BN over two gloo ranks against the reference's BN over
    the whole batch: outputs, input gradients, running statistics."""
    import torch.multiprocessing as mp

    torch.manual_seed(3)
    x = torch.randn(4, 5, 3, 4, dtype=torch.float64) * 2 + 1
    mp.spawn(_bn_rank, args=(2, _free_port(), x, str(tmp_path)), nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    params = {"b.weight": torch.ones(5, dtype=torch.float64),
              "b.bias": torch.zeros(5, dtype=torch.float64),
              "b.running_mean": torch.zeros(5, dtype=torch.float64),
              "b.running_var": torch.ones(5, dtype=torch.float64),
              "b._running_iter": torch.ones(1, dtype=torch.float64)}
    xr = x.clone().requires_grad_(True)
    m = Model(params, ARCHS["r50d-ppm"], Numerics(torch.float64), training=True)
    y = m.bn(xr, "b")
    # Each rank weighs its own slice's outputs.
    (y * torch.cat([_weights(y.numel() // 2)] * 2).view_as(y)).sum().backward()
    assert torch.allclose(torch.cat([r[0] for r in ranks]), y.detach(), atol=1e-12)
    assert torch.allclose(torch.cat([r[1] for r in ranks]), xr.grad, atol=1e-10)
    mean, var, _ = m.new_stats["b"]
    for r in ranks:
        assert torch.allclose(r[2], mean, atol=1e-12) and torch.allclose(r[3], var, atol=1e-12)


def test_running_statistics_follow_the_reference_over_three_steps():
    """The program's BN running statistics (the bias-corrected EMA of the
    batch's mean and unbiased variance) after three training forwards of
    batches with different statistics, against the reference's, which
    starts each forward from the statistics the last one left."""
    from semseg_tpu_torch.models.layers import BatchNorm2d

    torch.manual_seed(5)
    batches = [torch.randn(3, 4, 5, 6, dtype=torch.float64) * (1 + k) + k for k in range(3)]
    bn = BatchNorm2d(4).double().train()
    params = {"b.weight": torch.ones(4, dtype=torch.float64),
              "b.bias": torch.zeros(4, dtype=torch.float64),
              "b.running_mean": torch.zeros(4, dtype=torch.float64),
              "b.running_var": torch.ones(4, dtype=torch.float64),
              "b._running_iter": torch.ones(1, dtype=torch.float64)}
    for x in batches:
        bn(x)
        m = Model(params, ARCHS["r50d-ppm"], Numerics(torch.float64), training=True)
        m.bn(x, "b")
        mean, var, it = m.new_stats["b"]
        params.update({"b.running_mean": mean, "b.running_var": var, "b._running_iter": it})
        assert torch.allclose(bn.running_mean, mean, rtol=1e-12, atol=1e-12)
        assert torch.allclose(bn.running_var, var, rtol=1e-12, atol=1e-12)
        assert torch.allclose(bn._running_iter, it, rtol=1e-12)
    # Three steps moved the statistics well away from where they started.
    assert (params["b.running_mean"] - 0.0).abs().min() > 0.1
