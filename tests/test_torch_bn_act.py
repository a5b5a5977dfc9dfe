"""Batch norm in inference with its residual add and activation
(``ops/kernels/bn_act.py``, ``csrc/bn_act.cu``).

On the CPU (tier 1):

* the operator ``semseg_tpu_torch::bn_act``'s CPU implementation equals
  ``batch_norm_inference`` followed by the plain add and activation, in
  float32 and float64, and passes ``torch.library.opcheck``;
* the operator's backward equals autograd's through the plain chain, bit
  for bit, in bfloat16, float32 and float64; a training pass with every BN
  in eval mode (``TRAIN.fix_bn``) through the operator equals the plain
  one;
* the inputs the kernel does not take on the card (another layout,
  float64, parameters of another dtype or shape, a residual unlike the
  map) are refused;
* ``torch.export`` of a ``ConvBN`` and of a bottleneck ``ResBlock`` in eval
  keeps one ``bn_act`` node per batch norm, the last one of the block with
  the residual and ReLU, each with the output's shape and memory format;
* the zoo (r50d-ppm, UPerNet, HRNetV2, MobileNetV2) in eval gives outputs
  bit-equal to the unfused composition: each BN alone, then the add and the
  activation as separate plain ops, as the call sites ran them before the
  BN took them (``_unfused``);
* in training the call sites leave the outputs, the gradients and the
  running statistics equal to the unfused composition's;
* the benchmark's reader ``eval.bn_kernel_share`` on a synthetic trace.

On the card (marked ``cuda``; run with ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_bn_act.py``): the kernel
``torch.equal`` to the plain version on the card in bfloat16 and float32,
with and without a residual, each activation, at C = 64, 256, 512, 2048
and 36, on an offset (unaligned) storage, an empty batch and an
(N, C, 1, 1) map; its forward under a gradient with the operator's
backward against autograd through the plain chain; the launch counter;
NCHW and float64 maps refused; the zoo fused against unfused on the card.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder, layers
from semseg_tpu_torch.models.decoders import C1DeepSup, PPMDeepsup
from semseg_tpu_torch.models.hrnet import HRNetV2
from semseg_tpu_torch.models.layers import BatchNorm2d, ConvBN
from semseg_tpu_torch.models.resnet import ResBlock, ResNetEncoder
from semseg_tpu_torch.ops.kernels import bn_act
from semseg_tpu_torch.ops.norm import batch_norm_inference
from semseg_tpu_torch.ops.pool import max_pool2d
from semseg_tpu_torch.ops.resize import resize_bilinear

ACTS = [None, "relu", "relu6"]
ZOO = [("resnet50dilated", "ppm_deepsup", 2048), ("resnet50", "upernet", 2048),
       ("hrnetv2", "c1", 720), ("mobilenetv2dilated", "c1_deepsup", 320)]


def _stats(c, seed, device="cpu"):
    """Weight, bias, running mean and variance of C channels: a BN far from
    the identity, with negative scales, so the activations clip."""
    rng = np.random.RandomState(seed)
    vals = [rng.randn(c) * 1.5, rng.randn(c), rng.randn(c) * 0.5, rng.rand(c) * 2 + 0.05]
    return [torch.tensor(v, dtype=torch.float32, device=device) for v in vals]


# --- the unfused composition: each BN alone, then plain add and activation
# (the call sites' code before the BN took ``act`` and ``residual``).

def _unfused_block(self, x):
    out = F.relu(self.bn1(self.conv1(x)))
    if self.basic:
        out = self.bn2(self.conv2(out))
    else:
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
    residual = x if self.downsample is None else self.downsample(x)
    return F.relu(out + residual)


def _unfused_resnet(self, x):
    x = x.to(self.dtype)
    x = F.relu(self.bn1(self.conv1(x)))
    x = F.relu(self.bn2(self.conv2(x)))
    x = F.relu(self.bn3(self.conv3(x)))
    x = max_pool2d(x, kernel_size=3, stride=2, padding=1)
    features = []
    for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
        x = stage(x)
        features.append(x)
    return features


def _unfused_hrnet(self, x):
    x = x.to(self.dtype)
    x = F.relu(self.bn1(self.conv1(x)))
    x = F.relu(self.bn2(self.conv2(x)))
    xs = [self.layer1(x)]
    for s in (2, 3, 4):
        trans = getattr(self, f"transition{s - 1}")
        xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)]) for i, t in enumerate(trans)]
        xs = getattr(self, f"stage{s}")(xs)
    hw = xs[0].shape[2:]
    return [torch.cat([xs[0]] + [resize_bilinear(b, hw) for b in xs[1:]], dim=1)]


@contextlib.contextmanager
def _unfused():
    """Every call site back to BN alone, then the plain add and activation."""
    saved = [(ResBlock, "_forward"), (ResNetEncoder, "forward"), (HRNetV2, "forward"),
             (layers.Sequential, "forward")]
    old = [(cls, name, cls.__dict__[name]) for cls, name in saved]
    ResBlock._forward = _unfused_block
    ResNetEncoder.forward = _unfused_resnet
    HRNetV2.forward = _unfused_hrnet
    layers.Sequential.forward = nn.Sequential.forward
    try:
        yield
    finally:
        for cls, name, fn in old:
            setattr(cls, name, fn)


def _perturb(model, seed=0):
    """BN statistics and affines far from the identity."""
    for i, m in enumerate(model.modules()):
        if isinstance(m, BatchNorm2d):
            w, b, mean, var = _stats(m.num_features, seed + i, m.weight.device)
            with torch.no_grad():
                m.weight.copy_(w * 0.5 + 1.0)
                m.bias.copy_(b * 0.2)
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
    return model


def _zoo_model(encoder, decoder, fc_dim, device, dtype):
    c = cfg.clone()
    c.MODEL.arch_encoder, c.MODEL.arch_decoder, c.MODEL.fc_dim = encoder, decoder, fc_dim
    return _perturb(ModelBuilder.build_model(c, device=device, dtype=dtype))


def _flat(out):
    return [t for o in (out if isinstance(out, (tuple, list)) else [out])
            for t in (o if isinstance(o, (tuple, list)) else [o])]


def _fused_and_unfused(model, x, **kw):
    with torch.inference_mode():
        fused = _flat(model(x, **kw))
        with _unfused():
            plain = _flat(model(x, **kw))
    return fused, plain


# --- CPU

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
@pytest.mark.parametrize("act", ACTS, ids=str)
def test_cpu_op_is_the_plain_chain(act, residual, dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 3, 5, generator=g, dtype=dtype) * 3
    r = torch.randn(2, 6, 3, 5, generator=g, dtype=dtype) if residual else None
    params = _stats(6, 1)
    got = torch.ops.semseg_tpu_torch.bn_act(x, *params, 1e-5, r, act or "none")
    want = batch_norm_inference(x, *params, eps=1e-5)
    if r is not None:
        want = want + r
    want = {None: want, "relu": F.relu(want), "relu6": F.relu6(want)}[act]
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(bn_act.bn_act(x, *params, 1e-5, r, act), want)


def test_cpu_op_passes_opcheck():
    x = torch.randn(2, 6, 3, 5).contiguous(memory_format=torch.channels_last)
    r = torch.randn(2, 6, 3, 5).contiguous(memory_format=torch.channels_last)
    torch.library.opcheck(torch.ops.semseg_tpu_torch.bn_act, (x, *_stats(6, 2), 1e-5, r, "relu"))


def test_rejects_an_unknown_activation():
    with pytest.raises(ValueError, match="unknown activation"):
        bn_act.bn_act(torch.zeros(1, 2, 1, 1), *_stats(2, 0), act="gelu")


def _leaves(dtype, residual, seed=3, shape=(2, 6, 3, 5), device="cpu"):
    """A map (channels_last), the four (C,) vectors and the residual; the
    map, the affine and the residual require grad."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    r = None
    if residual:
        r = torch.randn(shape, generator=g, device=device).to(dtype)
        r = r.contiguous(memory_format=torch.channels_last).requires_grad_()
    w, b, mean, var = _stats(shape[1], seed + 1, device)
    return x, w.requires_grad_(), b.requires_grad_(), mean, var, r


def _grads(fn, x, w, b, mean, var, r, act, seed=5):
    g = torch.Generator(device=x.device).manual_seed(seed)
    y = fn(x, w, b, mean, var, 1e-5, r, act)
    dy = torch.randn(y.shape, generator=g, device=x.device).to(y.dtype)
    inputs = [t for t in (x, w, b, r) if t is not None]
    return (y.detach(), *torch.autograd.grad(y, inputs, dy))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
@pytest.mark.parametrize("act", ACTS, ids=str)
def test_cpu_op_gradient_is_the_plain_chains(act, residual, dtype):
    leaves = _leaves(dtype, residual)
    got = _grads(lambda *a: torch.ops.semseg_tpu_torch.bn_act(*a[:7], a[7] or "none"),
                 *leaves, act)
    want = _grads(bn_act.bn_act_plain, *leaves, act)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.stride() == b.stride() and torch.equal(a, b)


def test_op_gives_the_running_statistics_no_gradient():
    x, w, b, mean, var, _ = _leaves(torch.float32, False)
    y = torch.ops.semseg_tpu_torch.bn_act(x, w, b, mean.requires_grad_(), var, 1e-5, None,
                                          "relu")
    with pytest.raises(RuntimeError, match="running statistics"):
        y.sum().backward()


@pytest.mark.parametrize("bad", ["nchw", "float64", "strided", "param_dtype", "param_shape",
                                 "residual_dtype", "residual_nchw"])
def test_card_check_refuses_what_the_kernel_does_not_take(bad):
    x = torch.zeros(2, 16, 3, 4).contiguous(memory_format=torch.channels_last)
    params, r = _stats(16, 0), torch.zeros_like(x)
    bn_act._check(x, *params, r)  # taken
    if bad == "nchw":
        x = x.contiguous()
    elif bad == "float64":
        x, r = x.double(), r.double()
    elif bad == "strided":
        x = torch.zeros(2, 16, 6, 4).contiguous(memory_format=torch.channels_last)[:, :, ::2]
    elif bad == "param_dtype":
        params[1] = params[1].double()
    elif bad == "param_shape":
        params[2] = params[2][:8]
    elif bad == "residual_dtype":
        r = r.to(torch.bfloat16)
    else:
        r = r.contiguous()
    with pytest.raises(ValueError, match="bn_act"):
        bn_act._check(x, *params, r)


def _bn_act_nodes(module, x):
    with torch.no_grad():
        exp = torch.export.export(module, (x,))
    nodes = [n for n in exp.graph.nodes if n.target == torch.ops.semseg_tpu_torch.bn_act.default]
    return exp, nodes


def test_export_keeps_one_node_per_bn():
    torch.manual_seed(0)
    x = torch.randn(2, 8, 6, 7).contiguous(memory_format=torch.channels_last)
    cbr = _perturb(ConvBN(8, 16, 3)).eval().to(memory_format=torch.channels_last)
    exp, nodes = _bn_act_nodes(cbr, x)
    assert len(nodes) == 1 and nodes[0].args[-1] == "relu"
    val = nodes[0].meta["val"]
    assert tuple(val.shape) == (2, 16, 6, 7) and val.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(exp.module()(x), cbr(x))

    block = _perturb(ResBlock("bottleneck", 8, 4, stride=2, has_downsample=True)).eval()
    block = block.to(memory_format=torch.channels_last)
    exp, nodes = _bn_act_nodes(block, x)
    assert len(nodes) == sum(isinstance(m, BatchNorm2d) for m in block.modules()) == 4
    # bn1, bn2 with ReLU; the downsample's BN bare; bn3 with the residual and ReLU.
    assert [(n.args[6] is not None, n.args[7]) for n in nodes] == [
        (False, "relu"), (False, "relu"), (False, "none"), (True, "relu")]
    assert [tuple(n.meta["val"].shape) for n in nodes] == [
        (2, 4, 6, 7), (2, 4, 3, 4), (2, 16, 3, 4), (2, 16, 3, 4)]
    assert all(n.meta["val"].is_contiguous(memory_format=torch.channels_last) for n in nodes)
    with torch.no_grad():
        assert torch.equal(exp.module()(x), block(x))


@pytest.mark.parametrize("arch", ZOO, ids=lambda a: f"{a[0]}-{a[1]}")
def test_zoo_eval_equals_the_unfused_composition(arch):
    torch.manual_seed(0)
    model = _zoo_model(*arch, device="cpu", dtype=torch.float32)
    x = torch.randn(1, 3, 48, 48).contiguous(memory_format=torch.channels_last)
    fused, plain = _fused_and_unfused(model, x, seg_size=(48, 48))
    assert len(fused) == len(plain) >= 1
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)


def _tiny_train_model(block):
    planes = (4, 8, 16, 32)
    enc = ResNetEncoder(block=block, layers=(1, 1, 1, 1), planes=planes, dilate_scale=8)
    out = planes[-1] * (4 if block == "bottleneck" else 1)
    dec = PPMDeepsup(num_class=5, fc_dim=out) if block == "bottleneck" else \
        C1DeepSup(num_class=5, fc_dim=out)
    return _perturb(nn.ModuleDict({"enc": enc, "dec": dec})).train()


def _train_pass(model, x, w):
    torch.manual_seed(7)  # the dropout masks
    outs = _flat(model["dec"](model["enc"](x)))
    loss = sum((o * wi).sum() for o, wi in zip(outs, w))
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return outs, grads, {k: b.clone() for k, b in model.named_buffers()}


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_training_equals_the_unfused_composition(block):
    torch.manual_seed(1)
    model = _tiny_train_model(block)
    twin = copy.deepcopy(model)
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        probe = copy.deepcopy(model)
        w = [torch.randn(o.shape) for o in _flat(probe["dec"](probe["enc"](x)))]
    fused = _train_pass(model, x, w)
    with _unfused():
        plain = _train_pass(twin, x, w)
    for a, b in zip(fused[0], plain[0]):
        assert torch.equal(a, b)
    for part in (1, 2):
        assert fused[part].keys() == plain[part].keys()
        for k in fused[part]:
            assert torch.equal(fused[part][k], plain[part][k]), k


def _operator_bn(x, weight, bias, running_mean, running_var, eps=1e-5, residual=None,
                 act=None):
    """``bn_act`` through the operator on the CPU too, as a CUDA call under
    a gradient takes it."""
    return torch.ops.semseg_tpu_torch.bn_act(x, weight, bias, running_mean, running_var,
                                             float(eps), residual, act or "none")


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_fix_bn_training_through_the_operator_equals_plain(block, monkeypatch):
    """Every BN in eval mode in a training pass (``TRAIN.fix_bn``): the
    operator's forward and backward give the plain chain's outputs and
    gradients, and the running statistics stay."""
    torch.manual_seed(2)
    model = _tiny_train_model(block)
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.eval()
    twin = copy.deepcopy(model)
    x = torch.randn(2, 3, 32, 32).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        probe = copy.deepcopy(model)
        w = [torch.randn(o.shape) for o in _flat(probe["dec"](probe["enc"](x)))]
    plain = _train_pass(model, x, w)
    monkeypatch.setattr(layers, "bn_act", _operator_bn)
    fused = _train_pass(twin, x, w)
    for a, b in zip(fused[0], plain[0]):
        assert torch.equal(a, b)
    for part in (1, 2):
        assert fused[part].keys() == plain[part].keys()
        for k in fused[part]:
            assert torch.equal(fused[part][k], plain[part][k]), k


def test_kernel_share_reader():
    from h100_bench import harness
    from h100_bench.trace import Op, Window

    host = [Op("semseg::bn", 100.0, 200.0, "user_annotation", 1),
            Op("semseg::conv", 300.0, 400.0, "user_annotation", 1)]
    name = "void (anonymous namespace)::bn_act_nhwc_kernel<__nv_bfloat16, 8, true, 1>(...)"
    device = [Op(name, 1000.0, 1800.0, "kernel", 1, 150.0),
              Op("elementwise_kernel", 1900.0, 2100.0, "kernel", 1, 160.0),
              Op(name, 3000.0, 3500.0, "kernel", 1, 350.0)]  # under conv: not read
    read = harness.metric_reader("eval.bn_kernel_share")
    info = {"kind": "eval", "images": 4}
    assert read(Window(device, host, 1.0, info)) == pytest.approx(80.0)
    assert read(Window(device, host, 1.0, {"kind": "train", "steps": 4})) is None
    # A program without the kernel (the plain chain under the span) reads nothing.
    assert read(Window(device[1:2], host, 1.0, info)) is None


# --- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _map(shape, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _check_card(x, r, act, params, launched=1):
    before = bn_act.LAUNCHES
    with torch.inference_mode():
        got = bn_act.bn_act(x, *params, 1e-5, r, act)
        want = bn_act.bn_act_plain(x, *params, 1e-5, r, act)
    torch.cuda.synchronize()
    assert bn_act.LAUNCHES == before + launched
    assert got.shape == x.shape and got.dtype == x.dtype and got.stride() == x.stride()
    assert torch.equal(got, want), (tuple(x.shape), x.dtype, r is not None, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_equals_plain_on_card(dtype):
    dev = _card()
    dtype = getattr(torch, dtype)
    for c in (64, 256, 512, 2048, 36):
        for hw in ((5, 7), (4, 8)):
            params = _stats(c, c, dev)
            x = _map((2, c, *hw), dtype, c, dev)
            r = _map((2, c, *hw), dtype, c + 1, dev)
            for act in ACTS:
                _check_card(x, None, act, params)
                _check_card(x, r, act, params)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_edge_shapes_on_card(dtype):
    dev = _card()
    dtype = getattr(torch, dtype)
    c = 256
    params = _stats(c, 5, dev)
    shape = (2, c, 6, 9)
    # Offset storage: the map starts one element past an aligned address.
    g = torch.Generator(device=dev).manual_seed(6)
    base = (torch.randn(2 * c * 6 * 9 + 1, generator=g, device=dev) * 3).to(dtype)[1:]
    x = base.view(2, 6, 9, c).permute(0, 3, 1, 2)
    r = _map(shape, dtype, 7, dev)
    assert x.data_ptr() % 16 != 0
    for act in ACTS:
        _check_card(x, r, act, params)
        _check_card(x, None, act, params)
    # An empty batch (nothing launched, nothing counted) and 1x1 maps.
    _check_card(_map((0, c, 6, 9), dtype, 8, dev), None, "relu", params, launched=0)
    for n in (1, 3):
        x = _map((n, c, 1, 1), dtype, 9, dev)
        _check_card(x, _map((n, c, 1, 1), dtype, 10, dev), "relu", params)
        _check_card(x, None, "relu6", params)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_forward_under_a_gradient_on_card(dtype):
    """A call whose output needs a gradient (``TRAIN.fix_bn``) launches the
    kernel; the operator's backward equals autograd's through the plain
    chain."""
    _card()
    for residual in (False, True):
        for act in ACTS:
            leaves = _leaves(getattr(torch, dtype), residual, shape=(2, 64, 5, 7),
                             device="cuda")
            before = bn_act.LAUNCHES
            got = _grads(bn_act.bn_act, *leaves, act)
            torch.cuda.synchronize()
            assert bn_act.LAUNCHES == before + 1
            want = _grads(bn_act.bn_act_plain, *leaves, act)
            for a, b in zip(got, want):
                assert a.stride() == b.stride() and torch.equal(a, b), (dtype, residual, act)


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take():
    dev = _card()
    params = _stats(16, 1, dev)
    x64 = _map((2, 16, 3, 4), torch.float64, 1, dev)
    nchw = _map((2, 16, 3, 4), torch.float32, 2, dev).contiguous()
    for x in (x64, nchw):
        before = bn_act.LAUNCHES
        with torch.inference_mode(), pytest.raises(ValueError, match="channels_last"):
            bn_act.bn_act(x, *params, 1e-5, None, "relu")
        assert bn_act.LAUNCHES == before


@pytest.mark.cuda
def test_registered_op_passes_opcheck_on_card():
    dev = _card()
    x = _map((2, 24, 3, 5), torch.float32, 3, dev)
    r = _map((2, 24, 3, 5), torch.float32, 4, dev)
    torch.library.opcheck(torch.ops.semseg_tpu_torch.bn_act, (x, *_stats(24, 2, dev), 1e-5, r,
                                                             "relu6"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ZOO, ids=lambda a: f"{a[0]}-{a[1]}")
def test_zoo_fused_equals_unfused_on_card(arch, dtype):
    dev = _card()
    torch.manual_seed(0)
    model = _zoo_model(*arch, device=dev, dtype=getattr(torch, dtype))
    x = torch.randn(2, 3, 96, 128, device=dev).contiguous(memory_format=torch.channels_last)
    before = bn_act.LAUNCHES
    fused, plain = _fused_and_unfused(model, x, seg_size=(96, 128))
    torch.cuda.synchronize()
    assert bn_act.LAUNCHES > before
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)
