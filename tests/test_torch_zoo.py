"""The rest of the model zoo: the port against the JAX package on the CPU.

Per family, the port's model is built with seeded random weights, which go
onto JAX's variables through the JAX package's converter for the
reference's state dicts (over the ``jax.eval_shape`` template of JAX's
init, so no JAX init runs: 2-6 s a family against 6-30 s for JAX's eager
init on the CPU); the running statistics are perturbed there so that BN is
not the identity, the variables come back through the port's
``state_dicts_from_jax`` into the port's modules, and the same seeded
numpy images go through both at 64 x 64 in float32:

* ``state_dicts_from_jax`` equals ``semseg_tpu.models.export.export_state_dicts``
  minus the SyncBN accumulators, and loads strict into the port's module;
* the ``seg_size`` forward (probabilities) within atol 1e-4 (1e-3 for
  UPerNet, whose random-weight logits reach ~1e3 in magnitude, so f32
  summation order moves a near-one-hot softmax more), with argmax
  agreement >= 0.999;
* the ``valid_hw`` forward (f32 logits at decoder resolution, on a padded
  batch with per-sample extents) within 1e-4 of the logits' largest
  magnitude.

resnext101 runs its forward at one block per stage, full widths; at full
depth resnet101, resnet101dilated and resnext101 are checked by keys and
shapes only (``jax.eval_shape``, no forward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semseg_tpu.config import cfg
from semseg_tpu.models import ModelBuilder as JaxModelBuilder
from semseg_tpu.models import decoders as jax_decoders, resnet as jax_resnet
from semseg_tpu.models.export import export_state_dicts
from semseg_tpu.models.segmentation import SegmentationModel as JaxSegmentationModel

from semseg_tpu_torch.models import ModelBuilder, SegmentationModel
from semseg_tpu_torch.models.builder import ENCODER_CHANNELS, _init
from semseg_tpu_torch.models.convert import SYNCBN_ACCUMULATORS, state_dicts_from_jax
from semseg_tpu_torch.models.decoders import C1
from semseg_tpu_torch.models.resnet import ResNetEncoder

from test_torch_model import _perturb_stats, jax_forward, port_weights_for_jax

# (encoder, decoder, fc_dim); hrnetv2 + C1 and the UPerNet pair run in
# test_torch_zoo_hrnet_upernet.py, so that the two files run side by side.
FAMILIES = [
    ("mobilenetv2dilated", "c1_deepsup", 320),
    ("resnet18dilated", "ppm_deepsup", 512),
    ("resnet18dilated", "ppm", 512),
    ("resnext101_1111", "c1", 2048),
]
HW = (64, 64)
EXTENTS = [[64, 64], [41, 57]]


def _jax_model(encoder, decoder, fc_dim):
    if encoder == "resnext101_1111":  # one block per stage, full widths
        return JaxSegmentationModel(
            encoder=jax_resnet.ResNetEncoder(block="group_bottleneck", layers=(1, 1, 1, 1),
                                             planes=(128, 256, 512, 1024), groups=32),
            decoder=jax_decoders.C1(num_class=150, fc_dim=fc_dim),
        )
    c = cfg.clone()
    c.MODEL.arch_encoder, c.MODEL.arch_decoder, c.MODEL.fc_dim = encoder, decoder, fc_dim
    return JaxModelBuilder.build_model(c, dtype=jnp.float32)


def _port_model(encoder, decoder, fc_dim):
    """The port's model with seeded random weights."""
    if encoder == "resnext101_1111":
        port = SegmentationModel(ResNetEncoder(block="group_bottleneck", layers=(1, 1, 1, 1),
                                               planes=(128, 256, 512, 1024), groups=32),
                                 C1(num_class=150, fc_dim=fc_dim))
        generator = torch.Generator().manual_seed(0)
        _init(port.encoder, generator, mode="fan_out", bn_bias=0.0)
        _init(port.decoder, generator, mode="fan_in", bn_bias=1e-4)
        return port.eval().to(memory_format=torch.channels_last)
    return SegmentationModel(
        ModelBuilder.build_encoder(encoder, fc_dim, device="cpu"),
        ModelBuilder.build_decoder(decoder, fc_dim, encoder_arch=encoder, device="cpu"),
    )


def build_family(encoder, decoder, fc_dim):
    """(JAX model, variables, port model, arch keys) of one family (module
    docstring): the port's seeded weights through JAX's converter onto the
    template of its variables, statistics perturbed, and back."""
    model = _jax_model(encoder, decoder, fc_dim)
    port = _port_model(encoder, decoder, fc_dim)
    arch = ("resnet50" if encoder == "resnext101_1111" else encoder, decoder)
    variables = port_weights_for_jax(model, port, *arch, image_size=HW)
    variables = {"params": variables["params"],
                 "batch_stats": _perturb_stats(variables["batch_stats"],
                                               np.random.RandomState(0))}
    enc_sd, dec_sd = state_dicts_from_jax(variables, *arch)
    port.encoder.load_state_dict(enc_sd, strict=True)
    port.decoder.load_state_dict(dec_sd, strict=True)
    return model, variables, port.eval(), arch


def _prob_atol(family):
    # UPerNet's random-weight logits reach ~1e3: a relative f32 difference
    # of ~3e-6 there moves a near-one-hot softmax by up to ~3e-4.
    return 1e-3 if family[3][1].startswith("upernet") else 1e-4


def _jit(family):
    return family[3][0] != "hrnetv2"  # see jax_forward


def check_converter_matches_export(family):
    _, variables, _, arch = family
    mine = state_dicts_from_jax(variables, *arch)
    ref = export_state_dicts(variables, arch_encoder=arch[0], arch_decoder=arch[1])
    for m, r in zip(mine, ref):
        r = {k: v for k, v in r.items() if not k.endswith(SYNCBN_ACCUMULATORS)}
        assert sorted(m) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(m[k].numpy(), r[k], err_msg=k)


def check_seg_size_forward(family):
    model, variables, port, _ = family
    img = np.random.RandomState(1).randn(1, *HW, 3).astype(np.float32)
    ref = jax_forward(model, variables, img, _jit(family), seg_size=HW, train=False)
    with torch.no_grad():
        out = port(torch.from_numpy(img).permute(0, 3, 1, 2), HW).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=_prob_atol(family), rtol=0)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.999


def check_valid_hw_forward(family):
    model, variables, port, _ = family
    img = np.random.RandomState(2).randn(len(EXTENTS), *HW, 3).astype(np.float32)
    vhw = np.array(EXTENTS, np.int32)
    for n, (h, w) in enumerate(vhw):  # zero padding, as the engines feed it
        img[n, h:], img[n, :, w:] = 0.0, 0.0
    ref = jax_forward(model, variables, img, _jit(family), seg_size=None, train=False,
                      valid_hw=jnp.asarray(vhw))
    with torch.no_grad():
        out = port(torch.from_numpy(img).permute(0, 3, 1, 2), valid_hw=torch.from_numpy(vhw))
    assert out.dtype == torch.float32
    out = out.permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda f: f"{f[0]}-{f[1]}")
def family(request):
    """pytest runs every test of one family before it builds the next, so
    one is alive at a time."""
    return build_family(*request.param)


def test_converter_matches_export(family):
    check_converter_matches_export(family)


def test_seg_size_forward_matches_jax(family):
    check_seg_size_forward(family)


def test_valid_hw_forward_matches_jax(family):
    check_valid_hw_forward(family)


@pytest.mark.parametrize("encoder,decoder,fc_dim,stride", [
    ("resnet101", "upernet", 2048, 4),
    ("resnet101dilated", "ppm_deepsup", 2048, 8),
    ("resnext101", "c1", 2048, 32),
])
def test_full_depth_keys_and_shapes(encoder, decoder, fc_dim, stride):
    """Without a forward: the JAX variables' shapes through the converter
    and the exporter give the port module's keys and shapes exactly."""
    model = _jax_model(encoder, decoder, fc_dim)
    label = jnp.zeros((1, HW[0] // stride, HW[1] // stride), jnp.int32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, *HW, 3)), seg_label=label, train=True))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    mine = state_dicts_from_jax(variables, encoder, decoder)
    ref = export_state_dicts(variables, arch_encoder=encoder, arch_decoder=decoder)
    port = (ModelBuilder.build_encoder(encoder, fc_dim, device="cpu").state_dict(),
            ModelBuilder.build_decoder(decoder, fc_dim, encoder_arch=encoder,
                                       device="cpu").state_dict())
    for m, r, p in zip(mine, ref, port):
        r = {k: v for k, v in r.items() if not k.endswith(SYNCBN_ACCUMULATORS)}
        assert sorted(m) == sorted(r) == sorted(p)
        for k in p:
            assert tuple(m[k].shape) == tuple(np.shape(r[k])) == tuple(p[k].shape), k


@pytest.mark.parametrize("encoder", sorted(ENCODER_CHANNELS))
def test_encoder_channels(encoder):
    """Every encoder key builds, and its feature maps have the channels
    that ENCODER_CHANNELS (UPerNet's fpn_inplanes) declares."""
    enc = ModelBuilder.build_encoder(encoder, device="cpu")
    with torch.no_grad():
        feats = enc(torch.zeros(1, 3, 32, 32))
    assert tuple(f.shape[1] for f in feats) == ENCODER_CHANNELS[encoder]


def test_upernet_rejects_a_mismatched_pyramid():
    dec = ModelBuilder.build_decoder("upernet_lite", 2048, encoder_arch="resnet50", device="cpu")
    feats = ModelBuilder.build_encoder("resnet18", device="cpu")(torch.zeros(1, 3, 64, 64))
    with pytest.raises(ValueError, match="fpn_inplanes"):
        dec(feats, (64, 64))


@pytest.mark.parametrize("decoder,fpn_dim", [("upernet", 512), ("upernet_lite", 256)])
def test_upernet_fpn_dim(decoder, fpn_dim):
    dec = ModelBuilder.build_decoder(decoder, 2048, encoder_arch="resnet50", device="cpu")
    assert dec.ppm_last_conv[0].out_channels == fpn_dim
    assert dec.conv_last[1].in_channels == fpn_dim
