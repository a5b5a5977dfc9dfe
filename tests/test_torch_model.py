"""The port's model against the JAX package's model on the CPU.

Seeded random weights (the narrow model's: the port's init carried onto
JAX's variables by the JAX package's converter, ``narrow_jax_model``; the
full-width model's: JAX's init) go through the port's converter
(``state_dicts_from_jax``); the same seeded numpy image goes through both. A narrow model (one block per stage, planes
8/16/32/64, fc_dim 256) in float32 is held to atol 1e-4 on probabilities. The
full-width resnet50dilated + ppm_deepsup at 64x64 uses the tolerance of the
JAX package's own full-width parity tests (atol 2e-2 on probabilities,
argmax agreement > 0.999): random weights are scale-brittle. The logits
call (``seg_size=None``), with and without per-sample ``valid_hw`` on a
padded batch, is held to atol 1e-4 on the logits.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semseg_tpu.config import cfg
from semseg_tpu.models import ModelBuilder as JaxModelBuilder, init_variables
from semseg_tpu.models import decoders as jax_decoders, resnet as jax_resnet
from semseg_tpu.models.convert import convert_checkpoints
from semseg_tpu.models.export import export_state_dicts
from semseg_tpu.models.segmentation import SegmentationModel as JaxSegmentationModel

from semseg_tpu_torch.models import ModelBuilder, SegmentationModel
from semseg_tpu_torch.models.builder import _init
from semseg_tpu_torch.models.convert import SYNCBN_ACCUMULATORS, state_dicts_from_jax
from semseg_tpu_torch.models.decoders import PPMDeepsup
from semseg_tpu_torch.models.resnet import ResNetEncoder

ARCH = dict(arch_encoder="resnet50dilated", arch_decoder="ppm_deepsup")
NARROW = dict(layers=(1, 1, 1, 1), planes=(8, 16, 32, 64))


def _perturb_stats(tree, rng):
    """Non-trivial running statistics, so BN is not the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_stats(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k == "var":
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        else:
            out[k] = v
    return out


def port_weights_for_jax(model, port, arch_encoder, arch_decoder, image_size=(64, 64)):
    """Variables of the JAX model ``model`` (numpy) holding the weights of
    the port's model ``port``: the JAX package's converter for the
    reference's state dicts, whose names the port keeps, over the
    ``jax.eval_shape`` template of ``init_variables``. No JAX init runs
    (its eager run took 6-30 s a model on the CPU)."""
    template = jax.eval_shape(functools.partial(init_variables, model, image_size=image_size))

    def numpy(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    return jax.tree.map(np.asarray, convert_checkpoints(
        dict(template), arch_encoder=arch_encoder, arch_decoder=arch_decoder,
        encoder_state=numpy(port.encoder), decoder_state=numpy(port.decoder)))


def jax_forward(model, variables, img, jit=True, **kw):
    """``model.apply(variables, img, **kw)`` as numpy, under ``jit`` unless
    told not to: on the CPU 3-5x quicker than eager for the narrow model,
    the ResNets and MobileNetV2 at 64x64 (2.6 against 23.3 s for the narrow
    model's logits); HRNetV2 compiles for longer than it runs eagerly (24.4
    against 13.4 s)."""
    fn = functools.partial(model.apply, **kw)
    return np.asarray((jax.jit(fn) if jit else fn)(variables, jnp.asarray(img)))


def narrow_jax_model(seed=0):
    """The narrow JAX model and its variables: the port's narrow model with
    the builder's seeded init, carried over by ``port_weights_for_jax``,
    its running statistics perturbed so that BN is not the identity."""
    model = JaxSegmentationModel(
        encoder=jax_resnet.ResNetEncoder(block="bottleneck", dilate_scale=8, **NARROW),
        decoder=jax_decoders.PPMDeepsup(num_class=150, fc_dim=256),
        deep_sup_scale=0.4,
    )
    port = SegmentationModel(ResNetEncoder(dilate_scale=8, **NARROW),
                             PPMDeepsup(num_class=150, fc_dim=256))
    generator = torch.Generator().manual_seed(seed)
    _init(port.encoder, generator, mode="fan_out", bn_bias=0.0)
    _init(port.decoder, generator, mode="fan_in", bn_bias=1e-4)
    variables = port_weights_for_jax(model, port, **ARCH)
    rng = np.random.RandomState(seed)
    variables = {"params": variables["params"],
                 "batch_stats": _perturb_stats(variables["batch_stats"], rng)}
    return model, variables


def narrow_port_model(variables):
    enc_sd, dec_sd = state_dicts_from_jax(variables, **ARCH)
    encoder = ResNetEncoder(dilate_scale=8, **NARROW)
    decoder = PPMDeepsup(num_class=150, fc_dim=256)
    encoder.load_state_dict(enc_sd, strict=True)
    decoder.load_state_dict(dec_sd, strict=True)
    return SegmentationModel(encoder, decoder).eval().to(memory_format=torch.channels_last)


def _run_port(model, img, seg_size):
    with torch.no_grad():
        out = model(torch.from_numpy(img).permute(0, 3, 1, 2), seg_size)
    return out.permute(0, 2, 3, 1).numpy()


def test_converter_matches_export():
    """Keys and values equal export_state_dicts, minus SyncBN accumulators."""
    _, variables = narrow_jax_model()
    mine = state_dicts_from_jax(variables, **ARCH)
    ref = export_state_dicts(variables, **ARCH)
    for m, r in zip(mine, ref):
        r = {k: v for k, v in r.items() if not k.endswith(SYNCBN_ACCUMULATORS)}
        assert sorted(m) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(m[k].numpy(), r[k], err_msg=k)


def test_port_keys_are_the_reference_keys():
    _, variables = narrow_jax_model()
    enc_sd, dec_sd = state_dicts_from_jax(variables, **ARCH)
    for key in ("conv1.weight", "bn1.running_mean", "layer3.0.conv2.weight",
                "layer3.0.downsample.0.weight", "layer4.0.downsample.1.running_var"):
        assert key in enc_sd
    for key in ("ppm.0.1.weight", "ppm.0.2.running_var", "conv_last.0.weight",
                "conv_last.4.bias", "cbr_deepsup.0.weight", "conv_last_deepsup.weight"):
        assert key in dec_sd


@pytest.mark.parametrize("hw", [(64, 64), (61, 83)])
def test_narrow_model_matches_jax(hw):
    model, variables = narrow_jax_model()
    img = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32)
    ref = jax_forward(model, variables, img, seg_size=hw, train=False)
    out = _run_port(narrow_port_model(variables), img, hw)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("extents", [None, [[64, 80], [41, 57], [9, 13]]],
                         ids=["dense", "valid_hw"])
def test_narrow_logits_match_jax(extents):
    """model(img, valid_hw=...) against model.apply(..., seg_size=None,
    valid_hw=...): f32 logits at decoder resolution, on a padded batch."""
    model, variables = narrow_jax_model()
    rng = np.random.RandomState(6)
    img = rng.randn(3, 64, 80, 3).astype(np.float32)
    vhw = None if extents is None else np.array(extents, np.int32)
    if vhw is not None:
        for n, (h, w) in enumerate(vhw):  # zero padding, as the engines feed it
            img[n, h:], img[n, :, w:] = 0.0, 0.0
    ref = jax_forward(model, variables, img, seg_size=None, train=False,
                      valid_hw=None if vhw is None else jnp.asarray(vhw))
    port = narrow_port_model(variables)
    with torch.no_grad():
        out = port(torch.from_numpy(img).permute(0, 3, 1, 2),
                   valid_hw=None if vhw is None else torch.from_numpy(vhw))
    assert out.dtype == torch.float32 and out.shape == (3, 150, 8, 10)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4, rtol=0)


def test_conv5_stays_channels_last_at_batch_above_one():
    """The pyramid pool takes conv5's NHWC view without a copy, so the
    encoder must keep channels_last from the stem down at N > 1."""
    _, variables = narrow_jax_model()
    port = narrow_port_model(variables)
    img = torch.from_numpy(np.random.RandomState(7).randn(4, 48, 64, 3).astype(np.float32))
    with torch.no_grad():
        feats = port.encoder(img.permute(0, 3, 1, 2))
    for f in feats:
        assert f.is_contiguous(memory_format=torch.channels_last)
    assert feats[-1].permute(0, 2, 3, 1).is_contiguous()


def test_dilation_spec_matches_jax():
    """Stride and dilation of every 3x3 conv after the output-stride-8 surgery."""
    enc = ResNetEncoder(dilate_scale=8)
    got = [(b.conv2.stride[0], b.conv2.dilation[0])
           for stage in (enc.layer3, enc.layer4) for b in stage]
    assert got == [(1, 1)] + [(1, 2)] * 5 + [(1, 2)] + [(1, 4)] * 2
    assert enc.layer3[0].downsample[0].stride == (1, 1)
    assert enc.layer4[0].downsample[0].stride == (1, 1)
    assert jax_resnet.resnet50(dilate_scale=8).stage_dilations() == enc.stage_dilations()


def test_full_width_matches_jax():
    c = cfg.clone()
    jax_model = JaxModelBuilder.build_model(c, dtype=jnp.float32)
    variables = jax.jit(lambda: jax_model.init(  # jit: quicker than eager on the CPU
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), seg_size=(64, 64),
        train=False))()
    img = np.random.RandomState(42).randn(1, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda v, x: jax_model.apply(v, x, seg_size=(64, 64), train=False)
    )(variables, jnp.asarray(img)))

    c.TPU.compute_dtype = "float32"
    model = ModelBuilder.build_model(c, device="cpu")
    enc_sd, dec_sd = state_dicts_from_jax(jax.tree.map(np.asarray, variables), **ARCH)
    # Inference-only init has no deep-supervision branch; keep the port's.
    full_dec = model.decoder.state_dict()
    full_dec.update(dec_sd)
    model.encoder.load_state_dict(enc_sd, strict=True)
    model.decoder.load_state_dict(full_dec, strict=True)
    out = _run_port(model, img, (64, 64))
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=0)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() > 0.999


@pytest.mark.parametrize("which,arch", [
    ("encoder", "resnet152"), ("encoder", "resnext101dilated"), ("decoder", "ppm_lite"),
    ("decoder", "c2"),
])
def test_builder_rejects_unknown_architectures(which, arch):
    """An unknown key raises ValueError, as the JAX builder does."""
    with pytest.raises(ValueError, match="Architecture undefined"):
        getattr(JaxModelBuilder, f"build_{which}")(arch)
    with pytest.raises(ValueError, match="Architecture undefined"):
        getattr(ModelBuilder, f"build_{which}")(arch, device="cpu")


@pytest.mark.parametrize("arch", ["resnet34", "resnet34dilated"])
def test_builder_has_no_resnet34(arch):
    with pytest.raises(NotImplementedError):
        JaxModelBuilder.build_encoder(arch)
    with pytest.raises(NotImplementedError):
        ModelBuilder.build_encoder(arch, device="cpu")


BUILDER_PROBE = r"""
import inspect, torch
from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder
defaults = [inspect.signature(f).parameters["device"].default for f in (
    ModelBuilder.build_encoder, ModelBuilder.build_decoder, ModelBuilder.build_model)]
c = cfg.clone()
c.MODEL.arch_encoder, c.MODEL.arch_decoder, c.MODEL.fc_dim = "mobilenetv2dilated", "c1", 320
model = ModelBuilder.build_model(c, device="cpu")
on = {p.device.type for p in model.parameters()}
try:
    ModelBuilder.build_model(c)
    default_build = "built"
except (AssertionError, RuntimeError) as e:
    default_build = "needs a card" if "CUDA" in str(e) else repr(e)
print(torch.cuda.is_available(), defaults, sorted(on), default_build)
"""


def test_builder_runs_on_the_card_by_default():
    """In a fresh interpreter without CUDA: every builder defaults to
    ``device="cuda"`` (so a default build needs a card), and an explicit
    ``device="cpu"`` builds on the CPU."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "SEMSEG_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", BUILDER_PROBE], env=env, cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == "False ['cuda', 'cuda', 'cuda'] ['cpu'] needs a card"
