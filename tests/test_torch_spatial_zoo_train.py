"""HRNetV2 and the non-dilated ResNet + UPerNet in training, split by height
(``cli.train TPU.spatial``) and unsplit, on the CPU in float64.

* Two steps of the port's train step with each image's height split in
  row bands against its unsplit step, as ``test_torch_spatial_train_step.py``
  holds the dilated families: ``resnet18`` + ``upernet`` (fc_dim 512,
  output stride 32, labels at stride 4) in 2 and 4 bands over a 128x64
  canvas (its plan cuts at stride 32: 64 rows would hold two bands only),
  and ``hrnetv2`` + ``c1`` in 2 bands over 64x64. Float64 parameters;
  loss and accuracy at each step within ``LOSS_RTOL``, every parameter
  and BN buffer after step 2 within ``STATE_ATOL`` (that file's limits;
  ``STATE_ATOL`` times the tensor's largest magnitude where that exceeds
  1: HRNet's BN momentum of 0.1 takes its running variances to ~140 in two
  steps, where the bands' other order of the statistics' sums moved one
  by 1.1e-9, 8e-12 of its value), ``iter`` advanced twice.
* The unsplit training forward of both pairs, at 64x64, anchored to JAX's
  (HRNetV2's in ``test_torch_hrnet_train.py``, so that the two run side by
  side):
  the port's seeded weights carried onto JAX's variables by the JAX
  package's converter (as ``test_torch_train_step.jax_variables`` does),
  the same seeded float64 batch through ``model(img, seg_label=...)`` and
  its backward and through JAX's ``apply(..., seg_label, train=True,
  mutable=["batch_stats"])`` under ``jax.value_and_grad``: loss and accuracy within rtol 1e-10, every
  parameter gradient and updated BN statistic (HRNet's momentum is 0.1,
  the rest's 0.001) within ``GRAD_RTOL`` (1e-8; measured 2.5e-10) of the
  largest of its tensor, read through the port's converter in float64.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.config import cfg as jax_cfg
from semseg_tpu.models import ModelBuilder as JaxModelBuilder
from semseg_tpu.models.convert import convert_checkpoints

from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.models.convert import state_dicts_from_jax
from semseg_tpu_torch.parallel import create_train_state, dropout_generator, train_step
from test_torch_spatial_train_step import LOSS_RTOL, STATE_ATOL, two_threads  # noqa: F401

LABEL_STRIDE = 4  # segm_downsampling_rate of the HRNetV2 and UPerNet configs
GRAD_RTOL = 1e-8

# (encoder, decoder, fc_dim, canvas, band counts)
PAIRS = {
    "resnet18_upernet": ("resnet18", "upernet", 512, (128, 64), (2, 4)),
    "hrnetv2_c1": ("hrnetv2", "c1", 720, (64, 64), (2,)),
}


def _cfg(base, encoder, decoder, fc_dim):
    c = base.clone()
    c.MODEL.arch_encoder = encoder
    c.MODEL.arch_decoder = decoder
    c.MODEL.fc_dim = fc_dim
    c.TRAIN.num_epoch = 2
    c.TRAIN.epoch_iters = 10
    c.TPU.compute_dtype = "float64"
    return c


def _batch(seed, hw, n=2):
    rng = np.random.RandomState(seed)
    return {
        "img_data": rng.randn(n, hw[0], hw[1], 3).astype(np.float32),
        "seg_label": rng.randint(-1, 150, (n, hw[0] // LABEL_STRIDE, hw[1] // LABEL_STRIDE))
        .astype(np.int32),
    }


def _two_steps(c, model, bands, hw):
    state = create_train_state(c, model, spatial_devices=["cpu"] * bands)
    assert state.spatial == ([torch.device("cpu")] * bands if bands > 1 else None)
    metrics = []
    for i, seed in enumerate((1, 2)):
        b = _batch(seed, hw)
        m = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                       dropout_generator(0, i))
        metrics.append((float(m["loss"]), float(m["acc"])))
    assert state.step == 2
    return metrics, model.state_dict()


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_split_steps_match_the_unsplit_step(pair):
    encoder, decoder, fc_dim, hw, bands = PAIRS[pair]
    c = _cfg(cfg, encoder, decoder, fc_dim)
    model = ModelBuilder.build_model(c, device="cpu", seed=0).to(torch.float64).train()
    ref_metrics, ref = _two_steps(c, copy.deepcopy(model), 1, hw)
    for n in bands:
        metrics, got = _two_steps(c, copy.deepcopy(model), n, hw)
        for (gl, ga), (rl, ra) in zip(metrics, ref_metrics):
            np.testing.assert_allclose(gl, rl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(ga, ra, rtol=LOSS_RTOL)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            v = v.numpy()
            scale = max(1.0, float(np.abs(v).max())) if v.size else 1.0
            np.testing.assert_allclose(got[k].numpy(), v, atol=STATE_ATOL * scale, rtol=0,
                                       err_msg=f"{n} bands: {k}")
    keep = 0.9 if encoder == "hrnetv2" else 0.999  # 1 - the BN momentum
    np.testing.assert_allclose(float(got["encoder.bn1._running_iter"]),
                               (1 * keep + 1) * keep + 1, rtol=1e-12)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _jax_variables(jmodel, model, c, hw):
    """JAX's float64 variables holding the port model's weights (the JAX
    package's converter over the ``jax.eval_shape`` template of its
    init)."""
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    label = jnp.zeros((1, hw[0] // LABEL_STRIDE, hw[1] // LABEL_STRIDE), jnp.int32)
    template = jax.eval_shape(lambda: jmodel.init(
        keys, jnp.zeros((1, *hw, 3), jnp.float32), seg_label=label, train=True))
    variables = convert_checkpoints(
        dict(template), arch_encoder=c.MODEL.arch_encoder, arch_decoder=c.MODEL.arch_decoder,
        encoder_state={k: v.double().numpy() for k, v in model.encoder.state_dict().items()},
        decoder_state={k: v.double().numpy() for k, v in model.decoder.state_dict().items()})
    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def check_training_forward_matches_jax(pair):
    """The second bullet of the module docstring, for ``PAIRS[pair]``
    (under ``jax.enable_x64``)."""
    encoder, decoder, fc_dim, _, _ = PAIRS[pair]
    hw = (64, 64)
    c = _cfg(cfg, encoder, decoder, fc_dim)
    model = ModelBuilder.build_model(c, device="cpu", seed=0)
    jmodel = JaxModelBuilder.build_model(_cfg(jax_cfg, encoder, decoder, fc_dim),
                                         dtype=jnp.float64)
    variables = _jax_variables(jmodel, model, c, hw)
    model = model.to(torch.float64).train()
    b = _batch(3, hw)

    def loss_fn(params):
        (loss, acc), mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(b["img_data"], jnp.float64), seg_label=jnp.asarray(b["seg_label"]),
            train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return loss, (acc, mutated["batch_stats"])

    # On the CPU ResNet-18 + UPerNet's gradient takes 9 s under jit and 87
    # s eagerly; HRNetV2's 51 s eagerly and 131 s under jit.
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    if encoder != "hrnetv2":
        grad_fn = jax.jit(grad_fn)
    (ref_loss, (ref_acc, stats)), grads = grad_fn(variables["params"])
    loss, acc = model(torch.from_numpy(b["img_data"]).permute(0, 3, 1, 2),
                      seg_label=torch.from_numpy(b["seg_label"]).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-10)
    np.testing.assert_allclose(float(acc), float(ref_acc), rtol=1e-10)

    ref = state_dicts_from_jax(jax.tree.map(np.asarray, {"params": grads, "batch_stats": stats}),
                               encoder, decoder, dtype=torch.float64)
    pairs = []
    for sd, module in zip(ref, (model.encoder, model.decoder)):
        params, buffers = dict(module.named_parameters()), dict(module.named_buffers())
        for k, r in sd.items():
            if k in params:
                pairs.append((k, params[k].grad, r, True))
            elif k.endswith(("running_mean", "running_var")):
                pairs.append((k, buffers[k], r, False))
    assert sum(is_grad for *_, is_grad in pairs) == len(list(model.parameters()))
    largest = max(float(r.abs().max()) for _, _, r, is_grad in pairs if is_grad)
    for k, got, r, is_grad in pairs:
        # A gradient that is zero but for rounding (UPerNet's scale-1 PPM
        # conv: its BN normalises a map of N distinct values) is held at
        # 1% of the model's largest gradient.
        scale = max(float(r.abs().max()), 1e-2 * largest if is_grad else 0.0)
        np.testing.assert_allclose(got.numpy(), r.numpy(), atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=k)


def test_unsplit_training_forward_matches_jax(x64):
    check_training_forward_matches_jax("resnet18_upernet")
