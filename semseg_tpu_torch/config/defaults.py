"""Default configuration tree (``semseg_tpu/config/defaults.py``).

The port's own copy, with the same keys as the JAX package's, so that every
``config/*.yaml`` merges into both trees alike. Mirrors the option schema of
the reference framework (``mit_semseg/config/defaults.py:7-97``) so that the
seven shipped ``config/*.yaml`` files load verbatim, with an additional
``TPU`` group holding options that only exist in the TPU-native rebuild (mesh
shape, compute dtype, shape-bucketing lattice for jit-compiled dynamic
resolutions). The port reads these ``TPU`` keys: ``compute_dtype``,
``eval_bucket_step``, ``bucket_step``, ``device_preproc``, ``prefetch``,
``grad_accum``, ``async_checkpoint``, ``data_parallel`` (the training
ranks), ``train_fast_decode`` (the native reduced JPEG decode), ``remat``
(activation checkpointing of the ResNet blocks) and ``spatial`` (values
above 1 raise: height sharding is not ported). ``max_buckets`` and
``compile_cache`` concern XLA only and are not read.

Precedence (same as the reference, ``train.py:235-236``):
    defaults  <  YAML file (``merge_from_file``)  <  CLI opts (``merge_from_list``)
"""

from .cfgnode import CfgNode

_C = CfgNode()

# Output directory for checkpoints / logs.
_C.DIR = "ckpt/ade20k-resnet50dilated-ppm_deepsup"

# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------
_C.DATASET = CfgNode()
_C.DATASET.root_dataset = "./data/"
_C.DATASET.list_train = "./data/training.odgt"
_C.DATASET.list_val = "./data/validation.odgt"
_C.DATASET.num_class = 150
# Multi-scale train/test short-side sizes; a scalar means single fixed size.
_C.DATASET.imgSizes = (300, 375, 450, 525, 600)
# Maximum long-side size.
_C.DATASET.imgMaxSize = 1000
# Images are padded so H and W are multiples of this (8 for dilated output
# stride 8, 32 for UPerNet/HRNet feature pyramids).
_C.DATASET.padding_constant = 8
# Labels are downsampled by this factor to match decoder output stride.
_C.DATASET.segm_downsampling_rate = 8
# Random horizontal flip augmentation during training.
_C.DATASET.random_flip = True

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
_C.MODEL = CfgNode()
_C.MODEL.arch_encoder = "resnet50dilated"
_C.MODEL.arch_decoder = "ppm_deepsup"
# Path to encoder/decoder weights ("" = random / ImageNet init).
_C.MODEL.weights_encoder = ""
_C.MODEL.weights_decoder = ""
# With no explicit weights_encoder, initialize the encoder from the
# published ImageNet backbone (downloaded to ./pretrained + converted) —
# the reference's `pretrained = len(weights) == 0` default (models.py:65).
# Offline hosts warn and fall back to random init. Train CLI only; eval /
# test always load explicit checkpoints.
_C.MODEL.pretrained_encoder = True
# Channel count of the final encoder feature map fed to the decoder.
_C.MODEL.fc_dim = 2048

# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
_C.TRAIN = CfgNode()
_C.TRAIN.batch_size_per_gpu = 2
_C.TRAIN.num_epoch = 20
_C.TRAIN.start_epoch = 0
_C.TRAIN.epoch_iters = 5000

_C.TRAIN.optim = "SGD"
_C.TRAIN.lr_encoder = 0.02
_C.TRAIN.lr_decoder = 0.02
# Polynomial LR decay exponent: lr = base * (1 - iter/max_iters) ** lr_pow.
_C.TRAIN.lr_pow = 0.9
# SGD momentum.
_C.TRAIN.beta1 = 0.9
# L2 decay applied to conv/linear kernels only (not BN params, not biases).
_C.TRAIN.weight_decay = 1e-4
# Deep-supervision auxiliary loss weight.
_C.TRAIN.deep_sup_scale = 0.4
# Freeze batch-norm statistics (use running stats during training).
_C.TRAIN.fix_bn = False

_C.TRAIN.workers = 16
_C.TRAIN.disp_iter = 20
_C.TRAIN.seed = 304

# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------
_C.VAL = CfgNode()
_C.VAL.batch_size = 1
_C.VAL.visualize = False
_C.VAL.checkpoint = "epoch_20.pth"

# ---------------------------------------------------------------------------
# Testing / inference
# ---------------------------------------------------------------------------
_C.TEST = CfgNode()
_C.TEST.batch_size = 1
_C.TEST.checkpoint = "epoch_20.pth"
_C.TEST.result = "./"

# ---------------------------------------------------------------------------
# TPU-native extensions (absent from the reference)
# ---------------------------------------------------------------------------
_C.TPU = CfgNode()
# Compute dtype inside convolutions ("bfloat16" or "float32"). Parameters and
# batch-norm statistics always stay float32.
_C.TPU.compute_dtype = "bfloat16"
# Data-parallel mesh size; 0 = use all visible devices.
_C.TPU.data_parallel = 0
# Hybrid (data x spatial) training mesh: shard each image's HEIGHT across
# this many chips in addition to data parallelism (GSPMD inserts the conv
# halo exchanges; gradient all-reduce and global BN statistics span both
# axes). Devices used = data_groups x spatial; TRAIN.batch_size_per_gpu
# becomes the per-DATA-GROUP batch, so the per-chip activation footprint
# shrinks by ~spatial — the lever for very large inputs or batch-1 latency.
# 1 = pure data parallelism. Single-host only (eval's counterpart is the
# eval CLI's --spatial flag).
_C.TPU.spatial = 1
# TRAIN-time bucket lattice: device batches are zero-padded (ignore-labeled)
# up to a multiple of this (>= padding_constant) to bound recompilations.
# Measured over the real training.odgt (tools/compile_budget.py, 5000-iter
# epoch): step 32 -> ~120 distinct jit shapes with 10-15 first compiles
# landing after the epoch midpoint; step 64 -> ~65 shapes at ~11% padding
# FLOPs (pad is ignore-labeled, so loss/stats are unaffected — the
# reference zero-pads identically); step 128 -> ~24 shapes at ~21% waste.
_C.TPU.bucket_step = 64
# EVAL-time bucket lattice: each pyramid level is RESIZED so H/W land on
# multiples of this (bucket-by-resize — no padded canvas, no receptive-field
# pad-bleed; just a coarser aspect rounding than the reference's
# padding_constant=8). At 8 the protocol is IDENTICAL to the reference
# (measured drift ~5e-5 mIoU) at 441 distinct val-set shapes; 16 trades
# ~4e-4 mIoU / ~2e-3 acc for 246 shapes, 32 trades ~1.2e-3 mIoU for 133.
# Default is the parity-safe 8; raise per-run for throughput
# (eval CLI --bucket-step). See PARITY.md / tests/test_eval_oracle.py.
_C.TPU.eval_bucket_step = 8
# Cap on concurrently cached compiled shapes (informational).
_C.TPU.max_buckets = 64
# Host data-pipeline prefetch depth (device batches in flight).
_C.TPU.prefetch = 2
# Ship TRAIN batches as raw uint8 and normalize on device inside the jitted
# step (4x less host->device traffic + no host normalize pass); equal to
# host normalization within f32 rounding (XLA fuses the arithmetic; pad
# stays zero in normalized space). False restores host-side f32 batches.
_C.TPU.device_preproc = True
# Train-time JPEG decode at a reduced DCT-domain scale (libjpeg
# scale_num/8, the smallest scale that still covers the sample's target
# size). Skips most of the IDCT + color-conversion host work for the
# common downscale case, but the decoded pixels differ slightly from
# full-decode-then-resize (it IS a cheaper resample), so this is an
# opt-in throughput mode for host-bound training — NOT used at eval and
# off by default for pixel-parity with the reference loader. Requires the
# native library with libjpeg; silently falls back to exact decode
# without it.
_C.TPU.train_fast_decode = False
# Rematerialize encoder blocks in the backward pass (jax.checkpoint):
# trades ~30% step FLOPs for activation memory, enabling larger batches.
_C.TPU.remat = False
# Gradient accumulation: each optimizer step averages gradients over this
# many sequential microbatches (lax.scan inside the one jitted step), so the
# effective batch is batch_size_per_gpu x data_devices x grad_accum while
# activation memory stays at one microbatch — the other lever (besides
# remat) for larger-than-HBM batches, with no recompute FLOPs. Torch-loop
# semantics: per-microbatch BN batch statistics, sequential running-stat
# updates. 1 = off.
_C.TPU.grad_accum = 1
# Asynchronous per-epoch checkpointing: the epoch loop pays only an
# HBM-to-HBM state snapshot; the device->host fetch and orbax write run on
# a background thread, overlapping the next epoch (the reference blocks on
# three torch.save calls, train.py:74-89). Off = synchronous save.
_C.TPU.async_checkpoint = True
# Persistent XLA compilation cache shared across processes. The bucket
# lattices cost a 30-55 min one-time compile per fresh process without it
# (PERF_NOTES "compile budget"); with it, every later run deserializes the
# executables. "" = default dir (~/.cache/semseg_tpu/xla_cache/<cpu-fp>,
# namespaced by host CPU features against cross-host SIGILL), "off" =
# disabled, anything else = explicit directory.
_C.TPU.compile_cache = ""

cfg = _C
