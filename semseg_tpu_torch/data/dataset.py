"""ADE20K datasets (host-side, NHWC): the port's own copy of
``semseg_tpu/data/dataset.py``.

* ``TrainDataset`` — aspect-binned training batches (reference
  ``dataset.py:70-203``): a random short side from ``imgSizes`` capped by
  ``imgMaxSize``, a batch canvas rounded up to the ``TPU.bucket_step``
  lattice, a random horizontal flip, labels downsampled by
  ``segm_downsampling_rate`` with round-up padding and the -1 shift; with
  ``raw_transport`` the images stay uint8 with each one's valid (h, w), for
  normalisation on the device.

* ``ValDataset`` / ``TestDataset`` — per-image multi-scale pyramids
  (reference ``dataset.py:206-296``): for each short-side in ``imgSizes``,
  the image is **resized** (not padded — a small aspect distortion, exactly
  like the reference, :232-236) to dimensions rounded up to
  ``padding_constant``, or to the eval bucket lattice. With
  ``device_pyramid_canvas`` a val item whose original fits the canvas has
  no host pyramid: the device-pyramid engine derives it.

Images decode and resize with PIL only. The JAX package's native libjpeg
decode and resizer give the same pixels (it checks them bit for bit against
PIL), so the pyramids and the training batches are equal. Its
``train_fast_decode`` (a reduced-scale JPEG decode) needs that native
decoder and is not ported (ROADMAP item 14).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
from PIL import Image

from .transforms import (
    img_transform,
    imresize,
    round2nearest_multiple,
    scale_for,
    segm_transform,
)


def _effective_lattice(bucket_step, padding_constant: int) -> int:
    """Smallest lattice >= bucket_step that keeps padding_constant alignment."""
    if not bucket_step:
        return padding_constant
    if bucket_step % padding_constant == 0:
        return bucket_step
    return ((bucket_step - 1) // padding_constant + 1) * padding_constant


def _decode_rgb(path: str) -> np.ndarray:
    """Decode an image file to an RGB uint8 (H, W, 3) array."""
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def parse_odgt(odgt, max_sample=-1, start_idx=-1, end_idx=-1) -> List[dict]:
    """Parse a .odgt manifest (one JSON record per line, dataset.py:38-51)."""
    if isinstance(odgt, list):
        samples = list(odgt)
    else:
        with open(odgt) as f:
            samples = [json.loads(line.rstrip()) for line in f if line.strip()]
    if max_sample > 0:
        samples = samples[:max_sample]
    if start_idx >= 0 and end_idx >= 0:
        samples = samples[start_idx:end_idx]
    assert samples, "empty sample list"
    return samples


def sample_odgt_shapes(odgt_path: str, n: int, seed: int = 0):
    """(H, W) original shapes sampled without replacement from an odgt
    manifest — the benchmarks' shared shape distribution (a single
    synthetic shape fills every bucket batch perfectly and flatters
    MS-protocol numbers; shapes must come from the real val manifest)."""
    recs = parse_odgt(odgt_path)
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(recs), n, replace=False)
    return [(recs[i]["height"], recs[i]["width"]) for i in idx]


class PyramidBuilder:
    """In-memory multi-scale pyramid transforms — no manifest required.

    The dataset classes inherit this; a caller that segments images outside
    any manifest constructs it directly from ``cfg.DATASET``.
    """

    def __init__(self, opt, *, bucket_step: Optional[int] = None):
        self.imgSizes = opt.imgSizes
        self.imgMaxSize = opt.imgMaxSize
        self.padding_constant = opt.padding_constant
        # Eval-time shape bucketing BY RESIZE: pyramid levels are resized
        # directly to dims rounded up to this lattice (instead of the
        # reference's padding_constant, dataset.py:232-236), which bounds the
        # distinct shapes without a padded canvas: zero pad bleeds through
        # the dilated-conv receptive field and the PPM global pooling, while
        # a slightly coarser aspect distortion is the approximation the
        # reference already makes.
        self.eval_bucket_step = bucket_step

    def multi_scale_pyramid(self, img, *, raw: bool = False) -> List[np.ndarray]:
        """Per-scale resized copies, each (1, H, W, 3).

        ``img``: RGB uint8 array or PIL image.
        ``raw=False``: normalized float32 (reference parity).
        ``raw=True``: uint8 — normalization happens on the device inside the
        inference engine (4x smaller host→device transfer).
        """
        arr = np.asarray(img, dtype=np.uint8)
        ori_height, ori_width = arr.shape[:2]
        sizes = (
            self.imgSizes
            if isinstance(self.imgSizes, (list, tuple))
            else (self.imgSizes,)
        )
        # The lattice must preserve the architecture's alignment constraint:
        # UPerNet/HRNet configs pad to 32 (padding_constant), so a finer
        # requested bucket_step rounds up to it.
        rounding = _effective_lattice(self.eval_bucket_step, self.padding_constant)
        out = []
        for short_size in sizes:
            scale = scale_for(ori_height, ori_width, short_size, self.imgMaxSize)
            target_h = round2nearest_multiple(int(ori_height * scale), rounding)
            target_w = round2nearest_multiple(int(ori_width * scale), rounding)
            resized = np.asarray(
                imresize(Image.fromarray(arr), (target_w, target_h), interp="bilinear"),
                dtype=np.uint8,
            )
            out.append(resized[None] if raw else img_transform(resized)[None])
        return out


class BaseDataset(PyramidBuilder):
    def __init__(self, odgt, opt, *, bucket_step: Optional[int] = None, **kwargs):
        super().__init__(opt, bucket_step=bucket_step)
        self.list_sample = parse_odgt(odgt, **kwargs)
        self.num_sample = len(self.list_sample)


class TrainDataset(BaseDataset):
    def __init__(self, root_dataset, odgt, opt, batch_per_gpu=1, *, seed=304,
                 bucket_step: Optional[int] = None, raw_transport: bool = False,
                 fast_decode: bool = False, **kwargs):
        if fast_decode:
            raise NotImplementedError(
                "TPU.train_fast_decode needs the native JPEG decoder, which the "
                "port has not yet (ROADMAP item 14); set it False"
            )
        super().__init__(odgt, opt, **kwargs)
        self.root_dataset = root_dataset
        self.segm_downsampling_rate = opt.segm_downsampling_rate
        self.batch_per_gpu = batch_per_gpu
        self.raw_transport = raw_transport
        # The batch canvas lattice: bucket_step rounded up to keep the
        # architecture's padding_constant alignment, as the eval path does.
        self.bucket_step = _effective_lattice(
            max(bucket_step or 0, self.padding_constant), self.padding_constant
        )
        # A label canvas of batch_h // rate must hold each sample's
        # ceil-rounded label block.
        assert self.padding_constant % self.segm_downsampling_rate == 0, (
            self.padding_constant, self.segm_downsampling_rate)
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(self.num_sample)
        self._cursor = 0
        self._bins = ([], [])  # h > w | h <= w

    def __len__(self):
        return self.num_sample

    def _next_record(self):
        rec = self.list_sample[self._order[self._cursor]]
        self._cursor += 1
        if self._cursor >= self.num_sample:
            self._cursor = 0
            self._order = self.rng.permutation(self.num_sample)
        return rec

    def _get_sub_batch(self):
        """Aspect-ratio-grouped batch assembly (dataset.py:85-108)."""
        while True:
            rec = self._next_record()
            bin_idx = 0 if rec["height"] > rec["width"] else 1
            self._bins[bin_idx].append(rec)
            if len(self._bins[bin_idx]) == self.batch_per_gpu:
                batch = list(self._bins[bin_idx])
                self._bins[bin_idx].clear()
                return batch

    def next_batch(self) -> dict:
        """One batch: ``img_data`` (N, H, W, 3) float32 (uint8 with
        ``raw_transport``, plus ``img_valid_hw`` (N, 2) int32) and
        ``seg_label`` (N, H / rate, W / rate) int32, -1 for void and pad."""
        records = self._get_sub_batch()
        sizes = self.imgSizes if isinstance(self.imgSizes, (list, tuple)) else (self.imgSizes,)
        short_size = int(self.rng.choice(sizes))

        widths = np.zeros(self.batch_per_gpu, np.int32)
        heights = np.zeros(self.batch_per_gpu, np.int32)
        for i, rec in enumerate(records):
            s = scale_for(rec["height"], rec["width"], short_size, self.imgMaxSize)
            widths[i] = int(rec["width"] * s)
            heights[i] = int(rec["height"] * s)

        batch_w = int(round2nearest_multiple(widths.max(), self.bucket_step))
        batch_h = int(round2nearest_multiple(heights.max(), self.bucket_step))
        rate = self.segm_downsampling_rate
        images = np.zeros((self.batch_per_gpu, batch_h, batch_w, 3),
                          np.uint8 if self.raw_transport else np.float32)
        segms = np.full((self.batch_per_gpu, batch_h // rate, batch_w // rate), -1, np.int32)

        for i, rec in enumerate(records):
            flip = bool(self.rng.integers(2))
            h_i, w_i = int(heights[i]), int(widths[i])
            img = Image.open(os.path.join(self.root_dataset, rec["fpath_img"])).convert("RGB")
            segm = Image.open(os.path.join(self.root_dataset, rec["fpath_segm"]))
            assert segm.mode == "L"
            assert img.size == segm.size
            if flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                segm = segm.transpose(Image.FLIP_LEFT_RIGHT)
            img = imresize(img, (w_i, h_i), interp="bilinear")
            segm = imresize(segm, (w_i, h_i), interp="nearest")

            # Label downsample with round-up padding (dataset.py:176-184):
            # pad with 0, which the -1 shift turns into ignore.
            sr_w = round2nearest_multiple(segm.size[0], rate)
            sr_h = round2nearest_multiple(segm.size[1], rate)
            segm_rounded = Image.new("L", (sr_w, sr_h), 0)
            segm_rounded.paste(segm, (0, 0))
            segm = imresize(segm_rounded, (sr_w // rate, sr_h // rate), "nearest")

            arr = np.asarray(img, np.uint8) if self.raw_transport else img_transform(img)
            lab = segm_transform(segm)
            images[i, : arr.shape[0], : arr.shape[1]] = arr
            segms[i, : lab.shape[0], : lab.shape[1]] = lab

        batch = {"img_data": images, "seg_label": segms}
        if self.raw_transport:
            batch["img_valid_hw"] = np.stack([heights, widths], axis=1)
        return batch

    def __iter__(self):
        while True:
            yield self.next_batch()


class ValDataset(BaseDataset):
    def __init__(self, root_dataset, odgt, opt, *, device_preprocess=False,
                 device_pyramid_canvas=None, **kwargs):
        super().__init__(odgt, opt, **kwargs)
        self.root_dataset = root_dataset
        self.device_preprocess = device_preprocess
        # Device-pyramid mode: an original that fits this (H, W) canvas
        # skips the host pyramid (``img_data`` is empty; the engine derives
        # every level from ``img_ori``); an oversized one keeps it.
        self.device_pyramid_canvas = device_pyramid_canvas

    def __len__(self):
        return self.num_sample

    def __getitem__(self, index) -> dict:
        rec = self.list_sample[index]
        img = _decode_rgb(os.path.join(self.root_dataset, rec["fpath_img"]))
        segm = Image.open(os.path.join(self.root_dataset, rec["fpath_segm"]))
        assert segm.mode == "L"
        assert img.shape[:2] == (segm.size[1], segm.size[0])
        canvas = self.device_pyramid_canvas
        skip_pyramid = (canvas is not None and img.shape[0] <= canvas[0]
                        and img.shape[1] <= canvas[1])
        return {
            "img_ori": img,
            "img_data": ([] if skip_pyramid
                         else self.multi_scale_pyramid(img, raw=self.device_preprocess)),
            "seg_label": segm_transform(segm)[None],
            "info": rec["fpath_img"],
        }


class TestDataset(BaseDataset):
    __test__ = False  # not a pytest class

    def __init__(self, odgt, opt, *, device_preprocess=False, **kwargs):
        super().__init__(odgt, opt, **kwargs)
        self.device_preprocess = device_preprocess

    def __len__(self):
        return self.num_sample

    def __getitem__(self, index) -> dict:
        rec = self.list_sample[index]
        img = _decode_rgb(rec["fpath_img"])
        return {
            "img_ori": img,
            "img_data": self.multi_scale_pyramid(img, raw=self.device_preprocess),
            "info": rec["fpath_img"],
        }
