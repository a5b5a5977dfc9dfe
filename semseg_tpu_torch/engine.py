"""Multi-scale inference engines (``semseg_tpu/engine.py``).

* ``InferenceEngine(exact=True)`` is the reference computation op for op:
  for every level of a host pyramid, the full forward with the in-model
  bilinear resize to label size and softmax, then the mean over levels and
  the argmax.
* ``InferenceEngine(exact=False)`` is the bucketed per-image engine: each
  level is padded to its bucket on the step lattice (the dataset resizes
  levels onto it, so usually nothing is padded), normalized on the device
  with the padding zeroed, and run to logits at decoder resolution with
  pad-aware pooling. The valid region is cropped, resized to label size and
  soft-maxed on the device (the JAX package does that last step on the host
  with cv2). With ``spatial_devices`` (``cli.eval --spatial``, JAX's
  ``spatial_mesh``) each level's height is split across those devices, one
  band each (``parallel/spatial.py``), and the logits gathered on the
  first.
* ``BatchedInferenceEngine`` batches same-bucket levels ACROSS images,
  optionally folding under-filled buckets into larger ones, and keeps one
  f32 score canvas per image on the device: resize, softmax and the sum
  over levels run there, and only argmax maps or packed metric vectors come
  back.
* ``DevicePyramidEngine`` takes the original images instead of host
  pyramids and derives every level on the device (Pillow's antialiased
  bilinear filter as two batched f32 products), then runs the batched
  engine's chunk loop.

Host arrays go up in one coalesced copy per chunk or window (pinned, on a
side stream for a card, see ``upload.Upload``). Canvases are (H, W, num_class), as in the JAX
package; model tensors are NCHW and channels_last in memory.

The batched engines' phases run in spans (``utils.spans``) on the calling
thread: ``semseg::eval.plan`` (level plans, windows, bucket grouping and
packing, the schedule), ``semseg::eval.stage`` (input put on the device
from the calling thread), ``semseg::eval.wait`` (the chunk loop waiting on
the uploader thread), ``semseg::eval.model`` (the network on a chunk),
``semseg::levels`` (the levels derived on the device),
``semseg::eval.epilogue`` (a chunk's canvases, resizes and softmaxes, and
each finished image's metrics or argmax) and ``semseg::eval.fetch`` (the
results to the host).
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Sequence

import numpy as np
import torch

from semseg_tpu_torch.data.dataset import _effective_lattice
from semseg_tpu_torch.data.transforms import (
    MEAN,
    STD,
    round2nearest_multiple as _round_up,
    scale_for,
)
from semseg_tpu_torch.ops.preproc import normalize_255, normalize_u8_masked, valid_mask
from semseg_tpu_torch.ops.resize import resize_bilinear
from semseg_tpu_torch.ops.resize_dynamic import pil_resize_matrix, resize_matrix
from semseg_tpu_torch.models.segmentation import band_base, banded_logits, check_banded
from semseg_tpu_torch.parallel.spatial import BandPlan, Bands, gather, split_rows
from semseg_tpu_torch.upload import Upload
from semseg_tpu_torch.utils.spans import span


def _fetch_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def band_device(device) -> torch.device:
    """A spatial band's device, which must exist: raises for a card index
    past the visible ones or when no card is visible."""
    d = torch.device(device)
    if d.type == "cuda":
        count = torch.cuda.device_count()
        index = torch.cuda.current_device() if d.index is None and count else d.index
        if not count or index >= count:
            raise ValueError(f"spatial band device {device}: {count} CUDA card(s) visible")
        return torch.device("cuda", index)
    if d.type != "cpu":
        raise ValueError(f"spatial band device {device}: not a CUDA card or the CPU")
    return d


class InferenceEngine:
    """The exact and the bucketed per-image engines (module docstring).

    ``spatial_devices``: the bucketed engine splits each level's height
    across these devices (a device may repeat: its bands are then slices),
    as the JAX engine does over its ``spatial_mesh``; ``device`` is then the
    first of them, which holds ``model`` and runs the exact engine and the
    post-processing. The model is copied to each other device once.
    """

    def __init__(self, model, *, num_class: int = 150, device="cuda",
                 exact: bool = True, output_stride: int = 8,
                 bucket_step: int = 64, padding_constant: int = 1,
                 fetch_dtype=None, spatial_devices=None):
        self.model = model
        self.num_class = num_class
        self.device = torch.device(device)
        self.spatial_devices = None
        if spatial_devices:
            self.spatial_devices = [band_device(d) for d in spatial_devices]
            self.device = self.spatial_devices[0]
            if not exact:
                check_banded(model)
                # One copy of the model per distinct device, as the JAX
                # engine replicates its variables over the mesh.
                self._replicas = {self.device: model}
                for d in self.spatial_devices:
                    if d not in self._replicas:
                        self._replicas[d] = copy.deepcopy(model).to(d)
        self.exact = exact
        self.output_stride = output_stride
        # The dataset's lattice rule, so level shapes keep the model's
        # padding_constant alignment.
        self.bucket_step = _effective_lattice(
            max(bucket_step or 0, padding_constant), padding_constant
        )
        # Dtype the logits are rounded to before post-processing, as the
        # JAX package rounds them for its device→host fetch.
        self.fetch_dtype = _fetch_dtype(fetch_dtype)

    def _bucket_key(self, h: int, w: int):
        """Lattice bucket of an (h, w) task."""
        return _round_up(h, self.bucket_step), _round_up(w, self.bucket_step)

    # -- forwards ------------------------------------------------------------
    def _to_device(self, img: np.ndarray) -> torch.Tensor:
        """(1, H, W, 3) host image → normalized NCHW channels_last tensor."""
        if img.dtype == np.uint8:
            img = ((img.astype(np.float32) / 255.0) - MEAN) / STD
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device)
        # An NHWC tensor seen as NCHW is channels_last without a copy.
        return x.permute(0, 3, 1, 2)

    def _logits_raw_fn(self, img_u8: torch.Tensor, hw: torch.Tensor,
                       to_fetch: bool = True) -> torch.Tensor:
        """uint8 (N, Hp, Wp, 3) canvas → (N, C, hp, wp) logits: normalize and
        zero the padding on the device, then the forward, whose PPM pools
        bin each sample's valid extent ``hw`` ((N, 2) int32) only. Rounded
        to ``fetch_dtype`` only when they go to the host (``to_fetch``); the
        on-device epilogue keeps float32."""
        with span("semseg::eval.model"):
            x = normalize_u8_masked(img_u8, hw[:, 0], hw[:, 1])
            out = self.model(x.permute(0, 3, 1, 2), valid_hw=hw)
            return out.to(self.fetch_dtype) if to_fetch else out

    def _logits_spatial(self, img_u8: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
        """``_logits_raw_fn`` with the level's height split across
        ``spatial_devices``: each band's rows of the uint8 canvas go to its
        device and are normalized there (the valid mask at the band's row
        offset), the banded forward runs, and the logit bands are gathered
        on the first device and rounded to ``fetch_dtype``."""
        hp, wp = img_u8.shape[1:3]
        plan = BandPlan(hp, len(self.spatial_devices), band_base(self.model))
        devices = self.spatial_devices[:plan.count]
        hws = [hw.to(d, non_blocking=True) for d in devices]
        img = split_rows(img_u8.permute(0, 3, 1, 2), plan, devices)
        x = Bands([normalize_u8_masked(p.permute(0, 2, 3, 1), v[:, 0] - r0, v[:, 1])
                   .permute(0, 3, 1, 2) for (r0, _), p, v in zip(img.rows, img.parts, hws)],
                  plan, 1)
        logits = banded_logits([self._replicas[d] for d in devices], x, hws, (hp, wp))
        return gather(logits, self.device).to(self.fetch_dtype)

    def _postprocess(self, logits: torch.Tensor, h: int, w: int, seg_size) -> torch.Tensor:
        """(C, hp, wp) logits → (C, H, W) f32 probabilities at ``seg_size``:
        crop the valid region, bilinear resize (align_corners=False),
        softmax over classes. Runs where ``logits`` lies."""
        os_ = self.output_stride
        x = logits[:, : -(-h // os_), : -(-w // os_)].to(torch.float32)
        x = resize_bilinear(x[None], tuple(seg_size))[0]
        return torch.softmax(x, dim=0)

    # -- public API ------------------------------------------------------------
    @torch.inference_mode()
    def mean_scores(self, pyramid: Sequence[np.ndarray], seg_size) -> torch.Tensor:
        """(num_class, H, W) float32 softmax scores averaged over the pyramid,
        on the device."""
        acc = torch.zeros((self.num_class, *seg_size), dtype=torch.float32,
                          device=self.device)
        if self.exact:
            # With spatial_devices this runs unsplit on the first of them, as
            # the JAX engine's exact path runs replicated over its mesh
            # (semseg_tpu/engine.py:239-242 leaves the float image
            # uncommitted).
            for img in pyramid:
                acc += self.model(self._to_device(img), tuple(seg_size))[0]
            return acc / len(pyramid)

        # Pad every level to its bucket and send the pyramid in one copy.
        padded, hws = [], []
        for img in pyramid:
            if img.dtype != np.uint8:
                raise TypeError("the bucketed engine takes raw uint8 pyramids")
            h, w = img.shape[1], img.shape[2]
            ph, pw = self._bucket_key(h, w)
            if (ph, pw) != (h, w):
                img = np.pad(img, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)))
            padded.append(np.ascontiguousarray(img))
            hws.append(np.array([[h, w]], np.int32))
        dev = Upload.of(padded + hws, self.device).send().get()
        n = len(pyramid)
        forward = self._logits_raw_fn if self.spatial_devices is None else self._logits_spatial
        for img, hw, (h, w) in zip(dev[:n], dev[n:], (a[0] for a in hws)):
            acc += self._postprocess(forward(img, hw)[0], int(h), int(w), seg_size)
        return acc / n

    def scores_for_pyramid(self, pyramid: Sequence[np.ndarray], seg_size) -> np.ndarray:
        """(H, W, num_class) float32 scores (mean over scales), on the host."""
        return self.mean_scores(pyramid, seg_size).permute(1, 2, 0).cpu().numpy()

    def predict(self, pyramid: Sequence[np.ndarray], seg_size) -> np.ndarray:
        """Argmax class map at ``seg_size`` (reference eval.py:74-75)."""
        return self.mean_scores(pyramid, seg_size).argmax(0).cpu().numpy()


def output_stride_for(cfg) -> int:
    """The decoder's training-mode output stride (= label downsample rate)."""
    return cfg.DATASET.segm_downsampling_rate


class BatchedInferenceEngine(InferenceEngine):
    """Throughput engine: batches same-bucket pyramid levels across images.

    Numerically the per-image bucketed engine: BN runs on running
    statistics and every task keeps its own valid-region mask and pooling
    extent.
    """

    def __init__(self, *args, batch_size: int = 4, canvas_budget_mb: int = 4096,
                 pack_buckets: bool = False, pack_max_area_ratio: float = 1.3,
                 pack_max_pad_px: int = 32, **kw):
        kw.setdefault("exact", False)
        super().__init__(*args, **kw)
        self.batch_size = batch_size
        # Fold under-filled bucket groups into larger buckets when the
        # padded-area cost model says so, capped in area ratio and in pad
        # per dimension (conv-border bleed grows with the absolute pad).
        self.pack_buckets = pack_buckets
        self.pack_max_area_ratio = pack_max_area_ratio
        self.pack_max_pad_px = pack_max_pad_px
        # Bound on simultaneously live per-image f32 score canvases.
        self.canvas_budget_bytes = canvas_budget_mb * (1 << 20)
        self._upload_stream = (torch.cuda.Stream(device=self.device)
                               if self.device.type == "cuda" else None)

    # -- on-device post-processing ------------------------------------------
    def _accum_fn(self, acc, logits, hv, wv, H, W):
        """acc += softmax(bilinear_resize(logits[:, :hv, :wv] → (H, W))), in
        place, inside (H, W) only.

        ``acc``: (Hp, Wp, C) f32 canvas; ``logits``: (C, hp, wp), one sample
        of an NCHW channels_last batch. The resize is two products with
        dense resize matrices, as the JAX package computes it; rows past
        (H, W) are not computed at all instead of masked.
        """
        x = logits.permute(1, 2, 0).to(torch.float32)
        hp, wp, _ = x.shape
        m_h = resize_matrix(H, hp, H, hv, device=x.device)
        m_w = resize_matrix(W, wp, W, wv, device=x.device)
        r = torch.einsum("ik,kwc->iwc", m_h, x)
        r = torch.einsum("jw,iwc->ijc", m_w, r)
        acc[:H, :W] += torch.softmax(r, dim=-1)
        return acc

    def _argmax_fn(self, acc):
        return acc.argmax(-1).to(torch.uint8)

    def _metrics_fn(self, acc, label_u8):
        """Pixel accuracy and per-class intersection/union on the device.

        ``utils.accuracy`` / ``intersectionAndUnion`` semantics: 255 is void
        (the reference's -1, canvas padding included) and counts in neither
        histogram. Returns one packed f32 vector ``[acc_sum, pix_sum,
        inter(C), union(C)]``; the counts are exact below 2^24 pixels.
        Histograms are scatter-adds into C+1 bins (the last one takes what
        is dropped), which need no host sync.
        """
        C = self.num_class
        pred = acc.argmax(-1)
        label = label_u8.to(torch.int64)
        valid = label_u8 != 255
        hit = valid & (pred == label)

        def hist(idx, keep):
            idx = torch.where(keep, idx, C).reshape(-1)
            out = torch.zeros(C + 1, dtype=torch.int64, device=idx.device)
            return out.scatter_add_(0, idx, torch.ones_like(idx))[:C]

        inter = hist(label, hit)
        union = hist(pred, valid) + hist(label, valid & (label < C)) - inter
        return torch.cat([torch.stack([hit.sum(), valid.sum()]), inter, union]).to(torch.float32)

    # -- grouping ------------------------------------------------------------
    def _group_by_bucket(self, items):
        """Group (item, level) tasks by padded bucket shape."""
        groups: dict = {}
        for i, pyramid in enumerate(items):
            for arr in pyramid:
                if arr.dtype != np.uint8:
                    raise TypeError("the batched engine takes raw uint8 pyramids")
                h, w = arr.shape[1], arr.shape[2]
                groups.setdefault(self._bucket_key(h, w), []).append((i, arr, h, w))
        return self._pack_groups(groups)

    def _window_groups(self, items, window):
        """The levels of a window's items grouped by bucket, packed."""
        in_window = set(window)
        return self._group_by_bucket(
            [items[i] if i in in_window else [] for i in range(len(items))])

    def _pack_groups(self, groups):
        """Fold under-filled bucket groups into LARGER buckets when the
        batch-fill gain beats the extra padded area.

        A group of n tasks at bucket (h, w) costs ``ceil(n/B) * h * w``.
        Greedy smallest-area-first: fold a group into whichever covering
        bucket (both dims >=, within the area and pad caps) lowers the total
        cost most.
        """
        if not self.pack_buckets or len(groups) <= 1:
            return groups
        B = self.batch_size

        def cost(key, n):
            return -(-n // B) * key[0] * key[1]

        for k in sorted(groups, key=lambda k: k[0] * k[1]):
            if k not in groups:
                continue
            n_k = len(groups[k])
            best, best_delta = None, 0
            for k2 in groups:
                if k2 == k or k2[0] < k[0] or k2[1] < k[1]:
                    continue
                if k2[0] * k2[1] > self.pack_max_area_ratio * k[0] * k[1]:
                    continue
                if k2[0] - k[0] > self.pack_max_pad_px or k2[1] - k[1] > self.pack_max_pad_px:
                    continue
                n2 = len(groups[k2])
                delta = cost(k2, n2 + n_k) - cost(k2, n2) - cost(k, n_k)
                if delta < best_delta:
                    best, best_delta = k2, delta
            if best is not None:
                groups[best].extend(groups.pop(k))
        return groups

    def _canvas_windows(self, seg_sizes, item_indices):
        """Partition items into windows whose summed f32 canvas bytes stay
        under ``canvas_budget_bytes`` (every window holds >= 1 item)."""
        windows, cur, cur_bytes = [], [], 0
        for i in item_indices:
            ch, cw = self._bucket_key(*seg_sizes[i])
            b = ch * cw * self.num_class * 4
            if cur and cur_bytes + b > self.canvas_budget_bytes:
                windows.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += b
        if cur:
            windows.append(cur)
        return windows

    def _void_label_canvas(self, label, H, W):
        """uint8 label canvas at the score-canvas shape: 255 = void (the
        reference's -1); padding beyond (H, W) stays void."""
        lab = np.full(self._bucket_key(H, W), 255, np.uint8)
        lab[:H, :W] = np.where(label < 0, 255, label).astype(np.uint8)
        return lab

    # -- chunk loop ----------------------------------------------------------
    def _stage_host_chunk(self, key, padded_chunk):
        """Assemble one padded chunk in a host buffer and start its upload
        (one copy, on the side stream for a card); no forward."""
        ph, pw = key
        up = Upload([((self.batch_size, ph, pw, 3), np.uint8),
                      ((self.batch_size, 2), np.int32)], self.device)
        batch, hw = up.arrays
        for j, (_, arr, h, w) in enumerate(padded_chunk):
            batch[j, :h, :w] = arr[0]
            hw[j] = (h, w)
        return up.send(self._upload_stream)

    def _forward_host_chunk(self, key, padded_chunk, staged=None, *, to_fetch=False):
        """Forward one padded chunk; returns (logits, per-entry valid (h, w)).

        ``staged``: the chunk's upload from ``_stage_host_chunk``; None =
        stage it here.
        """
        with span("semseg::eval.stage"):
            if staged is None:
                staged = self._stage_host_chunk(key, padded_chunk)
            img, hw = staged.get()
        logits = self._logits_raw_fn(img, hw, to_fetch)
        return logits, [(h, w) for (_, _, h, w) in padded_chunk]

    def _schedule(self, groups):
        """Chunks in dispatch order: (key, tasks, padded). Each bucket's last
        chunk is padded to the full batch by repeating its last task, so a
        bucket always runs at one shape; surplus outputs are dropped."""
        schedule = []
        for key, tasks in groups.items():
            for lo in range(0, len(tasks), self.batch_size):
                chunk = tasks[lo:lo + self.batch_size]
                padded = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
                schedule.append((key, chunk, padded))
        return schedule

    def _accumulate_on_device(self, seg_sizes, groups, n_levels,
                              forward_chunk, finalize, stage_chunk):
        """Shared chunk loop: batched forwards into per-image score canvases.

        ``groups``: {shape_key: [task, ...]}, ``task[0]`` the item index;
        ``n_levels``: {item_idx: level count}; ``stage_chunk(key, padded)``
        assembles and uploads a chunk, on an uploader thread at most two
        chunks ahead of the forwards; ``forward_chunk(key, padded, staged)``
        returns (logits, per-entry valid (h, w)); ``finalize(item_idx,
        canvas)`` runs once an image's last level is in, and its canvas is
        dropped. Returns {item_idx: finalize result}.
        """
        os_ = self.output_stride
        accs: dict = {}
        remaining = dict(n_levels)
        out: dict = {}
        with span("semseg::eval.plan"):
            schedule = self._schedule(groups)

        staged_q: queue.Queue = queue.Queue(maxsize=2)
        # If the consumer dies, the uploader must not stay blocked in put()
        # holding staged buffers: the stop event and the drain on exit let
        # it finish.
        stop = threading.Event()

        def _bounded_put(item):
            while not stop.is_set():
                try:
                    staged_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def _uploader():
            try:
                for key, _, padded in schedule:
                    if stop.is_set():
                        return
                    _bounded_put(stage_chunk(key, padded))
            except BaseException as e:  # handed to the consumer, which raises it
                _bounded_put(e)

        uploader = threading.Thread(target=_uploader, name="chunk-uploader", daemon=True)
        uploader.start()
        try:
            for key, chunk, padded in schedule:
                with span("semseg::eval.wait"):
                    staged = staged_q.get()
                if isinstance(staged, BaseException):
                    raise staged
                logits, hws = forward_chunk(key, padded, staged)
                with span("semseg::eval.epilogue"):
                    for j, task in enumerate(chunk):
                        item_idx = task[0]
                        h, w = hws[j]
                        H, W = seg_sizes[item_idx]
                        if item_idx not in accs:
                            # Canvas at the lattice shape: its padding is
                            # never written and is void in the label.
                            accs[item_idx] = torch.zeros(
                                (*self._bucket_key(H, W), self.num_class),
                                dtype=torch.float32, device=self.device,
                            )
                        self._accum_fn(accs[item_idx], logits[j],
                                       -(-h // os_), -(-w // os_), H, W)
                        remaining[item_idx] -= 1
                        if remaining[item_idx] == 0:
                            out[item_idx] = finalize(item_idx, accs.pop(item_idx))
        finally:
            stop.set()
            while True:  # drop staged buffers
                try:
                    staged_q.get_nowait()
                except queue.Empty:
                    break
            uploader.join(timeout=5.0)
        return out

    def _windowed_accumulate(self, items, seg_sizes, finalize, prepare_window=None):
        """Canvas-budget-windowed chunk loop over host pyramids: group each
        window's levels by bucket, forward and accumulate, finalize per
        item. ``prepare_window(window)`` runs before the window's forwards."""
        out: dict = {}
        with span("semseg::eval.plan"):
            windows = self._canvas_windows(seg_sizes, range(len(items)))
        for window in windows:
            if prepare_window is not None:
                prepare_window(window)
            with span("semseg::eval.plan"):
                groups = self._window_groups(items, window)
            out.update(self._accumulate_on_device(
                seg_sizes, groups, {i: len(items[i]) for i in window},
                self._forward_host_chunk, finalize, self._stage_host_chunk,
            ))
        return out

    # -- public API ------------------------------------------------------------
    @torch.inference_mode()
    def batched_metrics(self, items, labels):
        """Multi-scale predict and metrics on the device.

        ``items``: pyramids of (1, H_s, W_s, 3) uint8 levels; ``labels``:
        per-item (H, W) int arrays (-1 = void). Returns a list of (acc_sum,
        pix_sum, intersection, union) numpy tuples, fetched in one copy.
        """
        if self.num_class >= 255:
            raise ValueError("uint8 label transport needs num_class < 255")
        if not items:
            return []
        if not all(len(p) for p in items):
            raise ValueError("every item needs >= 1 level")
        seg_sizes = [lab.shape for lab in labels]
        finalize, prepare_window = self._metrics_finalizer(seg_sizes, labels)
        out = self._windowed_accumulate(items, seg_sizes, finalize,
                                        prepare_window=prepare_window)
        return self._fetch_packed_metrics(out, len(items))

    def _metrics_finalizer(self, seg_sizes, labels):
        """Returns (finalize, prepare_window): each window's uint8 label
        canvases go up in one copy."""
        dev_labels: dict = {}

        def prepare_window(window):
            with span("semseg::eval.stage"):
                host = [self._void_label_canvas(labels[i], *seg_sizes[i]) for i in window]
                for i, d in zip(window, Upload.of(host, self.device).send().get()):
                    dev_labels[i] = d

        def finalize(item_idx, acc):
            return self._metrics_fn(acc, dev_labels.pop(item_idx))

        return finalize, prepare_window

    def _fetch_packed_metrics(self, out, n_items):
        """Stack every per-image metric vector and fetch in one copy."""
        with span("semseg::eval.fetch"):
            packed = torch.stack([out[i] for i in range(n_items)]).cpu().numpy()
        C = self.num_class
        return [(row[0], row[1], row[2:2 + C], row[2 + C:2 + 2 * C]) for row in packed]

    def _device_postproc_predict(self, items, seg_sizes):
        """Resize, softmax, sum and argmax on the device; the uint8 maps come
        back in one copy."""
        if self.num_class >= 255:
            raise ValueError("uint8 prediction maps need num_class < 255")
        preds = self._windowed_accumulate(
            items, seg_sizes,
            lambda i, acc: self._argmax_fn(acc)[:seg_sizes[i][0], :seg_sizes[i][1]],
        )
        with span("semseg::eval.fetch"):
            flat = torch.cat([preds[i].reshape(-1) for i in range(len(items))]).cpu().numpy()
        res, lo = [], 0
        for H, W in seg_sizes:
            res.append(flat[lo:lo + H * W].reshape(H, W).astype(np.int64))
            lo += H * W
        return res

    @torch.inference_mode()
    def batched_predict(self, items, seg_sizes, *, device_postproc=True):
        """Class maps for a list of multi-scale pyramids.

        ``items``: pyramids of (1, H_s, W_s, 3) uint8 levels; ``seg_sizes``:
        per-item (H, W). Returns (H, W) int argmax maps in item order. With
        ``device_postproc=False`` each chunk's logits come to the host in one
        copy, in ``fetch_dtype``, and are post-processed and summed there.
        """
        n_items = len(items)
        if not n_items:
            return []
        if not all(len(p) for p in items):
            raise ValueError("every item needs >= 1 level")
        if device_postproc:
            return self._device_postproc_predict(items, seg_sizes)

        # Host canvases, windowed by the same budget as the device path.
        res = [None] * n_items
        with span("semseg::eval.plan"):
            windows = self._canvas_windows(seg_sizes, range(n_items))
        for window in windows:
            with span("semseg::eval.plan"):
                schedule = self._schedule(self._window_groups(items, window))
            accs = {i: torch.zeros((self.num_class, *seg_sizes[i])) for i in window}
            for key, chunk, padded in schedule:
                logits = self._forward_host_chunk(key, padded, to_fetch=True)[0]
                with span("semseg::eval.fetch"):
                    logits = logits.cpu()
                with span("semseg::eval.epilogue"):
                    for row, (i, _, h, w) in zip(logits, chunk):
                        accs[i] += self._postprocess(row, h, w, seg_sizes[i])
            with span("semseg::eval.epilogue"):
                for i in window:
                    res[i] = (accs[i] / len(items[i])).argmax(0).numpy()
        return res


class DevicePyramidEngine(BatchedInferenceEngine):
    """Derives the multi-scale pyramid on the device from each original.

    The host uploads every original once, uint8, padded to the ``ori_step``
    lattice, with its label canvas: one pinned copy per window of at most
    ``2 * batch_size`` images, issued on the side stream before the
    previous window's forwards. Each level is one antialiased resample of
    the original with Pillow's triangle filter (two batched float32
    products with ``pil_resize_matrix``), then the normalization and the
    zero mask of the host-pyramid path; so the levels differ from the host
    pyramid's only by Pillow's 8-bit fixed-point rounding. The tasks
    ``(item, th, tw)`` go through the batched engine's grouping, packing
    and chunk loop; only each chunk's extents are uploaded per chunk.

    The products run over the chunk's largest lattice-padded original, not
    over all of ``ori_canvas``: the matrices are zero past each original's
    true size, so the result is the same. ``ori_canvas`` (rounded up to the
    lattice) only decides which originals take this path (``fits``).
    """

    def __init__(self, *args, img_sizes, img_max_size, ori_step: int = 64,
                 ori_canvas=(1088, 1600), **kw):
        super().__init__(*args, **kw)
        # A scalar imgSizes is a single-scale config.
        self.img_sizes = (tuple(img_sizes) if isinstance(img_sizes, (list, tuple))
                          else (img_sizes,))
        self.img_max_size = img_max_size
        self.ori_step = ori_step
        # Originals are padded up to the lattice, so the canvas sits on it
        # too: an image that fits by its raw size then fits padded.
        self.ori_canvas = (_round_up(int(ori_canvas[0]), ori_step),
                           _round_up(int(ori_canvas[1]), ori_step))

    def level_plan(self, ori_h: int, ori_w: int):
        """Per-scale (target_h, target_w): ``ValDataset.multi_scale_pyramid``'s
        shapes on the engine's lattice."""
        plan = []
        for s in self.img_sizes:
            sc = scale_for(ori_h, ori_w, s, self.img_max_size)
            plan.append((_round_up(int(ori_h * sc), self.bucket_step),
                         _round_up(int(ori_w * sc), self.bucket_step)))
        return plan

    def fits(self, ori_h: int, ori_w: int) -> bool:
        return ori_h <= self.ori_canvas[0] and ori_w <= self.ori_canvas[1]

    def _windows(self, seg_sizes):
        """Canvas-budget windows cut to ``2 * batch_size`` items: each
        window's upload overlaps the previous window's forwards, and two
        batches of images keep the cross-image level batching."""
        n = max(2 * self.batch_size, 1)
        return [w[lo:lo + n] for w in self._canvas_windows(seg_sizes, range(len(seg_sizes)))
                for lo in range(0, len(w), n)]

    def _level_groups(self, window, plans):
        """A window's ``(item, th, tw)`` tasks grouped by bucket, packed."""
        groups: dict = {}
        for i in window:
            for th, tw in plans[i]:
                groups.setdefault(self._bucket_key(th, tw), []).append((i, th, tw))
        return self._pack_groups(groups)

    def _levels(self, canvases, ohw, thw, lh: int, lw: int) -> torch.Tensor:
        """(B, Hc, Wc, 3) uint8 originals with true sizes ``ohw`` → (B, lh,
        lw, 3) normalized float32 levels of sizes ``thw``, zero beyond them
        ((B, 2) int32 on the device), in the span ``semseg::levels``."""
        with span("semseg::levels"):
            _, hc, wc, _ = canvases.shape
            m_h = pil_resize_matrix(lh, hc, thw[:, 0], ohw[:, 0], device=canvases.device)
            m_w = pil_resize_matrix(lw, wc, thw[:, 1], ohw[:, 1], device=canvases.device)
            x = torch.einsum("boh,bhwc->bowc", m_h, canvases.to(torch.float32))
            x = torch.einsum("bpw,bowc->bopc", m_w, x)
            mask = valid_mask((len(thw), lh, lw), thw[:, 0], thw[:, 1], batch_dims=1,
                              device=canvases.device)
            return torch.where(mask[..., None], normalize_255(x), 0.0)

    def _upload_window(self, window, originals, labels, seg_sizes) -> Upload:
        """Start one window's upload: each original zero-padded to the
        lattice, then each void-label canvas, in one pinned buffer."""
        with span("semseg::eval.stage"):
            specs = []
            for i in window:
                h, w = originals[i].shape[:2]
                if not self.fits(h, w):
                    raise ValueError(f"original {h}x{w} exceeds the canvas {self.ori_canvas}")
                specs.append(((_round_up(h, self.ori_step), _round_up(w, self.ori_step), 3),
                              np.uint8))
            specs += [(self._bucket_key(*seg_sizes[i]), np.uint8) for i in window]
            up = Upload(specs, self.device)
            for dst, i in zip(up.arrays, window):
                h, w = originals[i].shape[:2]
                dst[:h, :w] = originals[i]
            for dst, i in zip(up.arrays[len(window):], window):
                dst[...] = self._void_label_canvas(labels[i], *seg_sizes[i])
            return up.send(self._upload_stream)

    @torch.inference_mode()
    def batched_metrics_from_originals(self, originals, labels):
        """Multi-scale metrics from original images.

        ``originals``: (H, W, 3) uint8 arrays that ``fits``; ``labels``:
        matching (H, W) int arrays (-1 = void). Returns the packed
        (acc_sum, pix_sum, intersection, union) tuples of
        ``batched_metrics``.
        """
        if self.num_class >= 255:
            raise ValueError("uint8 label transport needs num_class < 255")
        if not originals:
            return []
        with span("semseg::eval.plan"):
            seg_sizes = [lab.shape for lab in labels]
            plans = [self.level_plan(*ori.shape[:2]) for ori in originals]
            if not all(plans):
                raise ValueError("every image needs >= 1 level")
            windows = self._windows(seg_sizes)
        oris: dict = {}
        dev_labels: dict = {}

        def stage_chunk(key, padded):
            up = Upload([((self.batch_size, 2), np.int32)] * 2, self.device)
            ohw, thw = up.arrays
            for j, (i, th, tw) in enumerate(padded):
                ohw[j] = originals[i].shape[:2]
                thw[j] = (th, tw)
            return up.send(self._upload_stream)

        def forward_chunk(key, padded, staged):
            with span("semseg::eval.stage"):
                ohw, thw = staged.get()
                hc = max(oris[i].shape[0] for i, _, _ in padded)
                wc = max(oris[i].shape[1] for i, _, _ in padded)
                canvases = torch.zeros((len(padded), hc, wc, 3), dtype=torch.uint8,
                                       device=self.device)
                for j, (i, _, _) in enumerate(padded):
                    canvases[j, :oris[i].shape[0], :oris[i].shape[1]] = oris[i]
            # The forward pools over each task's extent; logits stay f32.
            x = self._levels(canvases, ohw, thw, *key).permute(0, 3, 1, 2)
            with span("semseg::eval.model"):
                logits = self.model(x.contiguous(memory_format=torch.channels_last),
                                    valid_hw=thw)
            return logits, [(th, tw) for _, th, tw in padded]

        def finalize(item_idx, acc):
            return self._metrics_fn(acc, dev_labels.pop(item_idx))

        out: dict = {}
        upload = self._upload_window(windows[0], originals, labels, seg_sizes)
        for k, window in enumerate(windows):
            # The compute stream waits for this window's copy; the next
            # window's copy is issued before this window's forwards.
            with span("semseg::eval.stage"):
                views = upload.get()
                for i, ori, lab in zip(window, views[:len(window)], views[len(window):]):
                    oris[i], dev_labels[i] = ori, lab
            if k + 1 < len(windows):
                upload = self._upload_window(windows[k + 1], originals, labels, seg_sizes)
            with span("semseg::eval.plan"):
                groups = self._level_groups(window, plans)
            out.update(self._accumulate_on_device(
                seg_sizes, groups, {i: len(plans[i]) for i in window},
                forward_chunk, finalize, stage_chunk,
            ))
            for i in window:
                del oris[i]
        return self._fetch_packed_metrics(out, len(originals))
