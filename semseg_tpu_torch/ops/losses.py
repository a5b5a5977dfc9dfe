"""Segmentation losses and the training accuracy (``semseg_tpu/ops/losses.py``).

The reference trains with ``NLLLoss(ignore_index=-1)`` over log-softmax maps
plus a deep-supervision term, and tracks ``pixel_acc``. Here, as in the JAX
package, the loss is one masked softmax cross-entropy over the logits, in
float32. Logits are NCHW (classes on axis 1), labels (N, H, W) integers
with ``ignore_index`` for void.

The mean is ``sum / max(valid pixels, 1)``, so a batch whose labels are all
void has loss 0. (``F.cross_entropy(ignore_index=-1)`` returns NaN there.)
The ``*_sums`` forms give the numerator and denominator apart, so that a
rank of a data-parallel run can take the global batch's mean
(``models.segmentation``).
"""

from __future__ import annotations

import torch

from .dtypes import acc_dtype


def _masked_sums(per_pixel, valid):
    return torch.where(valid, per_pixel, 0.0).sum(), valid.sum().to(per_pixel.dtype)


def masked_mean(num, den):
    return num / torch.clamp(den, min=1.0)


def _pick(x, labels, valid):
    """``x[n, labels[n, h, w], h, w]``, with void pixels reading class 0."""
    safe = torch.where(valid, labels, 0).long()
    return x.gather(1, safe.unsqueeze(1)).squeeze(1)


def nll_loss(log_probs, labels, *, ignore_index=-1):
    """Mean NLL over the non-void pixels of (N, C, H, W) log-probabilities."""
    log_probs = log_probs.to(acc_dtype(log_probs.dtype))
    valid = labels != ignore_index
    return masked_mean(*_masked_sums(-_pick(log_probs, labels, valid), valid))


def softmax_cross_entropy_sums(logits, labels, *, ignore_index=-1):
    """(summed loss, valid pixels) of log-softmax + NLL over (N, C, H, W)
    logits, both in the accumulation dtype."""
    logits = logits.to(acc_dtype(logits.dtype))
    valid = labels != ignore_index
    lse = torch.logsumexp(logits, dim=1)
    return _masked_sums(lse - _pick(logits, labels, valid), valid)


def softmax_cross_entropy_with_ignore(logits, labels, *, ignore_index=-1):
    """log-softmax + NLL over (N, C, H, W) logits in one expression."""
    return masked_mean(*softmax_cross_entropy_sums(logits, labels, ignore_index=ignore_index))


def pixel_accuracy_sums(scores, labels, *, ignore_index=-1):
    """(correct, valid) pixel counts of the argmax over axis 1."""
    adt = acc_dtype(scores.dtype)
    valid = (labels != ignore_index).to(adt)
    correct = (scores.argmax(dim=1) == labels).to(adt) * valid
    return correct.sum(), valid.sum()


def pixel_accuracy(scores, labels, *, ignore_index=-1):
    """Share of non-void pixels whose argmax over axis 1 is the label, with
    the reference's ``+1e-10`` denominator guard."""
    correct, valid = pixel_accuracy_sums(scores, labels, ignore_index=ignore_index)
    return correct / (valid + 1e-10)
