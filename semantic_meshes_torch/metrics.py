"""Segmentation metrics: Accuracy, MeanIoU, ConfusionMatrix.

Own copy of the JAX package's `semantic_meshes/metrics.py`, the
replacement for the tfcv.metric classes the reference eval harness uses
(ref: eval-scannet/eval_scannet.py:108-122). Same streaming API:
`update_state(gt_probs, pred_probs)` with (..., classes)
one-hot/probability tensors, `update_state_labels(gt_labels, pred_probs)`
with an integer label image, `result()`, `merge()` and `reset_state()`.
Every metric keeps its (C, C+1) float32 matrix on its `device` (default
"cuda").

Arithmetic as in the JAX package: a frame's counts in float32 (a
`torch.bincount` of gt_class * (C + 1) + pred_class with 0/1 weights;
under 2^24 pixels a frame, so exact in any order and the same on the
card and the CPU), then `cm + counts` in float32, which rounds a cell
past 2^24 counts as the JAX package's does. `torch.argmax` returns the
first maximum, NaN counting as the maximum, as `jnp.argmax` does.

Don't-care semantics:
- ground-truth pixels with sum(gt) <= 0.5 are ignored everywhere (the eval
  encodes unlabeled pixels as all-zero one-hots via label -1).
- predictions with sum(pred) <= 0.5 ("the fusion produced nothing"):
  * dontcare_prediction="error": counted as a wrong prediction (bucketed in
    an internal don't-care column: hits accuracy's denominator and the gt
    class's false negatives).
  * dontcare_prediction="forbidden": assumed absent; pixels are classified
    by argmax regardless.
"""

from __future__ import annotations

import numpy as np
import torch

from .data import resolve_device

DONT_CARE_THRESHOLD = 0.5


def _cm_from_classes(cm, gt_cls, gt_valid, pred, classes_num, pred_error):
    C = classes_num
    pred = pred.reshape(-1, pred.shape[-1])
    pred_cls = torch.argmax(pred, dim=-1)
    if pred_error:
        pred_dc = pred.sum(dim=-1) <= DONT_CARE_THRESHOLD
        pred_cls = torch.where(pred_dc, C, pred_cls)  # don't-care column
    flat = torch.where(gt_valid, gt_cls, 0) * (C + 1) + pred_cls
    # labels >= C fall outside the matrix: dropped, as segment_sum drops
    # out-of-range segments in the JAX package
    keep = gt_valid & (flat < C * (C + 1))
    upd = torch.bincount(
        torch.where(keep, flat, 0), weights=keep.to(torch.float32),
        minlength=C * (C + 1),
    ).reshape(C, C + 1)
    return cm + upd


def _confusion_update(cm, gt, pred, *, classes_num, pred_error):
    gt = gt.reshape(-1, gt.shape[-1])
    gt_valid = gt.sum(dim=-1) > DONT_CARE_THRESHOLD
    gt_cls = torch.argmax(gt, dim=-1)
    return _cm_from_classes(cm, gt_cls, gt_valid, pred, classes_num,
                            pred_error)


def _confusion_update_labels(cm, gt_labels, pred, *, classes_num,
                             pred_error):
    """Label-based update: gt as an integer image (-1 = ignore) instead of a
    one-hot tensor (a (1296, 968, 40) one-hot is 200 MB; the labels are
    5 MB)."""
    gt_labels = gt_labels.reshape(-1).to(torch.int64)
    gt_valid = gt_labels >= 0
    gt_cls = torch.clamp(gt_labels, min=0)
    return _cm_from_classes(cm, gt_cls, gt_valid, pred, classes_num,
                            pred_error)


def _as_tensor(x, device, dtype=None):
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


class ConfusionMatrix:
    name = "confusion_matrix"

    def __init__(self, classes_num, dontcare_prediction="error",
                 device="cuda"):
        if dontcare_prediction not in ("error", "forbidden"):
            raise ValueError(
                f"dontcare_prediction must be 'error' or 'forbidden', got "
                f"{dontcare_prediction!r}"
            )
        self.classes_num = int(classes_num)
        self.pred_error = dontcare_prediction == "error"
        self.device = resolve_device(device)
        self.reset_state()

    def reset_state(self):
        # rows: gt class; cols: pred class + trailing don't-care bucket
        self._cm = torch.zeros(
            (self.classes_num, self.classes_num + 1), dtype=torch.float32,
            device=self.device,
        )

    def update_state(self, gt_probs, pred_probs):
        self._cm = _confusion_update(
            self._cm,
            _as_tensor(gt_probs, self.device, torch.float32),
            _as_tensor(pred_probs, self.device, torch.float32),
            classes_num=self.classes_num,
            pred_error=self.pred_error,
        )

    def update_state_labels(self, gt_labels, pred_probs):
        """Like update_state, but ground truth is an integer label image
        with -1 meaning ignore (40x less data movement than one-hot)."""
        self._cm = _confusion_update_labels(
            self._cm,
            _as_tensor(gt_labels, self.device),
            _as_tensor(pred_probs, self.device, torch.float32),
            classes_num=self.classes_num,
            pred_error=self.pred_error,
        )

    @property
    def full_matrix(self):
        """(C, C+1) including the predicted-don't-care bucket column."""
        return self._cm

    def result(self):
        """(C, C) confusion matrix (don't-care bucket dropped, parity with
        the reference's YAML schema)."""
        return self._cm[:, : self.classes_num]

    # merging partial results across scenes/hosts (graph generator semantics,
    # ref: eval-scannet/create_scannet_eval_graphs.py:49-88)
    def merge(self, other):
        self._cm = self._cm + other._cm.to(self.device)


class Accuracy(ConfusionMatrix):
    name = "accuracy"

    def result(self):
        cm = self._cm
        correct = torch.trace(cm[:, : self.classes_num])
        total = cm.sum()
        return torch.where(total > 0, correct / total,
                           torch.zeros_like(total))


class MeanIoU(ConfusionMatrix):
    name = "mean_iou"

    def result(self):
        cm = self._cm
        C = self.classes_num
        inter = torch.diagonal(cm[:, :C])
        gt_total = cm.sum(dim=1)  # includes don't-care bucket (FN)
        pred_total = cm[:, :C].sum(dim=0)
        union = gt_total + pred_total - inter
        present = gt_total > 0
        iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                          torch.zeros_like(union))
        denom = torch.clamp(present.sum(), min=1)
        return torch.where(present, iou, torch.zeros_like(iou)).sum() / denom


def one_hot_with_ignore(labels, classes_num, device="cuda"):
    """Labels (int, -1 = ignore) -> float32 one-hot on `device` with
    all-zero rows for ignored pixels (the eval's gt encoding, ref:
    eval_scannet.py:234-236)."""
    labels = _as_tensor(labels, resolve_device(device), torch.int64)
    oh = torch.nn.functional.one_hot(torch.clamp(labels, min=0),
                                     classes_num).to(torch.float32)
    return torch.where((labels >= 0)[..., None], oh, torch.zeros_like(oh))


def colorize_classes(class_image, class_to_color, dont_care_mask=None,
                     dont_care_color=(0, 0, 0)):
    """Map a class-index image to RGB uint8 via a palette (script helper)."""
    palette = np.asarray(class_to_color, np.uint8)
    img = palette[_host(class_image)]
    if dont_care_mask is not None:
        img = np.where(
            _host(dont_care_mask)[..., None],
            np.asarray(dont_care_color, np.uint8),
            img,
        )
    return img


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
