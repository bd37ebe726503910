"""IoU metric: the device-side confusion matrix and the host accumulator.

Counterpart of ``openseg3d_tpu/core/metrics.py``, whose module imports JAX.
``IOUMetric`` keeps the JAX package's numpy logic; with more than one rank
``get_metric`` sums the histogram over the ranks, and a failed collective
raises: it never falls back to this rank's histogram.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..parallel.dist import all_reduce_array, world


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     num_classes: int, valid_mask: torch.Tensor | None = None):
    """[C, C] int64 histogram (rows = gt, cols = pred). Labels outside
    [0, num_classes) and rows where valid_mask is False go to a trash bin
    that is cut off."""
    k = (labels >= 0) & (labels < num_classes)
    if valid_mask is not None:
        k = k & valid_mask
    idx = torch.where(k, labels.long() * num_classes + preds.long(),
                      num_classes * num_classes)
    hist = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return hist[:-1].reshape(num_classes, num_classes)


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    """iou_c = diag / (row_sum + col_sum - diag); NaN for absent classes."""
    hist = np.asarray(hist, dtype=np.float64)
    denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.diag(hist) / denom


class IOUMetric:
    """Host-side accumulator (add / add_hist / get_metric)."""

    def __init__(self, class_names):
        self.class_names = list(class_names)
        self.num_classes = len(self.class_names)
        self.hist = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    def add(self, pred_labels, gt_labels) -> None:
        preds = np.asarray(pred_labels).astype(np.int64).ravel()
        labels = np.asarray(gt_labels).astype(np.int64).ravel()
        k = (labels >= 0) & (labels < self.num_classes)
        bc = np.bincount(self.num_classes * labels[k] + preds[k],
                         minlength=self.num_classes ** 2)
        self.hist += bc[:self.num_classes ** 2].reshape(self.num_classes, self.num_classes)

    def add_hist(self, hist) -> None:
        self.hist += np.asarray(hist, dtype=np.int64)

    def get_metric(self) -> dict:
        """mIoU and per-class IoU of the histogram, summed over the ranks
        (every rank must call this). A histogram that is already global (the
        eval step's) comes out scaled by the world size, which no IoU sees."""
        hist = self.hist
        if world() > 1:
            try:
                hist = all_reduce_array(hist)
            except Exception as e:
                logging.getLogger('openseg3d_tpu_torch').error(
                    'IoU histogram all-reduce failed: %s', e)
                raise
        iou = per_class_iou(hist)
        return {'mIOU': float(np.nanmean(iou)),
                'IOU': {n: float(iou[i]) for i, n in enumerate(self.class_names)}}
