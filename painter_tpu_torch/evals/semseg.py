"""Semantic-segmentation evaluation: palette decode + confusion-matrix

mIoU, replacing detectron2's ``SemSegEvaluator`` underneath
``eval/ade20k_semantic/ADE20kSemSegEvaluatorCustom.py``: painted RGB
predictions are decoded by nearest-palette argmin on the device, GT label
maps accumulate on the host into an (K+1)^2 confusion matrix (last
row/col = ignore), and mIoU/fwIoU/pACC/mACC follow detectron2's formulas.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from painter_tpu_torch.device import resolve_device
from painter_tpu_torch.ops.palette import nearest_color_decode


class SemSegEvaluator:
    """Decodes on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``)."""

    def __init__(self, num_classes: int, palette: np.ndarray,
                 ignore_label: int = 255, dist_type: str = "abs",
                 device=None):
        self.num_classes = num_classes
        self.device = resolve_device(device)
        self.palette = torch.from_numpy(
            np.asarray(palette, np.float32)).to(self.device)
        self.ignore_label = ignore_label
        self.dist_type = dist_type
        self._conf = np.zeros((num_classes + 1, num_classes + 1), np.int64)

    def decode(self, painted_rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) painted prediction -> (H, W) class indices."""
        img = torch.from_numpy(np.asarray(painted_rgb, np.float32))
        return nearest_color_decode(img.to(self.device), self.palette,
                                    self.dist_type).cpu().numpy()

    def process(self, painted_rgb: np.ndarray, gt_labels: np.ndarray):
        pred = self.decode(painted_rgb).astype(np.int64)
        gt = gt_labels.astype(np.int64).copy()
        gt[gt == self.ignore_label] = self.num_classes
        # detectron2 SemSegEvaluator conf-matrix accumulation
        self._conf += np.bincount(
            (self.num_classes + 1) * pred.reshape(-1) + gt.reshape(-1),
            minlength=self._conf.size).reshape(self._conf.shape)

    def evaluate(self) -> Dict[str, float]:
        """detectron2 formulas: mIoU, fwIoU, mACC, pACC."""
        acc = np.full(self.num_classes, np.nan, np.float64)
        iou = np.full(self.num_classes, np.nan, np.float64)
        tp = self._conf.diagonal()[:-1].astype(np.float64)
        pos_gt = self._conf[:-1, :-1].sum(0).astype(np.float64)
        class_weights = pos_gt / max(pos_gt.sum(), 1e-12)
        pos_pred = self._conf[:-1, :-1].sum(1).astype(np.float64)
        acc_valid = pos_gt > 0
        acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
        iou_valid = (pos_gt + pos_pred) > 0
        union = pos_gt + pos_pred - tp
        iou[iou_valid] = tp[iou_valid] / union[iou_valid]
        macc = float(np.sum(acc[acc_valid]) / max(acc_valid.sum(), 1))
        miou = float(np.sum(iou[iou_valid]) / max(iou_valid.sum(), 1))
        fiou = float(np.sum(iou[iou_valid] * class_weights[iou_valid]))
        pacc = float(np.sum(tp) / max(np.sum(pos_gt), 1e-12))
        return {"mIoU": 100 * miou, "fwIoU": 100 * fiou,
                "mACC": 100 * macc, "pACC": 100 * pacc}
