"""NYUv2 depth metrics — BTS protocol

(``Painter/eval/nyuv2_depth/eval_with_pngs.py:50-71,170-215``): clamp
predictions to [min, max], validity from GT range, optional eigen crop
(rows 45:471, cols 41:601 for NYU), then per-image silog/log10/abs_rel/
sq_rel/rmse/rmse_log/d1/d2/d3 averaged over images.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    thresh = np.maximum(gt / pred, pred / gt)
    d1 = float((thresh < 1.25).mean())
    d2 = float((thresh < 1.25 ** 2).mean())
    d3 = float((thresh < 1.25 ** 3).mean())
    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    err = np.log(pred) - np.log(gt)
    silog = float(np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2) * 100)
    log10 = float(np.mean(np.abs(np.log10(pred) - np.log10(gt))))
    return {"silog": silog, "log10": log10, "abs_rel": abs_rel,
            "sq_rel": sq_rel, "rmse": rmse, "rmse_log": rmse_log,
            "d1": d1, "d2": d2, "d3": d3}


class DepthEvaluator:
    def __init__(self, min_depth: float = 1e-3, max_depth: float = 10.0,
                 eigen_crop: bool = True, garg_crop: bool = False):
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.eigen_crop = eigen_crop
        self.garg_crop = garg_crop
        self._per_image = []

    def process(self, pred_depth: np.ndarray, gt_depth: np.ndarray):
        """pred/gt in meters, (H, W)."""
        pred = pred_depth.astype(np.float64).copy()
        gt = gt_depth.astype(np.float64)
        pred[pred < self.min_depth] = self.min_depth
        pred[pred > self.max_depth] = self.max_depth
        pred[np.isinf(pred)] = self.max_depth
        pred[np.isnan(pred)] = self.min_depth
        valid = np.logical_and(gt > self.min_depth, gt < self.max_depth)
        if self.eigen_crop or self.garg_crop:
            h, w = gt.shape
            eval_mask = np.zeros_like(valid)
            if self.garg_crop:
                eval_mask[int(0.40810811 * h):int(0.99189189 * h),
                          int(0.03594771 * w):int(0.96405229 * w)] = 1
            else:  # NYU eigen crop
                eval_mask[45:471, 41:601] = 1
            valid = np.logical_and(valid, eval_mask)
        self._per_image.append(compute_errors(gt[valid], pred[valid]))

    def evaluate(self) -> Dict[str, float]:
        keys = self._per_image[0].keys()
        return {k: float(np.mean([m[k] for m in self._per_image]))
                for k in keys}


def depth_png_to_meters(png: np.ndarray, scale: float = 1000.0
                        ) -> np.ndarray:
    """uint16 depth png -> meters (eval_with_pngs.py: pred/1000 for NYU)."""
    return png.astype(np.float64) / scale
