"""COCO keypoint evaluation: painted-heatmap decode + OKS AP.

Behavioral contract from ``eval/mmpose_custom/model/top_down.py:163-260``
and the offline test config
(``eval/mmpose_custom/configs/coco_256x192_test_offline.py:75-109``):
- painted 256x192 crops encode R = heatmap magnitude, (G, B) = keypoint
  class color (17 colors on a 5x5 lattice + black background);
- decode: classify each pixel by nearest (G, B) color (L1), heatmap_k =
  mask_k * R / 255;
- flip test: decode the *_flip crop, swap left/right channels, mirror
  horizontally, shift one pixel right (shift_heatmap=True), average;
- keypoints: mmpose 'default' post-process — per-joint argmax + 0.25 px
  shift toward the higher neighbor, mapped back to the original image
  through the bbox center/scale affine;
- scoring: mean visible-joint heatmap value x bbox score; OKS soft-NMS
  unavailable -> oks_nms with thr 0.9 (soft_nms=False in the config);
- metric: COCO keypoint AP over OKS thresholds .50:.05:.95 (implemented
  natively; the package does not depend on pycocotools).

Host numpy, as in the JAX package's ``evals/pose.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from painter_tpu_torch.ops.palette import pose_gb_palette

COCO_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                   (13, 14), (15, 16))
COCO_KPT_SIGMAS = np.array([
    .026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
    .107, .107, .087, .087, .089, .089])


def decode_painted_heatmaps(images: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) painted crops in [0,255] -> (B, 17, H, W) heatmaps."""
    images = images.astype(np.float32)
    gb_colors = np.concatenate(
        [pose_gb_palette().astype(np.float32), np.zeros((1, 2), np.float32)])
    gb = images[..., 1:]  # (B, H, W, 2)
    dist = np.abs(gb[:, None] - gb_colors[None, :, None, None, :]).sum(-1)
    cls = dist.argmin(1)  # (B, H, W) in [0..17]
    r = images[..., 0]
    heatmaps = np.stack([(cls == k) * r for k in range(17)], axis=1)
    return heatmaps / 255.0


def flip_back(heatmaps: np.ndarray,
              flip_pairs=COCO_FLIP_PAIRS) -> np.ndarray:
    """mmpose flip_back: swap paired channels, mirror width."""
    out = heatmaps.copy()
    for a, b in flip_pairs:
        out[:, [a, b]] = out[:, [b, a]]
    return out[..., ::-1]


def merge_flip_test(heatmaps: np.ndarray, flipped_heatmaps: np.ndarray,
                    shift_heatmap: bool = True) -> np.ndarray:
    flipped = flip_back(flipped_heatmaps)
    if shift_heatmap:
        flipped[:, :, :, 1:] = flipped[:, :, :, :-1]
    return (heatmaps + flipped) / 2.0


def _taylor_default(heatmap: np.ndarray, px: int, py: int
                    ) -> Tuple[float, float]:
    """mmpose 'default' quarter-pixel shift toward the higher neighbor.

    One joint gate for BOTH axes (``1 < px < W-1 and 1 < py < H-1``), as
    in mmpose's ``_get_max_preds`` default post-process — border
    keypoints get no shift on either axis."""
    h, w = heatmap.shape
    if 1 < px < w - 1 and 1 < py < h - 1:
        dx = 0.25 * np.sign(heatmap[py, px + 1] - heatmap[py, px - 1])
        dy = 0.25 * np.sign(heatmap[py + 1, px] - heatmap[py - 1, px])
        return float(dx), float(dy)
    return 0.0, 0.0


def keypoints_from_heatmaps(heatmaps: np.ndarray, centers: np.ndarray,
                            scales: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, K, H, W) -> keypoints (B, K, 2) in image coords + maxvals.

    mmpose top-down protocol: argmax + default post-process, then
    transform through the bbox affine: x_img = x * scale*200/size +
    center - scale*200/2."""
    b, k, h, w = heatmaps.shape
    coords = np.zeros((b, k, 2), np.float32)
    maxvals = np.zeros((b, k, 1), np.float32)
    for i in range(b):
        for j in range(k):
            hm = heatmaps[i, j]
            idx = hm.argmax()
            py, px = divmod(int(idx), w)
            val = hm[py, px]
            maxvals[i, j, 0] = val
            if val > 0:
                dx, dy = _taylor_default(hm, px, py)
                coords[i, j] = (px + dx, py + dy)
            else:
                coords[i, j] = (-1, -1)
    # transform to original coordinates
    out = np.zeros_like(coords)
    for i in range(b):
        scale = scales[i] * 200.0
        out[i, :, 0] = coords[i, :, 0] * scale[0] / w \
            + centers[i][0] - scale[0] * 0.5
        out[i, :, 1] = coords[i, :, 1] * scale[1] / h \
            + centers[i][1] - scale[1] * 0.5
    return out, maxvals


def compute_oks(pred: np.ndarray, gt: np.ndarray, gt_vis: np.ndarray,
                area: float, sigmas: np.ndarray = COCO_KPT_SIGMAS,
                bbox: Optional[Sequence[float]] = None) -> float:
    """OKS between one predicted and one GT pose (pycocotools computeOks).

    When the GT has no visible keypoint (a crowd region), pycocotools
    falls back to distance outside the doubled GT bbox; with no bbox
    given either, the OKS is 0."""
    vis = gt_vis > 0
    var = (2 * sigmas) ** 2
    denom = 2 * var * (area + np.spacing(1))
    if vis.any():
        d2 = ((pred[:, :2] - gt[:, :2]) ** 2).sum(-1)
        return float(np.exp(-d2 / denom)[vis].mean())
    if bbox is None:
        return 0.0
    x0, y0 = bbox[0] - bbox[2], bbox[1] - bbox[3]
    x1, y1 = bbox[0] + 2 * bbox[2], bbox[1] + 2 * bbox[3]
    dx = np.maximum(0, x0 - pred[:, 0]) + np.maximum(0, pred[:, 0] - x1)
    dy = np.maximum(0, y0 - pred[:, 1]) + np.maximum(0, pred[:, 1] - y1)
    return float(np.exp(-(dx ** 2 + dy ** 2) / denom).mean())


def oks_nms(poses: List[Dict], thr: float = 0.9) -> List[Dict]:
    """Greedy OKS NMS over {keypoints (17,3), score, area} dicts."""
    if not poses:
        return poses
    order = np.argsort([-p["score"] for p in poses], kind="stable")
    keep = []
    suppressed = np.zeros(len(poses), bool)
    for ii in order:
        if suppressed[ii]:
            continue
        keep.append(poses[ii])
        for jj in order:
            if jj == ii or suppressed[jj]:
                continue
            oks = compute_oks(poses[jj]["keypoints"],
                              poses[ii]["keypoints"],
                              poses[ii]["keypoints"][:, 2],
                              poses[ii]["area"])
            if oks > thr:
                suppressed[jj] = True
    return keep


# COCOeval keypoint area ranges (cocoeval.py Params.setKpParams)
KPT_AREA_RNGS = {"all": (0.0, 1e10),
                 "medium": (32.0 ** 2, 96.0 ** 2),
                 "large": (96.0 ** 2, 1e10)}


def _det_area(kpts: np.ndarray) -> float:
    """COCO.loadRes keypoint-result area: tight keypoint bbox area."""
    x, y = kpts[:, 0], kpts[:, 1]
    return float((x.max() - x.min()) * (y.max() - y.min()))


class KeypointAPEvaluator:
    """COCO keypoint AP (OKS .50:.05:.95), self-contained.

    Follows pycocotools COCOeval semantics: per-image greedy matching in
    score order with crowd GTs re-matchable, ignore propagation (a
    detection matched to an iscrowd / zero-visible GT is neither TP nor
    FP), area-range filtering (all/medium/large), 101-point interpolated
    precision, maxDets=20."""

    def __init__(self, oks_thrs: Optional[Sequence[float]] = None,
                 max_dets: int = 20):
        self.oks_thrs = (np.arange(0.5, 1.0, 0.05)
                         if oks_thrs is None else np.asarray(oks_thrs))
        self.max_dets = max_dets
        # per image: (dets sorted by score, gts)
        self._images: List[Tuple[List[Dict], List[Dict]]] = []

    def add_image(self, detections: List[Dict], gts: List[Dict]) -> None:
        """detections: {keypoints (17,3), score, [area]}; gts:

        {keypoints (17,3), area, [iscrowd], [bbox]}. keypoints[:, 2] is
        visibility for GTs."""
        dets = sorted(detections, key=lambda d: -d["score"])[:self.max_dets]
        self._images.append((
            [{"keypoints": np.asarray(d["keypoints"], np.float32),
              "score": float(d["score"]),
              "area": float(d.get("area",
                                  _det_area(np.asarray(d["keypoints"]))))}
             for d in dets],
            [{"keypoints": np.asarray(g["keypoints"], np.float32),
              "area": float(g["area"]),
              "iscrowd": int(g.get("iscrowd", 0)),
              "bbox": g.get("bbox")} for g in gts]))

    def _evaluate_img(self, dets, gts, thr: float, arng) -> Tuple[
            List[float], List[bool], List[bool], int]:
        """One (image, OKS thr, area range) match — cocoeval.evaluateImg.

        Returns (scores, tp, ignore) per det + the non-ignored GT count."""
        # base ignore: iscrowd or no visible keypoint; plus area range
        gt_ig = [g["iscrowd"] == 1
                 or not (g["keypoints"][:, 2] > 0).any()
                 or not (arng[0] <= g["area"] <= arng[1]) for g in gts]
        order = sorted(range(len(gts)), key=lambda i: gt_ig[i])
        gtm = [0] * len(gts)
        scores, tp, dt_ig = [], [], []
        for d in dets:
            best_oks = min(thr, 1 - 1e-10)
            m = -1
            for gi in order:
                g = gts[gi]
                if gtm[gi] and not g["iscrowd"]:
                    continue
                # past non-ignored matchable gts; can't improve
                if m > -1 and not gt_ig[m] and gt_ig[gi]:
                    break
                oks = compute_oks(d["keypoints"], g["keypoints"],
                                  g["keypoints"][:, 2], g["area"],
                                  bbox=g["bbox"])
                if oks < best_oks:
                    continue
                best_oks = oks
                m = gi
            if m > -1:
                gtm[m] = 1
                ig = gt_ig[m]
            else:
                # unmatched det outside the area range is ignored
                ig = not (arng[0] <= d["area"] <= arng[1])
            scores.append(d["score"])
            tp.append(m > -1 and not gt_ig[m])
            dt_ig.append(bool(ig))
        return scores, tp, dt_ig, sum(not i for i in gt_ig)

    def _ap(self, thr: float, arng) -> float:
        scores, tps, igs = [], [], []
        n_gt = 0
        for dets, gts in self._images:
            s, t, ig, ng = self._evaluate_img(dets, gts, thr, arng)
            scores += s
            tps += t
            igs += ig
            n_gt += ng
        if n_gt == 0:
            return -1.0  # COCOeval reports -1 for empty categories
        order = np.argsort(-np.asarray(scores), kind="mergesort")
        tp_arr = np.asarray(tps, bool)[order]
        ig_arr = np.asarray(igs, bool)[order]
        tp_arr = tp_arr[~ig_arr]
        ctp = np.cumsum(tp_arr)
        cfp = np.cumsum(~tp_arr)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        rec_thrs = np.linspace(0, 1, 101)
        idx = np.searchsorted(recall, rec_thrs, side="left")
        prec_at = np.array([precision[i] if i < len(precision) else 0.0
                            for i in idx])
        return float(prec_at.mean())

    def evaluate(self) -> Dict[str, float]:
        out = {}
        for name, arng in KPT_AREA_RNGS.items():
            aps = [self._ap(float(t), arng) for t in self.oks_thrs]
            valid = [a for a in aps if a >= 0]
            mean_ap = float(np.mean(valid)) if valid else -0.01
            if name == "all":
                ap_at = {round(float(t), 2): a
                         for t, a in zip(self.oks_thrs, aps)}
                out["AP"] = 100 * mean_ap
                out["AP50"] = 100 * max(ap_at.get(0.5, 0.0), 0.0)
                out["AP75"] = 100 * max(ap_at.get(0.75, 0.0), 0.0)
            else:
                out[f"AP_{name}"] = 100 * mean_ap
        return out
