"""Native COCO-style instance (segm) AP + box soft-NMS + class-aware NMS.

The reference's class-aware instance evaluation
(``eval/coco_panoptic/COCOInstSegEvaluatorCustom.py``) merges the
class-agnostic instance decode with semantic-vote classes, optionally
applies class-wise NMS (matrix or mmcv ``soft_nms``), and scores with
detectron2's COCOEvaluator (pycocotools COCOeval). The package depends on
none of detectron2, mmcv or pycocotools, so the pieces are self-contained
here (host numpy, as in the JAX package's ``evals/coco_ap.py``):

- :func:`soft_nms` — mmcv's linear soft-NMS on boxes;
- :func:`classwise_nms` — the ``with_nms`` branch
  (COCOInstSegEvaluatorCustom.py:120-166): matrix NMS on masks or
  soft-NMS on class-offset boxes, then top-100;
- :class:`InstanceAPEvaluator` — COCOeval 'segm' semantics: per-category
  greedy matching in score order (crowd GTs re-matchable, ignore
  propagation), mask IoU with the crowd intersection-over-det-area rule,
  area ranges small/medium/large, 101-point interpolated precision,
  maxDets 100, AP averaged over categories with GT present.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SEGM_AREA_RNGS = {"all": (0.0, 1e10),
                  "small": (0.0, 32.0 ** 2),
                  "medium": (32.0 ** 2, 96.0 ** 2),
                  "large": (96.0 ** 2, 1e10)}


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) -> (N, 4) xyxy tight boxes (empty mask -> zeros)."""
    boxes = np.zeros((len(masks), 4), np.float32)
    for i, m in enumerate(np.asarray(masks) > 0):
        ys, xs = np.nonzero(m)
        if len(xs):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes


def soft_nms(boxes: np.ndarray, scores: np.ndarray,
             iou_threshold: float = 0.3, sigma: float = 0.5,
             min_score: float = 1e-3, method: str = "linear"
             ) -> Tuple[np.ndarray, np.ndarray]:
    """mmcv.ops.soft_nms semantics: iteratively pick the top-scoring box
    and decay the scores of overlapping others (linear: *(1-iou) when
    iou > thr; gaussian: *exp(-iou^2/sigma)). Returns (dets (K, 5) with
    updated scores, keep indices in pick order)."""
    boxes = np.asarray(boxes, np.float32).copy()
    scores = np.asarray(scores, np.float32).copy()
    idxs = np.arange(len(scores))
    keep, out = [], []
    areas = (boxes[:, 2] - boxes[:, 0]).clip(0) \
        * (boxes[:, 3] - boxes[:, 1]).clip(0)
    alive = np.ones(len(scores), bool)
    while alive.any():
        live = np.nonzero(alive)[0]
        top = live[scores[live].argmax()]
        if scores[top] < min_score:
            break
        keep.append(idxs[top])
        out.append(np.concatenate([boxes[top], [scores[top]]]))
        alive[top] = False
        rest = np.nonzero(alive)[0]
        if not len(rest):
            break
        x0 = np.maximum(boxes[top, 0], boxes[rest, 0])
        y0 = np.maximum(boxes[top, 1], boxes[rest, 1])
        x1 = np.minimum(boxes[top, 2], boxes[rest, 2])
        y1 = np.minimum(boxes[top, 3], boxes[rest, 3])
        inter = (x1 - x0).clip(0) * (y1 - y0).clip(0)
        iou = inter / np.maximum(areas[top] + areas[rest] - inter, 1e-12)
        if method == "linear":
            decay = np.where(iou > iou_threshold, 1.0 - iou, 1.0)
        elif method == "gaussian":
            decay = np.exp(-(iou ** 2) / sigma)
        else:
            raise ValueError(method)
        scores[rest] *= decay
        alive[rest] &= scores[rest] >= min_score
    if not keep:
        return np.zeros((0, 5), np.float32), np.zeros(0, np.int64)
    return np.stack(out), np.asarray(keep, np.int64)


def classwise_nms(masks: np.ndarray, labels: np.ndarray,
                  scores: np.ndarray, nms_type: str = "matrix",
                  nms_iou: float = 0.6, max_num: int = 100, device=None):
    """COCOInstSegEvaluatorCustom.py:120-166: class-aware NMS after the
    semantic class merge. matrix: gaussian matrix NMS (sigma 2) on
    ``device`` (default ``cuda``); soft: linear soft-NMS on boxes offset
    per class, on the host. Then top-max_num."""
    if nms_type == "matrix":
        from painter_tpu_torch.ops.nms import mask_matrix_nms
        scores, labels, masks, _ = mask_matrix_nms(
            masks, labels, scores, filter_thr=-1, nms_pre=-1,
            max_num=max_num, kernel="gaussian", sigma=2.0, device=device)
        return masks, labels, scores
    if nms_type == "soft":
        boxes = masks_to_boxes(masks)
        offsets = labels.astype(np.float32) * (boxes.max() + 1.0)
        dets, keep = soft_nms(boxes + offsets[:, None], scores,
                              iou_threshold=nms_iou, sigma=0.5,
                              min_score=0.0, method="linear")
        masks, labels = masks[keep], labels[keep]
        scores = dets[:, -1]
        if len(scores) > max_num:
            top = np.argsort(-scores, kind="stable")[:max_num]
            masks, labels, scores = masks[top], labels[top], scores[top]
        return masks, labels, scores
    raise ValueError(nms_type)


def mask_iou_matrix(dt_masks: np.ndarray, gt_masks: np.ndarray,
                    gt_crowd: Sequence[bool]) -> np.ndarray:
    """(N, H, W) x (M, H, W) -> (N, M) IoU; crowd GTs use
    intersection / det-area (pycocotools maskUtils.iou iscrowd rule)."""
    dt = np.asarray(dt_masks, bool).reshape(len(dt_masks), -1)
    gt = np.asarray(gt_masks, bool).reshape(len(gt_masks), -1)
    inter = dt.astype(np.float64) @ gt.T.astype(np.float64)
    da = dt.sum(-1, dtype=np.float64)[:, None]
    ga = gt.sum(-1, dtype=np.float64)[None, :]
    crowd = np.asarray(gt_crowd, bool)[None, :]
    denom = np.where(crowd, da, da + ga - inter)
    return inter / np.maximum(denom, 1e-12)


class InstanceAPEvaluator:
    """COCO segm AP, self-contained (COCOeval semantics)."""

    def __init__(self, iou_thrs: Optional[Sequence[float]] = None,
                 max_dets: int = 100):
        self.iou_thrs = (np.arange(0.5, 1.0, 0.05)
                         if iou_thrs is None else np.asarray(iou_thrs))
        self.max_dets = max_dets
        # per image per category: (scores, ious (N, M), dt_areas,
        # gt_ignore_base, gt_crowd, gt_areas)
        self._images: List[Dict[int, dict]] = []
        self._cats: set = set()

    def add_image(self, detections: List[Dict], gts: List[Dict]) -> None:
        """detections: {mask (H,W), score, category}; gts: {mask,
        category, [iscrowd]}."""
        by_cat: Dict[int, dict] = {}
        cats = ({d["category"] for d in detections}
                | {g["category"] for g in gts})
        for cat in cats:
            dts = sorted((d for d in detections if d["category"] == cat),
                         key=lambda d: -d["score"])[:self.max_dets]
            cgts = [g for g in gts if g["category"] == cat]
            dt_masks = np.stack([np.asarray(d["mask"]) > 0
                                 for d in dts]) if dts else None
            gt_masks = np.stack([np.asarray(g["mask"]) > 0
                                 for g in cgts]) if cgts else None
            crowd = [bool(g.get("iscrowd", 0)) for g in cgts]
            ious = (mask_iou_matrix(dt_masks, gt_masks, crowd)
                    if dts and cgts else np.zeros((len(dts), len(cgts))))
            by_cat[cat] = {
                "scores": np.array([d["score"] for d in dts], np.float32),
                "ious": ious,
                "dt_areas": np.array(
                    [float((np.asarray(d["mask"]) > 0).sum())
                     for d in dts]),
                "gt_crowd": np.asarray(crowd, bool),
                "gt_areas": np.array(
                    [float(g.get("area", (np.asarray(g["mask"]) > 0).sum()))
                     for g in cgts]),
            }
            if cgts:
                self._cats.add(cat)
        self._images.append(by_cat)

    @staticmethod
    def _match(entry: dict, thr: float, arng) -> Tuple[
            np.ndarray, np.ndarray, np.ndarray, int]:
        """cocoeval.evaluateImg for one (img, cat, thr, area-range)."""
        n_dt = len(entry["scores"])
        n_gt = len(entry["gt_crowd"])
        gt_ig = entry["gt_crowd"] | ~((entry["gt_areas"] >= arng[0])
                                      & (entry["gt_areas"] <= arng[1]))
        order = np.argsort(gt_ig, kind="stable")
        gtm = np.zeros(n_gt, bool)
        tp = np.zeros(n_dt, bool)
        dt_ig = np.zeros(n_dt, bool)
        for di in range(n_dt):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in order:
                if gtm[gi] and not entry["gt_crowd"][gi]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[gi]:
                    break
                if entry["ious"][di, gi] < best:
                    continue
                best = entry["ious"][di, gi]
                m = gi
            if m > -1:
                gtm[m] = True
                tp[di] = not gt_ig[m]
                dt_ig[di] = gt_ig[m]
            else:
                a = entry["dt_areas"][di]
                dt_ig[di] = not (arng[0] <= a <= arng[1])
        return entry["scores"], tp, dt_ig, int((~gt_ig).sum())

    def _ap_cat(self, cat: int, thr: float, arng) -> float:
        scores, tps, igs = [], [], []
        n_gt = 0
        for img in self._images:
            if cat not in img:
                continue
            s, t, ig, ng = self._match(img[cat], thr, arng)
            scores.append(s)
            tps.append(t)
            igs.append(ig)
            n_gt += ng
        if n_gt == 0:
            return -1.0
        scores = np.concatenate(scores) if scores else np.zeros(0)
        tp = np.concatenate(tps) if tps else np.zeros(0, bool)
        ig = np.concatenate(igs) if igs else np.zeros(0, bool)
        order = np.argsort(-scores, kind="mergesort")
        tp = tp[order][~ig[order]]
        ctp = np.cumsum(tp)
        cfp = np.cumsum(~tp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        idx = np.searchsorted(recall, np.linspace(0, 1, 101), side="left")
        prec = np.array([precision[i] if i < len(precision) else 0.0
                         for i in idx])
        return float(prec.mean())

    def evaluate(self) -> Dict[str, float]:
        out = {}
        for name, arng in SEGM_AREA_RNGS.items():
            per_thr = []
            for thr in self.iou_thrs:
                aps = [self._ap_cat(c, float(thr), arng)
                       for c in sorted(self._cats)]
                valid = [a for a in aps if a >= 0]
                per_thr.append(float(np.mean(valid)) if valid else -0.01)
                if name == "all" and abs(thr - 0.5) < 1e-9:
                    out["AP50"] = 100 * max(per_thr[-1], 0.0)
                if name == "all" and abs(thr - 0.75) < 1e-9:
                    out["AP75"] = 100 * max(per_thr[-1], 0.0)
            valid = [a for a in per_thr if a >= 0]
            key = "AP" if name == "all" else f"AP_{name}"
            out[key] = 100 * (float(np.mean(valid)) if valid else -0.01)
        return out
