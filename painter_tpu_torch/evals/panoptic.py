"""Panoptic fusion + PQ metric (self-contained, no detectron2/panopticapi).

Behavioral contract from ``eval/coco_panoptic/COCOPanoEvaluatorCustom.py``:
- instance class vote: thing-class probability = 1 - dist/max over the
  semseg distance map's first 80 (thing) channels, per-instance einsum
  argmax (:259-276);
- fusion (panopticapi-style): score-sorted instances placed if score >=
  0.55 and overlap with already-placed area <= 0.5 of the mask; stuff
  classes (id >= 80) fill remaining area if >= 8192 px (:47-134);
- PQ follows the panopticapi definition: match pred/gt segments of equal
  category with IoU > 0.5 (counting VOID-free areas), PQ = TP_iou_sum /
  (|TP| + |FP|/2 + |FN|/2).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

VOID = 0


def vote_instance_classes(masks: np.ndarray, semseg_dist: np.ndarray,
                          num_things: int = 80) -> np.ndarray:
    """masks (N, H, W) float; semseg_dist (H, W, K) -> (N,) class ids."""
    dist = semseg_dist[:, :, :num_things]
    prob = 1.0 - dist / max(float(dist.max()), 1e-12)
    mask_probs = np.einsum("nhw,hwk->nk", masks, prob)
    return mask_probs.argmax(-1).astype(np.int32)


def combine_semantic_and_instance(masks: np.ndarray, scores: np.ndarray,
                                  classes: np.ndarray,
                                  semseg_map: np.ndarray,
                                  overlap_threshold: float = 0.5,
                                  stuff_area_thresh: float = 8192,
                                  instances_score_thresh: float = 0.55,
                                  num_things: int = 80
                                  ) -> Tuple[np.ndarray, List[Dict]]:
    """Reference fusion (COCOPanoEvaluatorCustom.py:47-134)."""
    panoptic = np.zeros_like(semseg_map, np.int32)
    segments_info: List[Dict] = []
    current_id = 0
    for inst_id in np.argsort(-scores, kind="stable"):
        score = float(scores[inst_id])
        if score < instances_score_thresh:
            break
        mask = masks[inst_id] > 0
        area = int(mask.sum())
        if area == 0:
            continue
        intersect = mask & (panoptic > 0)
        inter_area = int(intersect.sum())
        if inter_area / area > overlap_threshold:
            continue
        if inter_area > 0:
            mask = mask & (panoptic == 0)
        current_id += 1
        panoptic[mask] = current_id
        segments_info.append({"id": current_id, "isthing": True,
                              "score": score,
                              "category_id": int(classes[inst_id]),
                              "instance_id": int(inst_id)})
    for sem_label in np.unique(semseg_map):
        if sem_label < num_things:  # thing ids handled above
            continue
        mask = (semseg_map == sem_label) & (panoptic == 0)
        area = int(mask.sum())
        if area < stuff_area_thresh:
            continue
        current_id += 1
        panoptic[mask] = current_id
        segments_info.append({"id": current_id, "isthing": False,
                              "category_id": int(sem_label), "area": area})
    return panoptic, segments_info


class PQStat:
    """panopticapi PQ accumulation (per category)."""

    def __init__(self):
        self.iou: Dict[int, float] = {}
        self.tp: Dict[int, int] = {}
        self.fp: Dict[int, int] = {}
        self.fn: Dict[int, int] = {}
        self.isthing: Dict[int, bool] = {}

    def _touch(self, cat: int, isthing: bool):
        for d in (self.iou, self.tp, self.fp, self.fn):
            d.setdefault(cat, 0)
        self.isthing[cat] = isthing

    def process_image(self, pred_map: np.ndarray, pred_segments: List[Dict],
                      gt_map: np.ndarray, gt_segments: List[Dict]):
        pred_info = {s["id"]: s for s in pred_segments}
        gt_info = {s["id"]: s for s in gt_segments}
        for s in pred_segments:
            self._touch(s["category_id"], bool(s.get("isthing", True)))
        for s in gt_segments:
            self._touch(s["category_id"], bool(s.get("isthing", True)))

        # joint histogram of (gt_id, pred_id) areas
        combined = gt_map.astype(np.uint64) * (2 ** 32) \
            + pred_map.astype(np.uint64)
        ids, counts = np.unique(combined, return_counts=True)
        inter: Dict[Tuple[int, int], int] = {}
        for v, c in zip(ids, counts):
            inter[(int(v // 2 ** 32), int(v % 2 ** 32))] = int(c)

        gt_area = {i: 0 for i in gt_info}
        pred_area = {i: 0 for i in pred_info}
        for (g, p), c in inter.items():
            if g in gt_area:
                gt_area[g] += c
            if p in pred_area:
                pred_area[p] += c

        matched_gt, matched_pred = set(), set()
        for (g, p), c in inter.items():
            if g not in gt_info or p not in pred_info:
                continue
            if gt_info[g]["category_id"] != pred_info[p]["category_id"]:
                continue
            # panopticapi: the pred's overlap with GT VOID is excluded
            # from the union
            union = gt_area[g] + pred_area[p] - c \
                - inter.get((VOID, p), 0)
            iou = c / union if union > 0 else 0.0
            if iou > 0.5:
                cat = gt_info[g]["category_id"]
                self.iou[cat] += iou
                self.tp[cat] += 1
                matched_gt.add(g)
                matched_pred.add(p)
        for g, s in gt_info.items():
            if g not in matched_gt:
                self.fn[s["category_id"]] += 1
        for p, s in pred_info.items():
            if p in matched_pred:
                continue
            # panopticapi: preds mostly covering VOID don't count as FP
            void_area = inter.get((VOID, p), 0)
            if pred_area.get(p, 0) > 0 and \
                    void_area / pred_area[p] > 0.5:
                continue
            self.fp[s["category_id"]] += 1

    def evaluate(self) -> Dict[str, float]:
        def agg(cats):
            pq = sq = rq = 0.0
            n = 0
            for c in cats:
                tp, fp, fn = self.tp[c], self.fp[c], self.fn[c]
                if tp + fp + fn == 0:
                    continue
                n += 1
                pq += self.iou[c] / (tp + 0.5 * fp + 0.5 * fn)
                sq += (self.iou[c] / tp) if tp else 0.0
                rq += tp / (tp + 0.5 * fp + 0.5 * fn)
            if n == 0:
                return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
            return {"pq": 100 * pq / n, "sq": 100 * sq / n,
                    "rq": 100 * rq / n, "n": n}

        cats = list(self.tp)
        things = [c for c in cats if self.isthing.get(c)]
        stuff = [c for c in cats if not self.isthing.get(c)]
        out = {("PQ", "SQ", "RQ")[i]: v for i, v in
               enumerate(agg(cats)[k] for k in ("pq", "sq", "rq"))}
        out.update({f"PQ_th": agg(things)["pq"],
                    f"PQ_st": agg(stuff)["pq"]})
        return out
