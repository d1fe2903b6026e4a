"""COCO keypoint evaluation driver over painted pose crops.

Mirrors the reference's offline pseudo-test protocol
(``eval/mmpose_custom/configs/coco_256x192_test_offline.py``,
``model/top_down.py:163-260``): person crops (256x192, offline detection
boxes) are painted by the model with a fixed prompt; this driver decodes
the painted heatmaps (GB-classify x R), optionally merges a flip-test
pass (shift_heatmap=True), extracts keypoints through the bbox affine,
scores each pose (mean visible heatmap max x bbox score), applies OKS NMS
(thr 0.9) and computes keypoint AP natively.

Inputs:
- --pred_dir: painted crop PNGs named <key>.png (and <key>_flip.png when
  --flip_test); a sidecar --meta_json lists, per key:
  {key, image_id, center [x,y], scale [sx,sy], bbox_score}
- --gt_json: COCO person_keypoints_val2017-style json.

Host numpy only (PyTorch port of the JAX package's ``evals/run_pose.py``).

Usage:
  python -m painter_tpu_torch.evals.run_pose --pred_dir out/ \
      --meta_json meta.json --gt_json person_keypoints_val2017.json \
      [--flip_test]
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser("coco pose eval (PyTorch)", add_help=False)
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--meta_json", required=True)
    p.add_argument("--gt_json", required=True)
    p.add_argument("--flip_test", action="store_true", default=False)
    p.add_argument("--oks_nms_thr", type=float, default=0.9)
    p.add_argument("--vis_thr", type=float, default=0.2)
    p.add_argument("--max_crops", type=int, default=-1)
    return p


def evaluate(args) -> dict:
    from PIL import Image
    from painter_tpu_torch.evals.pose import (KeypointAPEvaluator,
                                              decode_painted_heatmaps,
                                              keypoints_from_heatmaps,
                                              merge_flip_test, oks_nms)

    with open(args.meta_json) as f:
        metas = json.load(f)
    if args.max_crops > 0:
        metas = metas[:args.max_crops]

    poses_by_image = defaultdict(list)
    for meta in metas:
        path = os.path.join(args.pred_dir, meta["key"] + ".png")
        if not os.path.exists(path):
            continue
        crop = np.asarray(Image.open(path).convert("RGB"), np.float32)
        heat = decode_painted_heatmaps(crop[None])
        if args.flip_test:
            fpath = os.path.join(args.pred_dir, meta["key"] + "_flip.png")
            if os.path.exists(fpath):
                fcrop = np.asarray(Image.open(fpath).convert("RGB"),
                                   np.float32)
                heat = merge_flip_test(heat,
                                       decode_painted_heatmaps(fcrop[None]))
        center = np.asarray([meta["center"]], np.float32)
        scale = np.asarray([meta["scale"]], np.float32)
        kpts, maxvals = keypoints_from_heatmaps(heat, center, scale)
        vis = maxvals[0, :, 0]
        # mmpose pose score: mean of visible joint maxima x bbox score
        visible = vis > args.vis_thr
        score = float(vis[visible].mean()) if visible.any() else 0.0
        score *= float(meta.get("bbox_score", 1.0))
        kp = np.concatenate([kpts[0], vis[:, None]], axis=-1)
        sx, sy = meta["scale"]
        poses_by_image[meta["image_id"]].append(
            {"keypoints": kp, "score": score,
             "area": sx * 200.0 * sy * 200.0})

    with open(args.gt_json) as f:
        gt = json.load(f)
    gts_by_image = defaultdict(list)
    for ann in gt["annotations"]:
        if ann.get("num_keypoints", 0) == 0:
            continue
        kp = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
        gts_by_image[ann["image_id"]].append(
            {"keypoints": kp, "area": float(ann["area"])})

    ev = KeypointAPEvaluator()
    image_ids = set(poses_by_image) | set(gts_by_image)
    for img_id in sorted(image_ids):
        dets = oks_nms(poses_by_image.get(img_id, []),
                       thr=args.oks_nms_thr)
        ev.add_image(dets, gts_by_image.get(img_id, []))
    return ev.evaluate()


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    print(json.dumps(evaluate(args)))


if __name__ == "__main__":
    main()
