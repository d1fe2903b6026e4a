"""COCO panoptic evaluation driver: fuse painted inst + semseg predictions.

Mirrors the reference's two-pass protocol (``eval/coco_panoptic/eval.sh``):
pass 1 paints class-agnostic instance predictions (prompted at input 560,
dist_thr 19) and semantic predictions; this driver decodes both, votes
instance classes from the semantic distance maps, fuses panoptically
(overlap 0.5 / stuff-area 8192 / score 0.55,
``COCOPanoEvaluatorCustom.py:47-134,259-297``) and computes PQ natively.

GT: COCO panoptic format — a directory of id-encoded PNGs + the panoptic
json with segments_info (category ids remapped to contiguous
thing[0..79]/stuff[80..132] ids via the category list).

The decodes and the class vote run on ``--device`` (default ``cuda``);
the fusion and the metrics on the host.

Usage:
  python -m painter_tpu_torch.evals.run_panoptic --inst_dir out_inst/ \
      --semseg_dir out_semseg/ --gt_json panoptic_val2017.json \
      --gt_dir panoptic_val2017/ [--dist_thr 19]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from painter_tpu_torch.ops.nms import no_tf32
from painter_tpu_torch.ops.palette import color_distance_map


def get_args_parser():
    p = argparse.ArgumentParser("coco panoptic fusion eval (PyTorch)",
                                add_help=False)
    p.add_argument("--inst_dir", required=True,
                   help="painted class-agnostic instance PNGs")
    p.add_argument("--semseg_dir", required=True,
                   help="painted semantic PNGs")
    p.add_argument("--gt_json", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--dist_thr", type=float, default=19.0)
    p.add_argument("--dist_type", default="abs")
    p.add_argument("--overlap_threshold", type=float, default=0.5)
    p.add_argument("--stuff_area_thresh", type=float, default=8192)
    p.add_argument("--instances_score_thresh", type=float, default=0.55)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--mode", default="pq", choices=["pq", "instance_ap"],
                   help="pq: panoptic fusion (published protocol); "
                        "instance_ap: class-aware COCO segm AP "
                        "(COCOInstSegEvaluatorCustom role)")
    p.add_argument("--post_type", default="threshold",
                   choices=["threshold", "minmax"],
                   help="instance decode variant "
                        "(COCOCAInstSegEvaluatorCustom.py:172/:252)")
    p.add_argument("--with_nms", action="store_true", default=False,
                   help="instance_ap: keep all candidates, merge classes, "
                        "then class-wise NMS (COCOInstSegEvaluatorCustom)")
    p.add_argument("--nms_type", default="matrix",
                   choices=["matrix", "soft"])
    p.add_argument("--nms_iou", type=float, default=0.6)
    p.add_argument("--device", default="cuda",
                   help="torch device of the decodes and the vote ('cpu' "
                        "runs on the host)")
    return p


def contiguous_category_map(categories):
    """COCO category ids -> contiguous [things..., stuff...] ids

    (things first, preserving order — detectron2 convention)."""
    things = [c for c in categories if c.get("isthing", 1) == 1]
    stuff = [c for c in categories if c.get("isthing", 1) == 0]
    mapping = {}
    for i, c in enumerate(things):
        mapping[c["id"]] = i
    for i, c in enumerate(stuff):
        mapping[c["id"]] = len(things) + i
    return mapping, len(things)


def vote_classes(masks: torch.Tensor, sem_png: torch.Tensor,
                 palette: torch.Tensor, num_things: int,
                 dist_type: str = "abs") -> torch.Tensor:
    """Instance class vote on the device (the same math as
    :func:`panoptic.vote_instance_classes`, which stays as the host
    reference): the (H, W, 133) distance map never leaves the device.

    The einsum runs in fp32 with TF32 off: its ``prob`` operand is not
    exact in TF32's 10-bit mantissa, and the argmax reads sums that can be
    close."""
    d = color_distance_map(sem_png, palette, dist_type)[..., :num_things]
    prob = 1.0 - d / d.max().clamp(min=1e-12)
    with no_tf32():
        mp = torch.einsum("nhw,hwk->nk", masks.float(), prob)
    return mp.argmax(-1).to(torch.int32)


def evaluate(args) -> dict:
    from PIL import Image
    from painter_tpu_torch.data.prep import panoptic_png_to_ids
    from painter_tpu_torch.device import resolve_device
    from painter_tpu_torch.evals.coco_ap import (InstanceAPEvaluator,
                                                 classwise_nms)
    from painter_tpu_torch.evals.instseg import (_bucket, decode_instances,
                                                 decode_instances_minmax)
    from painter_tpu_torch.evals.panoptic import (
        PQStat, combine_semantic_and_instance)
    from painter_tpu_torch.ops.palette import (coco_semseg_palette,
                                               nearest_color_decode)

    dev = resolve_device(args.device)
    with open(args.gt_json) as f:
        gt = json.load(f)
    cat_map, num_things = contiguous_category_map(gt["categories"])
    gt_by_file = {a["file_name"]: a for a in gt["annotations"]}

    palette = torch.from_numpy(
        coco_semseg_palette().astype(np.float32)).to(dev)

    stat = PQStat()
    ap_eval = InstanceAPEvaluator()
    files = sorted(glob.glob(os.path.join(args.inst_dir, "*.png")))
    if args.max_images > 0:
        files = files[:args.max_images]
    n_eval = 0
    for inst_path in files:
        base = os.path.basename(inst_path)
        sem_path = os.path.join(args.semseg_dir, base)
        if base not in gt_by_file or not os.path.exists(sem_path):
            continue
        inst_png = np.asarray(Image.open(inst_path).convert("RGB"),
                              np.float32)
        sem_png = np.asarray(Image.open(sem_path).convert("RGB"),
                             np.float32)
        if args.post_type == "minmax":
            inst = decode_instances_minmax(inst_png, device=dev)
            bg = inst["classes"] == 0
            inst = {"masks": inst["masks"][~bg],
                    "scores": inst["scores"][~bg]}
            masks_dev = torch.from_numpy(inst["masks"]).to(dev)
        else:
            inst = decode_instances(inst_png,
                                    dist_thr_list=(args.dist_thr,),
                                    keep_all=args.with_nms,
                                    return_device=True, device=dev)
            masks_dev = inst.pop("masks_dev")
        sem_dev = torch.from_numpy(sem_png).to(dev)
        sem_map = nearest_color_decode(sem_dev, palette,
                                       args.dist_type).cpu().numpy()
        # the instance count varies per image; pad to the power-of-two
        # bucket as the JAX package does (an all-zero pad mask votes a
        # zero row, sliced off)
        n_real = int(masks_dev.shape[0])
        nb = _bucket(n_real)
        if nb != n_real:
            masks_dev = torch.cat(
                [masks_dev,
                 masks_dev.new_zeros((nb - n_real,) + masks_dev.shape[1:])])
        classes = vote_classes(masks_dev, sem_dev, palette, num_things,
                               args.dist_type).cpu().numpy()[:n_real]

        ann = gt_by_file[base]
        gt_png = np.asarray(Image.open(
            os.path.join(args.gt_dir, base)).convert("RGB"))
        gt_map = panoptic_png_to_ids(gt_png).astype(np.int64)

        if args.mode == "instance_ap":
            masks, labels, scores = inst["masks"], classes, inst["scores"]
            if args.with_nms:
                masks, labels, scores = classwise_nms(
                    masks, labels, scores, args.nms_type, args.nms_iou,
                    device=dev)
            dets = [{"mask": m, "score": float(s), "category": int(c)}
                    for m, s, c in zip(masks, scores, labels)]
            gts = [{"mask": gt_map == s["id"],
                    "category": cat_map[s["category_id"]],
                    "iscrowd": s.get("iscrowd", 0),
                    "area": s.get("area")}
                   for s in ann["segments_info"]
                   if cat_map[s["category_id"]] < num_things]
            for g in gts:
                if g["area"] is None:
                    g["area"] = float(g["mask"].sum())
            ap_eval.add_image(dets, gts)
        else:
            pan, segs = combine_semantic_and_instance(
                inst["masks"], inst["scores"], classes, sem_map,
                args.overlap_threshold, args.stuff_area_thresh,
                args.instances_score_thresh, num_things)
            gt_segs = [{"id": s["id"],
                        "category_id": cat_map[s["category_id"]],
                        "isthing": cat_map[s["category_id"]] < num_things}
                       for s in ann["segments_info"]]
            stat.process_image(pan, segs, gt_map, gt_segs)
        n_eval += 1
    res = ap_eval.evaluate() if args.mode == "instance_ap" \
        else stat.evaluate()
    res["n_images"] = n_eval
    return res


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    res = evaluate(args)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
