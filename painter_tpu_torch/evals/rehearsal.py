"""Full-pipeline dress rehearsal on synthetic mini-datasets (PyTorch port
of the JAX package's ``evals/rehearsal.py``).

Runs the three structurally hardest eval pipelines end-to-end — ADE20K
semantic segmentation (paint -> palette decode -> mIoU), COCO panoptic
(paint instances + semantics at 560 -> 6400-color chunked instance
decode -> class vote -> panoptic fusion -> PQ), and COCO pose (paint
256x192 crops + flip pass -> heatmap decode -> flip merge -> OKS NMS ->
AP) — against generated synthetic data, recording wall-clock per phase.

Purpose (real-data readiness, not metrics): with random weights the
metric values mean nothing; what this rehearses is that every phase of
the published protocols (``eval/ade20k_semantic``,
``eval/coco_panoptic/eval.sh``, ``eval/mmpose_custom``) runs at scale on
the device, and what each phase costs. Painting is fetch-synced by
construction (every output is written to a PNG).

Each dataset is drawn from its own ``RandomState`` seeded by (seed, task),
so a task's data do not depend on which other tasks ran. A marker file
records every generation parameter; a dataset is reused only when they
all match, and is otherwise generated again into an emptied directory;
a non-empty directory without the marker is left alone, and raises.

CLI::

    python -m painter_tpu_torch.evals.rehearsal --root rehearsal_data \
        --n_images 50 --tasks ade20k,panoptic,pose [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
import zlib

import numpy as np


def task_rng(seed: int, task: str) -> np.random.RandomState:
    """The generator of one task's dataset, from (seed, task) alone."""
    return np.random.RandomState([seed, zlib.crc32(task.encode())])


def _rand_image(rng, h, w):
    """Blobby random RGB uint8 image (smooth enough to JPEG cheaply)."""
    small = rng.randint(0, 255, (h // 16, w // 16, 3), np.uint8)
    from PIL import Image
    return np.asarray(Image.fromarray(small).resize((w, h)))


def _rect_labels(rng, h, w, n_classes, n_rects=6, base=None):
    lab = np.full((h, w), base if base is not None else 0, np.int64)
    for _ in range(n_rects):
        y0 = rng.randint(0, h - 8); x0 = rng.randint(0, w - 8)
        y1 = rng.randint(y0 + 4, min(h, y0 + h // 3) + 4)
        x1 = rng.randint(x0 + 4, min(w, x0 + w // 3) + 4)
        lab[y0:y1, x0:x1] = rng.randint(0, n_classes)
    return lab


# ---------------------------------------------------------------------------
# Synthetic mini-dataset builders
# ---------------------------------------------------------------------------

_MARKER = ".generated"


def _reusable(root, params) -> bool:
    """True when ``root`` holds a dataset generated with exactly
    ``params``. A directory that this tool generated with other parameters
    (its marker differs) is emptied for a fresh generation; a non-empty
    directory without a marker is not this tool's, and raises."""
    marker = os.path.join(root, _MARKER)
    if os.path.exists(marker):
        with open(marker) as f:
            try:
                if json.load(f) == params:
                    return True
            except ValueError:
                pass
        shutil.rmtree(root)
    elif os.path.isdir(root) and os.listdir(root):
        raise FileExistsError(
            f"{root} is not empty and holds no {_MARKER} marker of this "
            "tool; give --root a directory of its own")
    os.makedirs(root, exist_ok=True)
    # written before the data, so that an interrupted generation leaves a
    # marker that matches no parameters and is generated again
    _mark_generated(root, {**params, "complete": False})
    return False


def _mark_generated(root, params):
    with open(os.path.join(root, _MARKER), "w") as f:
        json.dump(params, f)


def make_ade20k(root, n, seed=0, hw=(512, 683)):
    """images/*.jpg + annotations/*.png (1-based labels, 0=ignore) +
    a prompt pair painted with the ADE palette."""
    from PIL import Image
    from painter_tpu_torch.ops.palette import ade20k_palette

    img_dir = os.path.join(root, "images")
    ann_dir = os.path.join(root, "annotations")
    params = {"n": n, "hw": list(hw), "seed": seed}
    if _reusable(root, params):
        return (img_dir, ann_dir, os.path.join(root, "prompt.jpg"),
                os.path.join(root, "prompt_tgt.png"))
    rng = task_rng(seed, "ade20k")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    pal = ade20k_palette()
    h, w = hw
    for i in range(n):
        Image.fromarray(_rand_image(rng, h, w)).save(
            os.path.join(img_dir, f"im{i:04d}.jpg"))
        lab = _rect_labels(rng, h, w, 150)
        Image.fromarray((lab + 1).astype(np.uint8)).save(
            os.path.join(ann_dir, f"im{i:04d}.png"))
    # prompt pair
    p_img = os.path.join(root, "prompt.jpg")
    p_tgt = os.path.join(root, "prompt_tgt.png")
    Image.fromarray(_rand_image(rng, h, w)).save(p_img)
    lab = _rect_labels(rng, h, w, 150)
    Image.fromarray(pal[lab].astype(np.uint8)).save(p_tgt)
    _mark_generated(root, params)
    return img_dir, ann_dir, p_img, p_tgt


def make_panoptic(root, n, seed=0, hw=(480, 640), n_things=3):
    """images/*.jpg + panoptic GT (id PNGs + json) + inst/semseg prompt
    pairs painted with the COCO protocols."""
    from PIL import Image
    from painter_tpu_torch.data import prep
    from painter_tpu_torch.ops.palette import coco_semseg_palette

    img_dir = os.path.join(root, "images")
    gt_dir = os.path.join(root, "panoptic_gt")
    params = {"n": n, "hw": list(hw), "n_things": n_things, "seed": seed}
    if _reusable(root, params):
        return (img_dir, gt_dir, os.path.join(root, "panoptic_gt.json"),
                os.path.join(root, "prompt.jpg"),
                os.path.join(root, "prompt_inst.png"),
                os.path.join(root, "prompt_sem.png"))
    rng = task_rng(seed, "panoptic")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    pal = coco_semseg_palette()
    h, w = hw
    annotations = []
    for i in range(n):
        name = f"im{i:04d}"
        Image.fromarray(_rand_image(rng, h, w)).save(
            os.path.join(img_dir, name + ".jpg"))
        ids = np.full((h, w), n_things + 1, np.uint32)  # stuff bg
        segs = []
        for t in range(n_things):
            y0 = rng.randint(0, h - 80); x0 = rng.randint(0, w - 80)
            ids[y0:y0 + 72, x0:x0 + 72] = t + 1
            segs.append({"id": t + 1,
                         "category_id": 1000 + rng.randint(0, 80)})
        segs.append({"id": n_things + 1,
                     "category_id": 2000 + rng.randint(0, 53)})
        gt_png = np.stack([ids % 256, ids // 256,
                           np.zeros_like(ids)], -1).astype(np.uint8)
        Image.fromarray(gt_png).save(os.path.join(gt_dir, name + ".png"))
        annotations.append({"file_name": name + ".png",
                            "segments_info": segs})
    categories = [{"id": 1000 + i, "isthing": 1} for i in range(80)] + \
                 [{"id": 2000 + i, "isthing": 0} for i in range(53)]
    gt_json = os.path.join(root, "panoptic_gt.json")
    with open(gt_json, "w") as f:
        json.dump({"categories": categories,
                   "annotations": annotations}, f)
    # prompts: class-agnostic instance painting + semseg palette painting
    masks = np.zeros((2, h, w), np.float32)
    masks[0, 40:160, 40:200] = 1
    masks[1, 200:360, 300:520] = 1
    p_img = os.path.join(root, "prompt.jpg")
    Image.fromarray(_rand_image(rng, h, w)).save(p_img)
    p_inst = os.path.join(root, "prompt_inst.png")
    Image.fromarray(prep.paint_instances(masks, hw)).save(p_inst)
    p_sem = os.path.join(root, "prompt_sem.png")
    lab = _rect_labels(rng, h, w, 133, base=90)
    Image.fromarray(pal[lab].astype(np.uint8)).save(p_sem)
    _mark_generated(root, params)
    return img_dir, gt_dir, gt_json, p_img, p_inst, p_sem


def make_pose(root, n, seed=0):
    """256x192 person-crop jpgs (+ *_flip.jpg pairs), meta json, GT
    json, and a prompt pair painted with the pose heatmap codec."""
    from PIL import Image
    from painter_tpu_torch.data import prep

    img_dir = os.path.join(root, "crops")
    params = {"n": n, "hw": [256, 192], "seed": seed}
    if _reusable(root, params):
        return (img_dir, os.path.join(root, "meta.json"),
                os.path.join(root, "gt.json"),
                os.path.join(root, "prompt.jpg"),
                os.path.join(root, "prompt_tgt.png"))
    rng = task_rng(seed, "pose")
    os.makedirs(img_dir)
    metas, anns = [], []
    for i in range(n):
        key = f"c{i:04d}"
        crop = _rand_image(rng, 256, 192)
        Image.fromarray(crop).save(os.path.join(img_dir, key + ".jpg"))
        Image.fromarray(crop[:, ::-1]).save(
            os.path.join(img_dir, key + "_flip.jpg"))
        center = [96.0 + rng.uniform(-5, 5), 128.0 + rng.uniform(-5, 5)]
        scale = [192 / 200.0, 256 / 200.0]
        metas.append({"key": key, "image_id": i, "center": center,
                      "scale": scale, "bbox_score": 0.9})
        kpts = np.zeros((17, 3), np.float64)
        kpts[:, 0] = rng.uniform(20, 170, 17)
        kpts[:, 1] = rng.uniform(20, 230, 17)
        kpts[:, 2] = 2
        anns.append({"image_id": i, "num_keypoints": 17,
                     "area": 192.0 * 256.0,
                     "keypoints": kpts.reshape(-1).tolist()})
    meta_json = os.path.join(root, "meta.json")
    gt_json = os.path.join(root, "gt.json")
    with open(meta_json, "w") as f:
        json.dump(metas, f)
    with open(gt_json, "w") as f:
        json.dump({"annotations": anns}, f)
    # prompt: a synthetic painted heatmap crop
    kpts = np.zeros((17, 3), np.float32)
    kpts[:, 0] = rng.uniform(20, 170, 17)
    kpts[:, 1] = rng.uniform(20, 230, 17)
    kpts[:, 2] = 2
    heat = prep.gaussian_heatmaps(kpts, (256, 192), sigma=8.0)
    p_img = os.path.join(root, "prompt.jpg")
    p_tgt = os.path.join(root, "prompt_tgt.png")
    Image.fromarray(_rand_image(rng, 256, 192)).save(p_img)
    Image.fromarray(prep.paint_pose_crop(heat)).save(p_tgt)
    _mark_generated(root, params)
    return img_dir, meta_json, gt_json, p_img, p_tgt


# ---------------------------------------------------------------------------
# Phase-timed pipelines
# ---------------------------------------------------------------------------

def eval_args(**kw):
    """A ``run_eval`` argument namespace: the CLI's defaults (batch 8)
    overridden by ``kw``."""
    defaults = dict(ckpt_path=None, model=None, image_ext="*.jpg",
                    gt_dir=None, sidd_mat=None, sidd_gt_mat=None,
                    derain_root=None, gt_ext="*.png", input_size=448,
                    num_shards=1, shard=0, dist_type="abs", max_images=-1,
                    batch_size=8, n_dp=1, quant="none", device="cuda",
                    skip_metrics=False, decode_only=False)
    defaults.update(kw)
    return argparse.Namespace(**defaults)


def _clock(timings, key, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    timings[key] = time.perf_counter() - t0
    return out


def rehearse_ade20k(root, n, seed, model_name, input_size, batch_size,
                    device, timings):
    from painter_tpu_torch.evals import run_eval

    img_dir, ann_dir, p_img, p_tgt = make_ade20k(root, n, seed)
    args = eval_args(task="ade20k_semseg", image_dir=img_dir,
                     gt_dir=ann_dir, prompt_image=p_img,
                     prompt_target=p_tgt, model=model_name,
                     input_size=input_size, batch_size=batch_size,
                     device=device, output_dir=os.path.join(root, "out"))
    model = _clock(timings, "ade20k/build_model_s", run_eval.build_model,
                   args)
    outputs = _clock(timings, "ade20k/paint_s", run_eval.paint_predictions,
                     args, model)
    metrics = _clock(timings, "ade20k/decode_miou_s",
                     run_eval.compute_metrics, args, outputs)
    if metrics is None or not np.isfinite(metrics["mIoU"]):
        raise RuntimeError(f"ADE20K rehearsal gave {metrics}")
    timings["ade20k/mIoU"] = metrics["mIoU"]
    return model


def rehearse_panoptic(root, n, seed, model_name, input_size, batch_size,
                      device, timings):
    from painter_tpu_torch.evals import run_eval, run_panoptic

    (img_dir, gt_dir, gt_json, p_img, p_inst,
     p_sem) = make_panoptic(root, n, seed)
    args_i = eval_args(task="coco_inst", image_dir=img_dir,
                       prompt_image=p_img, prompt_target=p_inst,
                       model=model_name, input_size=input_size,
                       batch_size=batch_size, skip_metrics=True,
                       device=device,
                       output_dir=os.path.join(root, "out_inst"))
    model = _clock(timings, "pano/build_model_s", run_eval.build_model,
                   args_i)
    _clock(timings, "pano/paint_inst_s", run_eval.paint_predictions,
           args_i, model)
    args_s = eval_args(task="coco_semseg", image_dir=img_dir,
                       prompt_image=p_img, prompt_target=p_sem,
                       model=model_name, input_size=input_size,
                       batch_size=batch_size, skip_metrics=True,
                       device=device,
                       output_dir=os.path.join(root, "out_sem"))
    _clock(timings, "pano/paint_semseg_s", run_eval.paint_predictions,
           args_s, model)
    pano_args = run_panoptic.get_args_parser().parse_args([
        "--inst_dir", args_i.output_dir, "--semseg_dir", args_s.output_dir,
        "--gt_json", gt_json, "--gt_dir", gt_dir, "--device", device])
    res = _clock(timings, "pano/decode_fuse_pq_s", run_panoptic.evaluate,
                 pano_args)
    if res["n_images"] != n or not np.isfinite(res["PQ"]):
        raise RuntimeError(f"panoptic rehearsal gave {res}")
    timings["pano/PQ"] = res["PQ"]


def rehearse_pose(root, n, seed, model_name, input_size, batch_size,
                  device, timings):
    from painter_tpu_torch.evals import run_eval, run_pose

    img_dir, meta_json, gt_json, p_img, p_tgt = make_pose(root, n, seed)
    args = eval_args(task="pose", image_dir=img_dir, prompt_image=p_img,
                     prompt_target=p_tgt, model=model_name,
                     input_size=input_size, batch_size=batch_size,
                     skip_metrics=True, device=device,
                     output_dir=os.path.join(root, "out"))
    model = _clock(timings, "pose/build_model_s", run_eval.build_model,
                   args)
    # crops + their _flip pairs
    _clock(timings, "pose/paint_s", run_eval.paint_predictions, args, model)
    pose_args = run_pose.get_args_parser().parse_args([
        "--pred_dir", args.output_dir, "--meta_json", meta_json,
        "--gt_json", gt_json, "--flip_test"])
    res = _clock(timings, "pose/decode_ap_s", run_pose.evaluate, pose_args)
    if not np.isfinite(res["AP"]):
        raise RuntimeError(f"pose rehearsal gave {res}")
    timings["pose/AP"] = res["AP"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root",
                    default=os.path.join(tempfile.gettempdir(), "rehearsal"))
    ap.add_argument("--n_images", type=int, default=50)
    ap.add_argument("--tasks", default="ade20k,panoptic,pose")
    ap.add_argument("--model", default=None,
                    help="preset override (tests use tiny_test)")
    ap.add_argument("--input_size", type=int, default=448)
    ap.add_argument("--pano_input_size", type=int, default=560,
                    help="the published panoptic protocol paints at 560")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic datasets")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs on the host)")
    args = ap.parse_args(argv)

    timings = {}
    t_all = time.perf_counter()
    if "ade20k" in args.tasks:
        rehearse_ade20k(os.path.join(args.root, "ade"), args.n_images,
                        args.seed, args.model, args.input_size,
                        args.batch_size, args.device, timings)
        print("ADE20K " + json.dumps(
            {k: v for k, v in timings.items() if k.startswith("ade")}),
            flush=True)
    if "panoptic" in args.tasks:
        rehearse_panoptic(os.path.join(args.root, "pano"), args.n_images,
                          args.seed, args.model, args.pano_input_size,
                          args.batch_size, args.device, timings)
        print("PANOPTIC " + json.dumps(
            {k: v for k, v in timings.items() if k.startswith("pano")}),
            flush=True)
    if "pose" in args.tasks:
        rehearse_pose(os.path.join(args.root, "pose"), args.n_images,
                      args.seed, args.model, args.input_size,
                      args.batch_size, args.device, timings)
        print("POSE " + json.dumps(
            {k: v for k, v in timings.items() if k.startswith("pose")}),
            flush=True)
    timings["total_s"] = time.perf_counter() - t_all
    print("REHEARSAL " + json.dumps(timings), flush=True)
    return timings


if __name__ == "__main__":
    main()
