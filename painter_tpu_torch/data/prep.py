"""Offline dataset preparation (L3): paint task targets as RGB and emit
pair-list JSONs.

The PyTorch port's copy of ``painter_tpu/data/prep.py``: the same
functions, the same files byte for byte, and the same CLI
(``python -m painter_tpu_torch.data.prep <cmd> ...``), whose
``gen-instance-trainset`` / ``gen-pose-trainset`` also take ``--device``
(default ``cuda``) for the resizes and warps of
:mod:`painter_tpu_torch.data.trainset_gen`. Host code, numpy and PIL.
Behavioral contracts:

- semantic painting: label map -> palette color, ignore -> black
  (``data/ade20k/gen_color_ade20k_sem.py:66-145``,
  ``data/coco_semseg/gen_color_coco_panoptic_segm.py``);
- panoptic -> semantic: COCO panoptic PNG ids (R + 256 G + 256^2 B) +
  segments_info -> contiguous category map
  (``data/prepare_coco_semantic_annos_from_panoptic_annos.py``);
- instance painting: each instance mask painted with the color of its
  mass-center cell — 4x4 global (R) x 20x20 local (G,B) position code
  (``data/mmdet_custom/data/pipelines/transforms.py:70-177``; painted
  directly from masks instead of running a fake mmdet training job);
- pose painting: 256x192 person crops; R = max gaussian heatmap x255,
  (G,B) = keypoint-class color, collisions resolved by the max-magnitude
  keypoint (``data/mmpose_custom/data/pipelines/custom_transform.py:39-127``);
- pair-list JSONs: records {image_path, target_path, type}
  (``data/depth/gen_json_nyuv2_depth.py:50-56`` and siblings);
- toy dataset: first N samples per JSON for smoke tests
  (``Painter/util/get_toy_dataset.py:18-41``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from painter_tpu_torch.ops.palette import (ade20k_palette,
                                           coco_instance_palette,
                                           coco_semseg_palette,
                                           paint_semantic, pose_gb_palette)

PAIR_TYPES = {
    "depth": "nyuv2_image2depth",
    "ade20k": "ade20k_image2semantic",
    "coco_inst": "coco_image2panoptic_inst",
    "coco_semseg": "coco_image2panoptic_sem_seg",
    "pose": "coco_image2pose",
    "denoise": "ssid_image2denoise",
    "derain": "derain_image2derain",
    "lol": "lol_image2enhance",
}


# ---------------------------------------------------------------------------
# semantic painting
# ---------------------------------------------------------------------------

def paint_semantic_dir(label_dir: str, out_dir: str, task: str = "ade20k",
                       label_offset: int = 0,
                       ignore_label: int = 255) -> List[str]:
    """Paint every label PNG in label_dir; ADE20K labels are 1-based with

    0 = ignore (gen_color_ade20k_sem.py: label-1 indexing)."""
    palette = (ade20k_palette() if task == "ade20k"
               else coco_semseg_palette())
    os.makedirs(out_dir, exist_ok=True)
    out_paths = []
    for path in sorted(glob.glob(os.path.join(label_dir, "*.png"))):
        labels = np.asarray(Image.open(path), np.int32)
        if task == "ade20k":
            labels = labels - 1  # 0 -> -1 = ignore
            labels = np.where(labels < 0, ignore_label, labels)
        else:
            labels = labels + label_offset
        painted = paint_semantic(labels, palette, ignore_label)
        out = os.path.join(out_dir, os.path.basename(path))
        Image.fromarray(painted).save(out)
        out_paths.append(out)
    return out_paths


def panoptic_png_to_ids(png: np.ndarray) -> np.ndarray:
    """COCO panoptic PNG -> segment-id map (R + 256 G + 256^2 B)."""
    png = png.astype(np.uint32)
    return png[..., 0] + 256 * png[..., 1] + 256 ** 2 * png[..., 2]


def semantic_from_panoptic(panoptic_png: np.ndarray,
                           segments_info: Sequence[Dict],
                           cat_id_to_contiguous: Dict[int, int],
                           ignore_label: int = 255) -> np.ndarray:
    """prepare_coco_semantic_annos_from_panoptic_annos.py semantics."""
    ids = panoptic_png_to_ids(panoptic_png)
    out = np.full(ids.shape, ignore_label, np.int32)
    for seg in segments_info:
        out[ids == seg["id"]] = cat_id_to_contiguous[seg["category_id"]]
    return out


def semantic_from_panoptic_dir(panoptic_json: str, panoptic_root: str,
                               out_dir: str,
                               max_images: int = -1) -> List[str]:
    """COCO panoptic annotations -> per-image 133-class semantic PNGs.

    The directory-driver role of the reference's
    ``data/prepare_coco_semantic_annos_from_panoptic_annos.py`` for the
    *painting* task: every category (things and stuff) maps to its
    contiguous index in the panoptic ``categories`` list (the
    detectron2 ``COCO_CATEGORIES`` order the 133-color palette
    assumes); unlabeled pixels stay 255.
    """
    with open(panoptic_json) as f:
        pan = json.load(f)
    cat_map = {c["id"]: i for i, c in enumerate(pan["categories"])}
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for ann in pan["annotations"][:max_images if max_images > 0 else None]:
        png = np.asarray(Image.open(
            os.path.join(panoptic_root, ann["file_name"])).convert("RGB"))
        sem = semantic_from_panoptic(png, ann["segments_info"], cat_map)
        out = os.path.join(out_dir, ann["file_name"])
        Image.fromarray(sem.astype(np.uint8)).save(out)
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# instance painting (mass-center position code)
# ---------------------------------------------------------------------------

def mass_center(mask: np.ndarray, eps: float = 1e-6) -> Tuple[float, float]:
    h, w = mask.shape
    norm = max(float(mask.sum()), eps)
    cy = float((mask * np.arange(h)[:, None]).sum()) / norm
    cx = float((mask * np.arange(w)).sum()) / norm
    return cx, cy


def paint_instances(masks: np.ndarray, image_hw: Tuple[int, int],
                    num_location_gb: int = 20) -> np.ndarray:
    """(N, H, W) binary masks -> (H, W, 3) position-color painting.

    Color index = (absolute_x, absolute_y) on the 80x80 grid from the
    instance's mass center (transforms.py:118-131). Instances are painted
    in order (later masks overwrite earlier, as in the reference loop).
    """
    h, w = image_hw
    palette = coco_instance_palette()
    seg = np.zeros((h, w, 3), np.uint8)
    grid = 4 * num_location_gb  # 80
    for mask in masks:
        if mask.sum() == 0:
            continue
        cx, cy = mass_center(mask)
        ax = int(cx / w * (grid - 1))
        ay = int(cy / h * (grid - 1))
        # palette row order: (gy, gx, ly, lx); absolute = g*20 + l
        gy, ly = divmod(ay, num_location_gb)
        gx, lx = divmod(ax, num_location_gb)
        idx = ((gy * 4 + gx) * num_location_gb + ly) * num_location_gb + lx
        seg[mask.astype(bool)] = palette[idx]
    return seg


# ---------------------------------------------------------------------------
# pose painting
# ---------------------------------------------------------------------------

def gaussian_heatmaps(keypoints: np.ndarray, hw: Tuple[int, int],
                      sigma: float = 8.0) -> np.ndarray:
    """(17, 3) keypoints in crop coords -> (17, H, W) gaussians.

    Invisible joints (v == 0) produce empty maps (check_input semantics,
    custom_transform.py:55-62)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    maps = np.zeros((len(keypoints), h, w), np.float32)
    for k, (x, y, v) in enumerate(keypoints):
        if v <= 0:
            continue
        maps[k] = np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                         / (2 * sigma ** 2))
    return maps


def paint_pose_crop(heatmaps: np.ndarray) -> np.ndarray:
    """(17, H, W) heatmaps in [0,1] -> (H, W, 3) painted crop.

    R = max heatmap x255; (G,B) = class color; collision pixels take the
    argmax class's color (custom_transform.py:64-111)."""
    k, h, w = heatmaps.shape
    colors = pose_gb_palette().astype(np.float32)
    r = heatmaps.max(0) * 255.0
    argmax_k = heatmaps.argmax(0)
    active = heatmaps != 0
    num_active = active.sum(0)
    gb = np.zeros((h, w, 2), np.float32)
    for idx in range(k):
        gb[active[idx]] += colors[idx]
    collision = num_active > 1
    if collision.any():
        for idx in range(k):
            sel = (argmax_k == idx) & collision
            gb[sel] = colors[idx]
    return np.concatenate([r[..., None], gb], axis=-1).astype(np.uint8)


def crop_person(image: np.ndarray, bbox_xywh: Sequence[float],
                out_hw: Tuple[int, int] = (256, 192),
                padding: float = 1.25
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """mmpose top-down crop: bbox -> center/scale (aspect-corrected,

    x1.25 padding, scale unit 200px) -> affine crop. Returns
    (crop, center, scale)."""
    x, y, bw, bh = bbox_xywh
    center = np.array([x + bw * 0.5, y + bh * 0.5], np.float32)
    aspect = out_hw[1] / out_hw[0]  # w / h
    if bw > aspect * bh:
        bh = bw / aspect
    else:
        bw = bh * aspect
    scale = np.array([bw / 200.0 * padding, bh / 200.0 * padding],
                     np.float32)
    src_w = scale[0] * 200.0
    src_h = scale[1] * 200.0
    x0 = center[0] - src_w * 0.5
    y0 = center[1] - src_h * 0.5
    box = (x0, y0, x0 + src_w, y0 + src_h)
    crop = Image.fromarray(image).resize(
        (out_hw[1], out_hw[0]), Image.BICUBIC, box=box)
    return np.asarray(crop), center, scale


def keypoints_to_crop(keypoints: np.ndarray, center: np.ndarray,
                      scale: np.ndarray,
                      out_hw: Tuple[int, int] = (256, 192)) -> np.ndarray:
    """Image-coord keypoints (17, 3) -> crop coords."""
    out = keypoints.astype(np.float32).copy()
    src_w, src_h = scale * 200.0
    out[:, 0] = (out[:, 0] - (center[0] - src_w / 2)) * out_hw[1] / src_w
    out[:, 1] = (out[:, 1] - (center[1] - src_h / 2)) * out_hw[0] / src_h
    inside = ((out[:, 0] >= 0) & (out[:, 0] < out_hw[1])
              & (out[:, 1] >= 0) & (out[:, 1] < out_hw[0]))
    out[:, 2] = out[:, 2] * inside
    return out


def make_pose_eval_crops(image_dir: str, det_json: str, coco_images_json: str,
                         out_dir: str, out_hw: Tuple[int, int] = (256, 192),
                         det_bbox_thr: float = 0.0,
                         with_flip: bool = True) -> str:
    """Build the offline pose test set: person crops + _flip crops + meta.

    Mirrors the reference's pseudo-test data generation
    (``coco_256x192_test_offline.py:103-109``: offline detection boxes
    ``COCO_val2017_detections_AP_H_56_person.json``, flip crops in a
    sibling ``*_flip`` directory, ``imagename_with_boxid``). Returns the
    meta.json path consumed by :mod:`painter_tpu_torch.evals.run_pose`.
    """
    with open(coco_images_json) as f:
        images = {im["id"]: im["file_name"]
                  for im in json.load(f)["images"]}
    with open(det_json) as f:
        dets = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    metas = []
    box_counter: Dict[int, int] = {}
    for det in dets:
        if det.get("category_id", 1) != 1:
            continue
        if det.get("score", 1.0) < det_bbox_thr:
            continue
        img_id = det["image_id"]
        if img_id not in images:
            continue
        path = os.path.join(image_dir, images[img_id])
        if not os.path.exists(path):
            continue
        image = np.asarray(Image.open(path).convert("RGB"))
        box_idx = box_counter.get(img_id, 0)
        box_counter[img_id] = box_idx + 1
        crop, center, scale = crop_person(image, det["bbox"], out_hw)
        key = f"{os.path.splitext(images[img_id])[0]}_box{box_idx}"
        Image.fromarray(crop).save(os.path.join(out_dir, key + ".png"))
        if with_flip:
            Image.fromarray(crop[:, ::-1]).save(
                os.path.join(out_dir, key + "_flip.png"))
        metas.append({"key": key, "image_id": img_id,
                      "center": [float(center[0]), float(center[1])],
                      "scale": [float(scale[0]), float(scale[1])],
                      "bbox_score": float(det.get("score", 1.0))})
    meta_path = os.path.join(out_dir, "meta.json")
    with open(meta_path, "w") as f:
        json.dump(metas, f)
    return meta_path


# ---------------------------------------------------------------------------
# raw-dataset extraction utilities
# ---------------------------------------------------------------------------

def extract_nyu_depth_mat(h5_path: str, split_mat: str, out_dir: str,
                          max_images: int = -1) -> int:
    """NYUv2 labeled .mat -> per-scene rgb_XXXXX.jpg + sync_depth_XXXXX.png.

    Mirrors ``data/depth/extract_official_train_test_set_from_mat.py``:
    train/test split from trainNdxs/testNdxs (1-based), rawDepths x1000
    -> uint16 mm PNG, RGB with the 7px black boundary zeroed. Returns
    the number of images written. Needs ``h5py`` (only here)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("extract-nyu-mat reads the NYUv2 .mat (HDF5) "
                          "with h5py, which is not installed") from e
    from scipy.io import loadmat
    split = loadmat(split_mat)
    test_idx = {int(x) for x in split["testNdxs"].ravel()}
    train_idx = {int(x) for x in split["trainNdxs"].ravel()}
    with h5py.File(h5_path, "r") as h5:
        depths = h5["rawDepths"]
        images = h5["images"]
        scenes = ["".join(chr(c[0]) for c in h5[ref])
                  for ref in h5["sceneTypes"][0]]
        n = len(images) if max_images <= 0 else min(max_images, len(images))
        for i in range(n):
            part = "train" if (i + 1) in train_idx else "test"
            assert part == "train" or (i + 1) in test_idx, i
            folder = os.path.join(out_dir, part, scenes[i])
            os.makedirs(folder, exist_ok=True)
            depth_mm = (np.asarray(depths[i]).T * 1000.0).astype(np.uint16)
            img = np.asarray(images[i]).T  # (3, W, H) -> (H, W, 3)
            if img.ndim == 3 and img.shape[-1] != 3:
                img = img.transpose(1, 2, 0)
            bordered = np.zeros((480, 640, 3), np.uint8)
            bordered[7:474, 7:632] = img[7:474, 7:632]
            Image.fromarray(depth_mm).save(
                os.path.join(folder, f"sync_depth_{i:05d}.png"))
            Image.fromarray(bordered).save(
                os.path.join(folder, f"rgb_{i:05d}.jpg"))
    return n


def gen_sidd_patches(src_dir: str, out_dir: str, patch_size: int = 256,
                     num_patches: int = 300, seed: int = 0) -> int:
    """SIDD_Medium_Srgb full-res pairs -> random training patches.

    Mirrors ``data/sidd/generate_patches_SIDD.py``: per *GT/*NOISY pair
    under ``src_dir/*/``, cut ``num_patches`` aligned random crops into
    out_dir/{input,groundtruth}/{i}_{j}.png. Returns the patch count."""
    noisy = sorted(glob.glob(os.path.join(src_dir, "*", "*NOISY*.PNG"))
                   + glob.glob(os.path.join(src_dir, "*", "*NOISY*.png")))
    clean = sorted(glob.glob(os.path.join(src_dir, "*", "*GT*.PNG"))
                   + glob.glob(os.path.join(src_dir, "*", "*GT*.png")))
    assert len(noisy) == len(clean), (len(noisy), len(clean))
    in_dir = os.path.join(out_dir, "input")
    gt_dir = os.path.join(out_dir, "groundtruth")
    os.makedirs(in_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    count = 0
    for i, (np_, cp) in enumerate(zip(noisy, clean)):
        rng = np.random.default_rng((seed, i))
        noisy_img = np.asarray(Image.open(np_).convert("RGB"))
        clean_img = np.asarray(Image.open(cp).convert("RGB"))
        h, w = noisy_img.shape[:2]
        for j in range(num_patches):
            rr = int(rng.integers(0, max(h - patch_size, 0) + 1))
            cc = int(rng.integers(0, max(w - patch_size, 0) + 1))
            Image.fromarray(
                noisy_img[rr:rr + patch_size, cc:cc + patch_size]).save(
                os.path.join(in_dir, f"{i + 1}_{j + 1}.png"))
            Image.fromarray(
                clean_img[rr:rr + patch_size, cc:cc + patch_size]).save(
                os.path.join(gt_dir, f"{i + 1}_{j + 1}.png"))
            count += 1
    return count


# ---------------------------------------------------------------------------
# pair-list JSONs + toy dataset
# ---------------------------------------------------------------------------

def gen_pair_json(image_dir: str, target_dir: str, pair_type: str,
                  out_json: str, root: str = "",
                  image_ext: str = "*.png",
                  target_suffix: Optional[str] = None) -> int:
    """Emit [{image_path, target_path, type}] matching files by basename

    (gen_json_*.py siblings)."""
    pairs = []
    for ip in sorted(glob.glob(os.path.join(image_dir, image_ext))):
        base = os.path.basename(ip)
        tp = os.path.join(target_dir, base if target_suffix is None
                          else base.replace(".png", target_suffix))
        if not os.path.exists(tp):
            tp_png = os.path.splitext(tp)[0] + ".png"
            if os.path.exists(tp_png):
                tp = tp_png
            else:
                continue
        pairs.append({
            "image_path": os.path.relpath(ip, root) if root else ip,
            "target_path": os.path.relpath(tp, root) if root else tp,
            "type": pair_type,
        })
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(pairs, f)
    return len(pairs)


def make_toy_dataset(json_paths: Sequence[str], out_dir: str, root: str,
                     samples_per_task: int = 10) -> List[str]:
    """get_toy_dataset.py: copy first N samples per JSON."""
    os.makedirs(out_dir, exist_ok=True)
    out_jsons = []
    for jp in json_paths:
        with open(jp) as f:
            pairs = json.load(f)[:samples_per_task]
        for pair in pairs:
            for key in ("image_path", "target_path"):
                src = os.path.join(root, pair[key])
                dst = os.path.join(out_dir, pair[key])
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                if not os.path.exists(dst):
                    shutil.copy(src, dst)
        out_json = os.path.join(out_dir, os.path.basename(jp))
        with open(out_json, "w") as f:
            json.dump(pairs, f)
        out_jsons.append(out_json)
    return out_jsons


def main(argv=None):
    p = argparse.ArgumentParser("painter_tpu_torch dataset prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("paint-semantic")
    s.add_argument("--label_dir", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--task", default="ade20k",
                   choices=["ade20k", "coco_semseg"])

    s = sub.add_parser("gen-json")
    s.add_argument("--image_dir", required=True)
    s.add_argument("--target_dir", required=True)
    s.add_argument("--type", required=True)
    s.add_argument("--out_json", required=True)
    s.add_argument("--root", default="")
    s.add_argument("--image_ext", default="*.png")

    s = sub.add_parser("toy-dataset")
    s.add_argument("--json_paths", nargs="+", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--root", required=True)
    s.add_argument("--n", type=int, default=10)

    s = sub.add_parser("gen-instance-trainset",
                       help="30-aug-copy painted CA-instance training set "
                            "from COCO panoptic annotations (DATA.md:174)")
    s.add_argument("--panoptic_json", required=True)
    s.add_argument("--panoptic_root", required=True)
    s.add_argument("--image_root", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--num_aug", type=int, default=30)
    s.add_argument("--out_size", type=int, default=1024)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--max_images", type=int, default=-1)
    s.add_argument("--val", action="store_true")
    s.add_argument("--device", default=None,
                   help="device of the resizes (default: cuda)")

    s = sub.add_parser("gen-pose-trainset",
                       help="20-copy painted pose training set from COCO "
                            "keypoint annotations (DATA.md:210)")
    s.add_argument("--keypoints_json", required=True)
    s.add_argument("--image_root", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--num_aug", type=int, default=20)
    s.add_argument("--flip_prob", type=float, default=0.5)
    s.add_argument("--rot_factor", type=float, default=40.0)
    s.add_argument("--scale_factor", type=float, default=0.5)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--max_anns", type=int, default=-1)
    s.add_argument("--val", action="store_true")
    s.add_argument("--device", default=None,
                   help="device of the warps (default: cuda)")

    s = sub.add_parser("semantic-from-panoptic",
                       help="COCO panoptic annos -> 133-class semantic "
                            "PNGs (prepare_coco_semantic_annos role)")
    s.add_argument("--panoptic_json", required=True)
    s.add_argument("--panoptic_root", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--max_images", type=int, default=-1)

    s = sub.add_parser("pose-eval-crops",
                       help="offline pose test set: person (+flip) crops "
                            "from detection boxes + meta.json "
                            "(coco_256x192_test_offline.py:103-109 role)")
    s.add_argument("--image_dir", required=True)
    s.add_argument("--det_json", required=True,
                   help="COCO_val2017_detections_AP_H_56_person.json")
    s.add_argument("--coco_images_json", required=True,
                   help="person_keypoints_val2017.json (for file names)")
    s.add_argument("--out_dir", required=True)
    s.add_argument("--det_bbox_thr", type=float, default=0.0)
    s.add_argument("--no_flip", action="store_true")

    s = sub.add_parser("extract-nyu-mat",
                       help="NYUv2 labeled .mat -> rgb/sync_depth files")
    s.add_argument("--h5_path", required=True)
    s.add_argument("--split_mat", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--max_images", type=int, default=-1)

    s = sub.add_parser("gen-sidd-patches",
                       help="SIDD_Medium_Srgb -> 256^2 training patches")
    s.add_argument("--src_dir", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--patch_size", type=int, default=256)
    s.add_argument("--num_patches", type=int, default=300)
    s.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    if args.cmd == "paint-semantic":
        n = len(paint_semantic_dir(args.label_dir, args.out_dir, args.task))
        print(f"painted {n} label maps -> {args.out_dir}")
    elif args.cmd == "gen-json":
        n = gen_pair_json(args.image_dir, args.target_dir, args.type,
                          args.out_json, args.root, args.image_ext)
        print(f"wrote {n} pairs -> {args.out_json}")
    elif args.cmd == "toy-dataset":
        outs = make_toy_dataset(args.json_paths, args.out_dir, args.root,
                                args.n)
        print(f"toy dataset at {args.out_dir}: {outs}")
    elif args.cmd == "gen-instance-trainset":
        from painter_tpu_torch.data.trainset_gen import gen_instance_trainset
        jp = gen_instance_trainset(
            args.panoptic_json, args.panoptic_root, args.image_root,
            args.out_dir, num_aug=args.num_aug, out_size=args.out_size,
            seed=args.seed, max_images=args.max_images, val=args.val,
            device=args.device)
        print(f"instance trainset json: {jp}")
    elif args.cmd == "gen-pose-trainset":
        from painter_tpu_torch.data.trainset_gen import gen_pose_trainset
        jp = gen_pose_trainset(
            args.keypoints_json, args.image_root, args.out_dir,
            num_aug=args.num_aug, flip_prob=args.flip_prob,
            rot_factor=args.rot_factor, scale_factor=args.scale_factor,
            seed=args.seed, max_anns=args.max_anns, val=args.val,
            device=args.device)
        print(f"pose trainset json: {jp}")
    elif args.cmd == "semantic-from-panoptic":
        outs = semantic_from_panoptic_dir(args.panoptic_json,
                                          args.panoptic_root,
                                          args.out_dir, args.max_images)
        print(f"wrote {len(outs)} semantic maps -> {args.out_dir}")
    elif args.cmd == "pose-eval-crops":
        meta = make_pose_eval_crops(args.image_dir, args.det_json,
                                    args.coco_images_json, args.out_dir,
                                    det_bbox_thr=args.det_bbox_thr,
                                    with_flip=not args.no_flip)
        print(f"pose eval meta: {meta}")
    elif args.cmd == "extract-nyu-mat":
        n = extract_nyu_depth_mat(args.h5_path, args.split_mat,
                                  args.out_dir, args.max_images)
        print(f"extracted {n} images -> {args.out_dir}")
    elif args.cmd == "gen-sidd-patches":
        n = gen_sidd_patches(args.src_dir, args.out_dir, args.patch_size,
                             args.num_patches, args.seed)
        print(f"wrote {n} patches -> {args.out_dir}")


if __name__ == "__main__":
    main()
