"""Painted training-set generation drivers (L3).

The reference materializes painted training sets by running *fake mm*
training jobs* whose pipelines end in a save stage:

- **instances**: 30 augmented copies + org + orgflip of every COCO
  panoptic image, painted with the mass-center position code
  (``data/mmdet_custom/data/pipelines/transforms.py:70-177``, driven by
  ``configs/coco_panoptic_ca_inst_gen_{aug,org,orgflip}.py`` and
  ``docs/DATA.md:174-187``). Aug pipeline: RandomFlip(0.5) -> Resize to
  1024*r, r~U(0.7,2.0), keep_ratio=False -> RandomCrop 1024^2 absolute
  -> Pad 1024^2; org/orgflip: exact 1024^2 warp, flip 0/1.
- **pose**: 20 copies of every person crop, painted as R=heatmap /
  GB=class color (``data/mmpose_custom/data/pipelines/
  custom_transform.py:39-127``, ``top_down_transform.py:19-150``,
  ``configs/coco_256x192_gendata.py``, ``docs/DATA.md:210-222``).
  Targets are MSRA truncated gaussians with sigma=[1.5, 3]: the class
  (GB) areas come from the sigma-1.5 maps, the R channel from the
  sigma-3 maps. The shipped gendata config has the flip and
  scale/rotation stages commented out; the standard mmpose values
  (flip 0.5, rot_factor 40 with prob 0.6, scale_factor 0.5) are the
  defaults here since identical copies carry no augmentation signal —
  pass --flip_prob 0 --rot_factor 0 --scale_factor 0 for the literal
  shipped behavior.

Here both are plain drivers over the annotation JSONs — no fake
training loop — emitting the same painted PNG pairs plus the pair-list
JSON consumed by :class:`painter_tpu_torch.data.pairdataset.PairDataset`
(the ``gen_json_coco_panoptic_inst.py`` / ``gen_json_coco_pose.py``
role). Randomness is an explicit ``np.random.Generator`` keyed by
(seed, image/ann id, copy index) so regeneration is reproducible.

The PyTorch port's copy of ``painter_tpu/data/trainset_gen.py``: the
same files, draws, JSON and painted targets, without OpenCV. The image
resize (bilinear) and the pose warp (bilinear, zero border) run in torch
on ``device`` (default ``cuda``; ``"cpu"`` on the host), in float64,
rounded half up to uint8; they come within one uint8 step of
``cv2.resize`` / ``cv2.warpAffine`` (``INTER_LINEAR``), whose sums round
elsewhere (``cv2.resize`` in fixed point). The masks' nearest resize
takes ``cv2.INTER_NEAREST``'s source indices, so the painted targets are
the same bytes.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from painter_tpu_torch.data.prep import (PAIR_TYPES, paint_instances,
                                         panoptic_png_to_ids)
from painter_tpu_torch.device import resolve_device
from painter_tpu_torch.ops.palette import pose_gb_palette

# ---------------------------------------------------------------------------
# COCO class-agnostic instance training set
# ---------------------------------------------------------------------------


def _load_thing_masks(pan_png: np.ndarray, segments_info: Sequence[Dict],
                      isthing: Dict[int, bool]) -> np.ndarray:
    """Panoptic PNG + segments -> (N, H, W) bool masks of non-crowd
    things (LoadPanopticAnnotations semantics)."""
    ids = panoptic_png_to_ids(pan_png)
    masks = []
    for seg in segments_info:
        if not isthing.get(seg["category_id"], False):
            continue
        if seg.get("iscrowd", 0):
            continue
        m = ids == seg["id"]
        if m.any():
            masks.append(m)
    if not masks:
        return np.zeros((0,) + ids.shape, bool)
    return np.stack(masks)


def _to_u8(x: torch.Tensor) -> np.ndarray:
    """(1, 3, H, W) float -> (H, W, 3) uint8, rounded half up."""
    return torch.floor(x[0] + 0.5).clamp_(0, 255).to(torch.uint8).permute(
        1, 2, 0).cpu().numpy()


def _image_tensor(img: np.ndarray, device: torch.device) -> torch.Tensor:
    """(H, W, 3) uint8 -> (1, 3, H, W) float64 on ``device``."""
    return torch.from_numpy(np.array(img)).to(device).permute(
        2, 0, 1)[None].to(torch.float64)


def resize_bilinear(img: np.ndarray, size_hw: Tuple[int, int],
                    device: torch.device) -> np.ndarray:
    """(H, W, 3) uint8 -> ``size_hw`` uint8: ``cv2.INTER_LINEAR``'s
    half-pixel bilinear (``align_corners=False``, no antialias)."""
    return _to_u8(F.interpolate(_image_tensor(img, device), size=size_hw,
                                mode="bilinear", align_corners=False))


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """``cv2.INTER_NEAREST``'s source index per output position:
    ``floor(dst * (1 / (out / in)))`` in float64, clipped to ``in - 1``.
    The reciprocal of ``out / in`` can be one ulp under ``in / out``, so
    where ``dst * in / out`` is an integer this index is one less than
    ``ops.resample.nearest_indices``' (640 -> 52 at dst 39: 479)."""
    inv_scale = 1.0 / (out_size / in_size)
    dst = np.arange(out_size, dtype=np.float64)
    return np.minimum(np.floor(dst * inv_scale),
                      in_size - 1).astype(np.int64)


def resize_nearest(masks: np.ndarray, size_hw: Tuple[int, int],
                   device: torch.device) -> np.ndarray:
    """(N, H, W) bool -> (N, h, w) with OpenCV's nearest indices."""
    _, h_in, w_in = masks.shape
    m = torch.from_numpy(np.array(masks)).to(device)
    ih = torch.from_numpy(nearest_indices(h_in, size_hw[0])).to(device)
    iw = torch.from_numpy(nearest_indices(w_in, size_hw[1])).to(device)
    return m[:, ih][:, :, iw].cpu().numpy()


def _resize_pair(img: np.ndarray, masks: np.ndarray,
                 size_hw: Tuple[int, int], device: torch.device):
    """mmdet Resize keep_ratio=False: bilinear image, nearest masks."""
    h, w = size_hw
    img_r = resize_bilinear(img, size_hw, device)
    if len(masks):
        masks_r = resize_nearest(masks, size_hw, device)
    else:
        masks_r = np.zeros((0, h, w), bool)
    return img_r, masks_r


def _augment_instance(img: np.ndarray, masks: np.ndarray, out_size: int,
                      rng: Optional[np.random.Generator],
                      flip: Optional[bool], device: torch.device):
    """One pipeline pass (transforms order of the gen configs):
    RandomFlip -> Resize(ratio U(0.7,2.0) aug / 1.0 org) ->
    RandomCrop(absolute, aug only) -> Pad(out_size)."""
    if flip is None:
        flip = bool(rng.random() < 0.5)
    if flip:
        img = img[:, ::-1]
        masks = masks[:, :, ::-1] if len(masks) else masks
    if rng is None:
        ratio = 1.0
    else:
        ratio = float(rng.uniform(0.7, 2.0))
    size = max(int(out_size * ratio), 1)
    img, masks = _resize_pair(img, masks, (size, size), device)
    if rng is not None:  # RandomCrop absolute out_size^2
        h, w = img.shape[:2]
        off_h = int(rng.integers(0, max(h - out_size, 0) + 1))
        off_w = int(rng.integers(0, max(w - out_size, 0) + 1))
        img = img[off_h:off_h + out_size, off_w:off_w + out_size]
        masks = masks[:, off_h:off_h + out_size, off_w:off_w + out_size] \
            if len(masks) else masks
    # Pad to out_size^2 with zeros
    h, w = img.shape[:2]
    if h < out_size or w < out_size:
        pad_img = np.zeros((out_size, out_size, 3), img.dtype)
        pad_img[:h, :w] = img
        img = pad_img
        if len(masks):
            pad_m = np.zeros((len(masks), out_size, out_size), bool)
            pad_m[:, :h, :w] = masks
            masks = pad_m
    return img, masks


def gen_instance_trainset(panoptic_json: str, panoptic_root: str,
                          image_root: str, out_dir: str,
                          num_aug: int = 30, out_size: int = 1024,
                          include_org: bool = True, seed: int = 0,
                          max_images: int = -1, val: bool = False,
                          device=None) -> str:
    """Emit the painted CA-instance training set + pair-list JSON.

    Copies: train_aug{0..num_aug-1} (full aug), train_org (no aug),
    train_orgflip (flip only) — or val_org when ``val``. Images whose
    painting comes out all-black are skipped, as in
    ``SaveDataPairCustom.__call__`` (transforms.py:131-134). The resizes
    run on ``device`` (default ``cuda``; raises without a card unless
    given ``"cpu"``). Returns the JSON path.
    """
    device = resolve_device(device)
    with open(panoptic_json) as f:
        pan = json.load(f)
    isthing = {c["id"]: bool(c.get("isthing", 0)) for c in pan["categories"]}
    file_by_id = {im["id"]: im["file_name"] for im in pan["images"]}
    anns = pan["annotations"]
    if max_images > 0:
        anns = anns[:max_images]

    if val:
        copies = [("val_org", None, False)]
    else:
        copies = [(f"train_aug{i}", i, None) for i in range(num_aug)]
        if include_org:
            copies += [("train_org", None, False),
                       ("train_orgflip", None, True)]

    pairs = []
    for ann in anns:
        img_path = os.path.join(image_root, file_by_id[ann["image_id"]])
        pan_path = os.path.join(panoptic_root, ann["file_name"])
        image = np.asarray(Image.open(img_path).convert("RGB"))
        pan_png = np.asarray(Image.open(pan_path).convert("RGB"))
        masks = _load_thing_masks(pan_png, ann["segments_info"], isthing)
        stem = os.path.splitext(file_by_id[ann["image_id"]])[0]
        for dir_name, aug_idx, flip in copies:
            rng = (np.random.default_rng((seed, ann["image_id"], aug_idx))
                   if aug_idx is not None else None)
            img_a, masks_a = _augment_instance(
                image, masks, out_size, rng,
                flip if aug_idx is None else None, device)
            live = masks_a[masks_a.any(axis=(1, 2))] if len(masks_a) \
                else masks_a
            painted = paint_instances(live, img_a.shape[:2])
            if not painted.any():
                continue  # pure black label -> skipped (transforms.py:131)
            d = os.path.join(out_dir, dir_name)
            os.makedirs(d, exist_ok=True)
            ip = os.path.join(d, f"{stem}_image_{dir_name}.png")
            lp = os.path.join(d, f"{stem}_label_{dir_name}.png")
            Image.fromarray(img_a).save(ip)
            Image.fromarray(painted).save(lp)
            pairs.append({"image_path": os.path.relpath(ip, out_dir),
                          "target_path": os.path.relpath(lp, out_dir),
                          "type": PAIR_TYPES["coco_inst"]})
    json_path = os.path.join(
        out_dir, "coco_val_image2panoptic_inst.json" if val
        else "coco_train_image2panoptic_inst.json")
    with open(json_path, "w") as f:
        json.dump(pairs, f)
    return json_path


# ---------------------------------------------------------------------------
# COCO pose training set
# ---------------------------------------------------------------------------

COCO_POSE_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                        (13, 14), (15, 16))


def bbox_to_center_scale(bbox_xywh: Sequence[float],
                         out_hw: Tuple[int, int] = (256, 192),
                         padding: float = 1.25):
    """mmpose TopDownGetBboxCenterScale: aspect-corrected, x1.25,
    scale unit 200 px."""
    x, y, bw, bh = bbox_xywh
    center = np.array([x + bw * 0.5, y + bh * 0.5], np.float32)
    aspect = out_hw[1] / out_hw[0]
    if bw > aspect * bh:
        bh = bw / aspect
    else:
        bw = bh * aspect
    scale = np.array([bw / 200.0, bh / 200.0], np.float32) * padding
    return center, scale


def _get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return b + np.array([-d[1], d[0]], np.float32)


def get_affine_transform(center: np.ndarray, scale: np.ndarray,
                         rot: float, out_wh: Tuple[int, int]) -> np.ndarray:
    """mmpose get_affine_transform: (center, scale, rot) -> 2x3 matrix
    mapping image coords to the (w, h) crop."""
    src_w = scale[0] * 200.0
    dst_w, dst_h = out_wh
    rot_rad = np.deg2rad(rot)
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    # rotate_point([0, -src_w/2], rot): (y*sin... -> [w/2*sin, -w/2*cos])
    src_dir = np.array([src_w * 0.5 * sn, -src_w * 0.5 * cs], np.float32)
    dst_dir = np.array([0.0, -dst_w * 0.5], np.float32)
    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0], src[1] = center, center + src_dir
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst[2] = _get_3rd_point(dst[0], dst[1])
    a = np.hstack([src, np.ones((3, 1), np.float32)])
    return np.linalg.solve(a, dst).T.astype(np.float32)  # (2, 3)


def warp_affine(image: np.ndarray, mat: np.ndarray,
                out_wh: Tuple[int, int], device: torch.device) -> np.ndarray:
    """``cv2.warpAffine(image, mat, out_wh, flags=INTER_LINEAR)``: each
    output pixel samples ``image`` bilinearly at the inverse map of its
    centre (integer coordinates are pixel centres), zero outside."""
    m = mat.astype(np.float64)
    # cv2's inversion of the 2x3 matrix, in float64
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a12 = m[1, 1] * det, -m[0, 1] * det
    a21, a22 = -m[1, 0] * det, m[0, 0] * det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    w_out, h_out = out_wh
    h_in, w_in = image.shape[:2]
    ys = torch.arange(h_out, dtype=torch.float64, device=device)[:, None]
    xs = torch.arange(w_out, dtype=torch.float64, device=device)[None, :]
    sx = a11 * xs + a12 * ys + b1
    sy = a21 * xs + a22 * ys + b2
    # grid_sample's align_corners=False units: -1 and 1 are the outer
    # edges of the border pixels
    grid = torch.stack([(2 * sx + 1) / w_in - 1, (2 * sy + 1) / h_in - 1],
                       -1)[None]
    return _to_u8(F.grid_sample(_image_tensor(image, device), grid,
                                mode="bilinear", padding_mode="zeros",
                                align_corners=False))


def transform_points(pts: np.ndarray, mat: np.ndarray) -> np.ndarray:
    return pts @ mat[:, :2].T + mat[:, 2]


def msra_heatmaps(joints: np.ndarray, vis: np.ndarray,
                  hw: Tuple[int, int], sigma: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """mmpose MSRA gaussian targets (truncated at 3 sigma).

    joints: (K, 2) crop coords; vis: (K,) visibility. Returns
    ((K, H, W) heatmaps, (K,) target weights). Matches
    ``_msra_generate_target`` with unbiased_encoding=False: mu = int(x +
    0.5), window [mu-3s, mu+3s+1], joints whose window misses the crop
    get weight 0."""
    h, w = hw
    k = len(joints)
    tmp = sigma * 3
    size = int(2 * tmp + 1)
    x = np.arange(size, dtype=np.float32)
    x0 = y0 = size // 2
    g = np.exp(-((x[None, :] - x0) ** 2 + (x[:, None] - y0) ** 2)
               / (2 * sigma ** 2))
    maps = np.zeros((k, h, w), np.float32)
    weights = (vis > 0).astype(np.float32)
    for j in range(k):
        if weights[j] < 0.5:
            continue
        mu_x = int(joints[j, 0] + 0.5)
        mu_y = int(joints[j, 1] + 0.5)
        ul = (int(mu_x - tmp), int(mu_y - tmp))
        br = (int(mu_x + tmp + 1), int(mu_y + tmp + 1))
        if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0:
            weights[j] = 0.0
            continue
        gx = (max(0, -ul[0]), min(br[0], w) - ul[0])
        gy = (max(0, -ul[1]), min(br[1], h) - ul[1])
        ix = (max(0, ul[0]), min(br[0], w))
        iy = (max(0, ul[1]), min(br[1], h))
        maps[j, iy[0]:iy[1], ix[0]:ix[1]] = g[gy[0]:gy[1], gx[0]:gx[1]]
    return maps, weights


def paint_pose_target(kernel_maps: np.ndarray, class_maps: np.ndarray
                      ) -> np.ndarray:
    """Two-sigma painting (custom_transform.py:64-111): R = max kernel
    heatmap x255; GB = class color of the sigma-1.5 support; collision
    pixels take the kernel-argmax class's color."""
    k, h, w = kernel_maps.shape
    colors = pose_gb_palette().astype(np.float32)
    r = kernel_maps.max(0)[..., None] * 255.0
    argmax_k = kernel_maps.argmax(0)
    active = class_maps != 0
    collision = active.sum(0) > 1
    gb = np.zeros((h, w, 2), np.float32)
    for idx in range(k):
        gb[active[idx]] += colors[idx]
    if collision.any():
        for idx in range(k):
            sel = (argmax_k == idx) & collision
            gb[sel] = colors[idx]
    return np.concatenate([r, gb], axis=-1).astype(np.uint8)


def gen_pose_trainset(keypoints_json: str, image_root: str, out_dir: str,
                      num_aug: int = 20, out_hw: Tuple[int, int] = (256, 192),
                      sigmas: Tuple[float, float] = (1.5, 3.0),
                      flip_prob: float = 0.5, rot_factor: float = 40.0,
                      rot_prob: float = 0.6, scale_factor: float = 0.5,
                      seed: int = 0, max_anns: int = -1,
                      val: bool = False, device=None) -> str:
    """Emit the painted pose training set + pair-list JSON.

    Per GT person box (non-crowd, >=1 labeled keypoint: mmpose
    TopDownCocoDataset filters), ``num_aug`` augmented crops are painted
    into train_256x192_aug{i}/ — or one unaugmented crop into
    val_256x192/ when ``val``. Naming: {stem}_box{bid}_{image,label}.png
    (custom_transform.py:113-127). The warps run on ``device`` (default
    ``cuda``; raises without a card unless given ``"cpu"``). Returns the
    JSON path.
    """
    device = resolve_device(device)
    with open(keypoints_json) as f:
        coco = json.load(f)
    file_by_id = {im["id"]: im["file_name"] for im in coco["images"]}
    anns = [a for a in coco["annotations"]
            if not a.get("iscrowd", 0) and a.get("num_keypoints", 0) > 0
            and a.get("area", 1) > 0]
    if max_anns > 0:
        anns = anns[:max_anns]
    h_out, w_out = out_hw
    copies = [("val_256x192", None)] if val else \
        [(f"train_256x192_aug{i}", i) for i in range(num_aug)]

    pairs = []
    box_counter: Dict[int, int] = {}
    for ann in anns:
        img_file = file_by_id[ann["image_id"]]
        image = np.asarray(Image.open(
            os.path.join(image_root, img_file)).convert("RGB"))
        kpts = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
        box_idx = box_counter.get(ann["image_id"], 0)
        box_counter[ann["image_id"]] = box_idx + 1
        stem = os.path.splitext(os.path.basename(img_file))[0]
        for dir_name, aug_idx in copies:
            rng = np.random.default_rng((seed, ann["id"], aug_idx or 0))
            center, scale = bbox_to_center_scale(ann["bbox"], out_hw)
            joints = kpts[:, :2].copy()
            vis = (kpts[:, 2] > 0).astype(np.float32)
            img = image
            if aug_idx is not None and rng.random() < flip_prob:
                # TopDownRandomFlip: flip image, joints, center
                img = img[:, ::-1]
                width = img.shape[1]
                joints = joints.copy()
                joints[:, 0] = width - 1 - joints[:, 0]
                for a_, b_ in COCO_POSE_FLIP_PAIRS:
                    joints[[a_, b_]] = joints[[b_, a_]]
                    vis[[a_, b_]] = vis[[b_, a_]]
                center = center.copy()
                center[0] = width - 1 - center[0]
            rot = 0.0
            if aug_idx is not None:
                # TopDownGetRandomScaleRotation
                if scale_factor > 0:
                    sf = float(np.clip(rng.standard_normal() * scale_factor
                                       + 1, 1 - scale_factor,
                                       1 + scale_factor))
                    scale = scale * sf
                if rot_factor > 0 and rng.random() <= rot_prob:
                    rot = float(np.clip(rng.standard_normal() * rot_factor,
                                        -rot_factor * 2, rot_factor * 2))
            mat = get_affine_transform(center, scale, rot, (w_out, h_out))
            crop = warp_affine(img, mat, (w_out, h_out), device)
            cj = transform_points(joints, mat)
            class_maps, w1 = msra_heatmaps(cj, vis, out_hw, sigmas[0])
            kernel_maps, w2 = msra_heatmaps(cj, vis, out_hw, sigmas[1])
            # check_input: weight-zero joints contribute nothing
            class_maps *= w1[:, None, None]
            kernel_maps *= w2[:, None, None]
            painted = paint_pose_target(kernel_maps, class_maps)
            d = os.path.join(out_dir, dir_name)
            os.makedirs(d, exist_ok=True)
            ip = os.path.join(d, f"{stem}_box{box_idx}_image.png")
            lp = os.path.join(d, f"{stem}_box{box_idx}_label.png")
            Image.fromarray(crop).save(ip)
            Image.fromarray(painted).save(lp)
            pairs.append({"image_path": os.path.relpath(ip, out_dir),
                          "target_path": os.path.relpath(lp, out_dir),
                          "type": PAIR_TYPES["pose"]})
    json_path = os.path.join(
        out_dir, "coco_val_image2pose.json" if val
        else "coco_train_image2pose.json")
    with open(json_path, "w") as f:
        json.dump(pairs, f)
    return json_path
