"""Offline dataset preparation helpers the eval stack needs: the COCO
panoptic id decode and the instance and pose painting codecs.

Behavioral contracts, as in the JAX package's ``data/prep.py``:

- panoptic ids: COCO panoptic PNG ids (R + 256 G + 256^2 B)
  (``data/prepare_coco_semantic_annos_from_panoptic_annos.py``);
- instance painting: each instance mask painted with the color of its
  mass-center cell — 4x4 global (R) x 20x20 local (G,B) position code
  (``data/mmdet_custom/data/pipelines/transforms.py:70-177``);
- pose painting: 256x192 person crops; R = max gaussian heatmap x255,
  (G,B) = keypoint-class color, collisions resolved by the max-magnitude
  keypoint (``data/mmpose_custom/data/pipelines/custom_transform.py:39-127``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from painter_tpu_torch.ops.palette import (coco_instance_palette,
                                           pose_gb_palette)


def panoptic_png_to_ids(png: np.ndarray) -> np.ndarray:
    """COCO panoptic PNG -> segment-id map (R + 256 G + 256^2 B)."""
    png = png.astype(np.uint32)
    return png[..., 0] + 256 * png[..., 1] + 256 ** 2 * png[..., 2]


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
