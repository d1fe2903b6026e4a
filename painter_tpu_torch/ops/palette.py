"""Task color codecs: deterministic palettes and the nearest-color decode.

The reference's task-specific "ops" are color codecs: deterministic
palettes encode discrete labels as RGB (offline), and decoding is a
per-pixel nearest-color argmin. Palette definitions:

- ADE20K 150 classes: 19^3 lattice stepping down from white
  (``data/ade20k/gen_color_ade20k_sem.py:85-108``);
- COCO semantic-from-panoptic 133 classes: 7-per-channel lattice
  (``data/coco_semseg/gen_color_coco_panoptic_segm.py:31-54``);
- COCO class-agnostic instances: R = 4x4 global cell (16 levels),
  G/B = 20x20 local grid -> 6400 position-coded colors
  (``eval/coco_panoptic/COCOCAInstSegEvaluatorCustom.py:42-67``);
- COCO pose keypoint classes: 17 colors on a 5x5 G/B lattice, R carries
  heatmap magnitude (``data/mmpose_custom/.../custom_transform.py:10-33``).

The palettes are numpy arrays. The decode
(``ADE20kSemSegEvaluatorCustom.post_process_segm_output`` :114-141: L1 /
L2 / mean distance argmin over the palette) runs on torch tensors in fp32
on whatever device they are on. On integer-valued inputs (decoded PNGs)
every distance is an exact integer (or half-integer for ``mean``) in fp32,
and ``torch.argmin`` takes the first minimum, so the decode is the same on
every device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def ade20k_palette() -> np.ndarray:
    """(150, 3) uint8; gen_color_ade20k_sem.py:85-108."""
    num = 150
    nsep = int(num ** (1 / 3)) + 1  # 6
    sep = 256 // nsep
    colors = []
    for loc in range(num):
        r = 255 - (loc // nsep ** 2) * sep
        g = 255 - ((loc % nsep ** 2) // nsep) * sep
        b = 255 - (loc % nsep) * sep
        colors.append((r, g, b))
    arr = np.asarray(colors, np.uint8)
    assert len({tuple(c) for c in colors}) == num
    return arr


@functools.lru_cache(maxsize=None)
def coco_semseg_palette(num_colors: int = 133,
                        channelsep: int = 7) -> np.ndarray:
    """(133, 3) uint8; gen_color_coco_panoptic_segm.py:31-54."""
    sep = 256 // channelsep
    colors = []
    for loc in range(num_colors):
        r = 255 - (loc // channelsep ** 2) * sep
        g = 255 - ((loc % channelsep ** 2) // channelsep) * sep
        b = 255 - (loc % channelsep) * sep
        colors.append((r, g, b))
    arr = np.asarray(colors, np.uint8)
    assert len({tuple(c) for c in colors}) == num_colors
    return arr


@functools.lru_cache(maxsize=None)
def coco_instance_palette(num_location_r: int = 16,
                          num_location_gb: int = 20) -> np.ndarray:
    """(6400, 3) uint8 position-coded instance colors;

    COCOCAInstSegEvaluatorCustom.py:42-67. Row order: global cell
    (y-major 4x4), then local (y-major 20x20)."""
    sep_r = 255 // num_location_r
    sep_gb = 256 // num_location_gb + 1
    colors = []
    for gy in range(4):
        for gx in range(4):
            r = 255 - (gy * 4 + gx) * sep_r
            for ly in range(num_location_gb):
                for lx in range(num_location_gb):
                    colors.append((r, 255 - ly * sep_gb, 255 - lx * sep_gb))
    arr = np.asarray(colors, np.uint8)
    assert len({tuple(c) for c in colors}) == len(colors)
    return arr


@functools.lru_cache(maxsize=None)
def pose_gb_palette(num_locations: int = 17) -> np.ndarray:
    """(17, 2) uint8 (G, B) keypoint-class colors;

    custom_transform.py:10-33."""
    nsep = int(num_locations ** 0.5) + 1  # 5
    sep = 256 // nsep
    colors = []
    for loc in range(num_locations):
        g = 255 - (loc // nsep) * sep
        b = 255 - (loc % nsep) * sep
        colors.append((g, b))
    return np.asarray(colors, np.uint8)


def color_distance_map(img: torch.Tensor, palette: torch.Tensor,
                       dist_type: str = "abs") -> torch.Tensor:
    """(..., 3) RGB -> (..., K) fp32 distances to each palette color
    (panoptic fusion needs the full map,
    COCOPanoSemSegEvaluatorCustom.py:26-141).

    dist_type: 'abs' | 'square' | 'mean'
    (ADE20kSemSegEvaluatorCustom.py:114-141)."""
    diff = img.float()[..., None, :] - palette.to(img.device).float()
    if dist_type == "abs":
        dist = diff.abs()
    elif dist_type == "square":
        dist = diff.square()
    elif dist_type == "mean":
        dist = (diff.abs() + diff.square()) / 2.0
    else:
        raise ValueError(dist_type)
    return dist.sum(-1)


def nearest_color_decode(img: torch.Tensor, palette: torch.Tensor,
                         dist_type: str = "abs") -> torch.Tensor:
    """(..., 3) RGB -> (...) int32 index of the nearest palette color
    (the first one on ties)."""
    return color_distance_map(img, palette, dist_type).argmin(-1).to(
        torch.int32)


def paint_semantic(labels: np.ndarray, palette: np.ndarray,
                   ignore_label: int = 255) -> np.ndarray:
    """Encode: label map -> painted RGB; ignore -> black

    (gen_color_ade20k_sem.py:66-83 colorEncode semantics)."""
    out = np.zeros(labels.shape + (3,), np.uint8)
    valid = labels != ignore_label
    idx = np.clip(labels, 0, len(palette) - 1)
    out[valid] = palette[idx[valid]]
    return out
